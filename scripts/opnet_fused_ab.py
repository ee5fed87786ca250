"""The fused OPNet forward (K1) timed in two checkouts of the repository on
one CUDA card, in turns A, B, B, A, each turn a process of its own that
builds its checkout's kernels: in each turn float32 and bf16 operands at
B=512 (the bench's served boxes tiled to 512 videos of T=300 frames) and at
B=16 (the CLI's served batch, `configs/inference_config.json`), flagship
weights, as chip_smoke.py's `phase_times` runs K1 (CUDA events, mean of 20
calls after warmup).

    python3 scripts/opnet_fused_ab.py A_ROOT B_ROOT

Prints each turn's `[opnet_fused_ab]` lines (one per mode and batch), with
the registers nvcc gave the kernels, after its label and checkout.
"""

import subprocess
import sys
from pathlib import Path


CLI_BATCH = 16


def one_turn(root: Path) -> None:
    """In this process: K1 of `root`'s port in both modes at B=512 and 16."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    log = _build.build("opnet_fused")["opnet_fused"].log
    registers = [line.strip() for line in log.splitlines() if "registers" in line]
    weights = chip_smoke.flagship_weights(device)
    for batch in (chip_smoke.BATCH, CLI_BATCH):
        boxes = chip_smoke.served_boxes(batch, device)
        for dtype in (torch.float32, torch.bfloat16):
            with torch.inference_mode():
                ms = chip_smoke.time_ms(
                    lambda: opnet_fused_forward(boxes, *weights, compute_dtype=dtype), iters=20)
            print(f"[opnet_fused_ab] dtype={str(dtype).split('.')[-1]} batch={batch} "
                  f"frames={chip_smoke.FRAMES} ms={ms}", flush=True)
    print(f"[opnet_fused_ab] registers={registers}", flush=True)


def main() -> int:
    if sys.argv[1] == "--turn":
        one_turn(Path(sys.argv[2]).resolve())
        return 0
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for label in ("A", "B", "B", "A"):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn",
                              str(roots[label])], cwd=roots[label], capture_output=True,
                             text=True, timeout=600)
        lines = [line for line in run.stdout.splitlines() if line.startswith("[opnet_fused_ab]")]
        print(f"{label} {roots[label]} rc={run.returncode}", *lines, sep="\n", flush=True)
        if run.returncode != 0 or not lines:
            print(run.stdout[-3000:], run.stderr[-3000:], sep="\n", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
