"""The fused OPNet forward (K1, float32) timed in two checkouts of the
repository on one CUDA card, in turns A, B, B, A, each turn a process of its
own that builds its checkout's kernels: the bench's served boxes tiled to
B=512 videos of T=300 frames and the flagship weights, as chip_smoke.py's
`phase_times` runs K1 (CUDA events, mean of 20 calls after warmup).

    python3 scripts/opnet_fused_ab.py A_ROOT B_ROOT

Prints each turn's `[opnet_fused_ab]` line, with the registers nvcc gave
the kernel, after its label and checkout.
"""

import subprocess
import sys
from pathlib import Path


def one_turn(root: Path) -> None:
    """In this process: K1 of `root`'s port at B=512, T=300."""
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
    boxes = chip_smoke.served_boxes(chip_smoke.BATCH, device)
    with torch.inference_mode():
        ms = chip_smoke.time_ms(lambda: opnet_fused_forward(boxes, *weights), iters=20)
    print(f"[opnet_fused_ab] batch={chip_smoke.BATCH} frames={chip_smoke.FRAMES} ms={ms} "
          f"registers={registers}", flush=True)


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
