"""RoIAlign's backward (K8) timed in two checkouts of the repository on one
CUDA card, in turns A, B, B, A, each turn a process of its own that builds
its checkout's kernels and writes its fixture detection set. In each turn,
on the inputs `chip_smoke.py` holds K8 on (the dettrain detector's pyramid
shape, B=8, N=320 with edge rois, and the train800 bf16 detector's, B=4,
N=320), by CUDA events (mean of 20 calls after warmup):

- `K8`: float32 dF at the native shape;
- `K8_bf16`: bf16 dF at 800 px, and `K8_800_f32`: float32 dF there;

then the checkout's `chip_smoke.phase_detector_train_step_profile` for the
native fp32 and the 800 px bf16 train steps (their
`[detector_train_step_profile]` lines: stage times, the backward's split,
busy share).

    python3 scripts/roi_align_backward_ab.py A_ROOT B_ROOT

Prints the card's name and power limit, then each turn's
`[roi_align_backward_ab]` and `[detector_train_step_profile]` lines, with
the registers nvcc gave the kernels, after its label and checkout.
"""

import inspect
import subprocess
import sys
from pathlib import Path

PREFIXES = ("[roi_align_backward_ab]", "[detector_train_step_profile]")


def one_turn(root: Path) -> None:
    """In this process: K8 of `root`'s port at both shapes, and its train
    step profiles."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    log = _build.build("roi_align")["roi_align"].log
    registers = [line.strip() for line in log.splitlines() if "registers" in line]

    train_set, _ = chip_smoke.detection_sets(root / "build" / "chip_smoke_detection")
    _, (dout, rois, levels, shapes, _) = chip_smoke.phase_roi_align_grad_vs_plain(
        chip_smoke.dettrain_detector(device), train_set)
    _, (dout800, rois800, levels800, shapes800) = chip_smoke.phase_roi_align_bf16_grad_vs_plain(
        device, train_set)
    cases = {"K8": ((dout, rois, levels, shapes), torch.float32),
             "K8_bf16": ((dout800, rois800, levels800, shapes800), torch.bfloat16),
             "K8_800_f32": ((dout800, rois800, levels800, shapes800), torch.float32)}
    for tag, ((grad, r, lv, sh), dtype) in cases.items():
        ms = chip_smoke.time_ms(
            lambda: rk.roi_align_batched_backward(grad, r, lv, sh, ROI_STRIDES, dtype=dtype),
            iters=20)
        print(f"[roi_align_backward_ab] kernel={tag} images={r.shape[0]} rois={r.shape[1]} "
              f"channels={grad.shape[2]} dtype={dtype} ms={ms}", flush=True)
    profile = chip_smoke.phase_detector_train_step_profile
    copy_ms = (0.0,) if "k8_copy_ms" in inspect.signature(profile).parameters else ()
    profile(device, train_set, *copy_ms)
    profile(device, train_set, *copy_ms, recipe=chip_smoke.train800_recipe("bfloat16"),
            batch=chip_smoke.TRAIN800_BATCH, label="train800_bfloat16")
    print(f"[roi_align_backward_ab] registers={registers}", flush=True)


def main() -> int:
    if sys.argv[1] == "--turn":
        one_turn(Path(sys.argv[2]).resolve())
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for label in ("A", "B", "B", "A"):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn",
                              str(roots[label])], cwd=roots[label], capture_output=True,
                             text=True, timeout=600)
        lines = [line for line in run.stdout.splitlines() if line.startswith(PREFIXES)]
        print(f"{label} {roots[label]} rc={run.returncode}", *lines, sep="\n", flush=True)
        if run.returncode != 0 or not lines:
            print(run.stdout[-3000:], run.stderr[-3000:], sep="\n", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
