"""The full-width detector train step (chip_smoke.py's
`phase_detector_train_step_profile`: GroupNorm ResNet-50 FPN 256 at 240 x
320, batch 8, the dettrain recipe) timed in two checkouts of the repository
on one CUDA card, in turns A, B, B, A, each turn a process of its own that
builds its checkout's kernels and writes its fixture detection set:

    python3 scripts/detector_step_ab.py A_ROOT B_ROOT

Prints each turn's `[detector_train_step_profile]` line after its label and
checkout. Where a checkout's profile still takes K8's NCHW copy time (before
K8 wrote dF in place), it is given 0, so its "rest" holds the copy.
"""

import inspect
import subprocess
import sys
from pathlib import Path


def one_turn(root: Path) -> None:
    """In this process: the profile of `root`'s chip_smoke.py."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()
    train_set, _ = chip_smoke.detection_sets(root / "build" / "chip_smoke_detection")
    profile = chip_smoke.phase_detector_train_step_profile
    copy_ms = (0.0,) if "k8_copy_ms" in inspect.signature(profile).parameters else ()
    profile(torch.device("cuda"), train_set, *copy_ms)


def main() -> int:
    if sys.argv[1] == "--turn":
        one_turn(Path(sys.argv[2]).resolve())
        return 0
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for label in ("A", "B", "B", "A"):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn",
                              str(roots[label])], cwd=roots[label], capture_output=True,
                             text=True, timeout=600)
        lines = [line for line in run.stdout.splitlines()
                 if line.startswith("[detector_train_step_profile]")]
        print(f"{label} {roots[label]} rc={run.returncode}", *lines, sep="\n", flush=True)
        if run.returncode != 0 or not lines:
            print(run.stdout[-3000:], run.stderr[-3000:], sep="\n", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
