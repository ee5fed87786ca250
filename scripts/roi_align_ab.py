"""The RoIAlign forwards (K7, K7 bf16, K9 f32, K9 bf16) and the detector
chunks timed in two checkouts of the repository on one CUDA card, in turns
A, B, B, A, each turn a process of its own that builds its checkout's
kernels. In each turn, on the inputs `chip_smoke.py` times them on (the
native chunk's pyramid and proposals for K7, B=30, N=300; the 800 px bf16
chunk's for K9, in bf16 and as float32, B=8, N=300; the native-geometry
bf16 chunk's for K7 bf16, B=8, N=300), by CUDA events (mean of 20 calls
after warmup):

- `ms`: the wrapper on the NCHW levels the detector gives it;
- `channels_last_ms`: the wrapper on the same levels in channels_last;
- `nhwc_copy_ms`: the levels' copy to NHWC, `permute(0, 2, 3, 1).contiguous()`,
  which the wrapper made before it read NCHW levels in place (in the parent,
  `ms` is that copy plus `channels_last_ms`);

then the checkout's `chip_smoke.phase_detect_profile` and
`phase_detect_800_profile` (their `[detect_profile]` and
`[detect_800_profile]` lines: stage times, chunk time, busy share).

    python3 scripts/roi_align_ab.py A_ROOT B_ROOT

Prints the card's name and power limit, then each turn's `[roi_align_ab]`,
`[detect_profile]` and `[detect_800_profile]` lines, with the registers
nvcc gave the kernels, after its label and checkout.
"""

import subprocess
import sys
from pathlib import Path

PREFIXES = ("[roi_align_ab]", "[detect_profile]", "[detect_800_profile]")


def one_turn(root: Path) -> None:
    """In this process: the four RoIAlign forwards of `root`'s port, and its
    detector chunks."""
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

    detector = chip_smoke.detector_setup(device)
    det800_bf16 = chip_smoke.det800_detector(device, "bfloat16")
    native = chip_smoke.detector_rois(detector,
                                      chip_smoke.fixture_video("CATER_fixture_000000")[:30])
    feats16, rois800, levels800 = chip_smoke.detector_rois(
        det800_bf16, chip_smoke.det800_frames(), chip_smoke.EDGE_ROIS_800)
    native_bf16 = chip_smoke.detector_rois(chip_smoke.native_bf16_detector(device),
                                           chip_smoke.det800_frames())
    cases = {"K7": (rk.roi_align_batched, native),
             "K7_bf16": (rk.roi_align_batched, native_bf16),
             "K9_f32": (rk.roi_align_windowed, ([f.float() for f in feats16], rois800, levels800)),
             "K9_bf16": (rk.roi_align_windowed, (feats16, rois800, levels800))}
    for tag, (fn, (feats, rois, levels)) in cases.items():
        last = [f.contiguous(memory_format=torch.channels_last) for f in feats]
        with torch.inference_mode():
            ms = chip_smoke.time_ms(lambda: fn(feats, rois, levels, ROI_STRIDES), iters=20)
            last_ms = chip_smoke.time_ms(lambda: fn(last, rois, levels, ROI_STRIDES), iters=20)
            copy_ms = chip_smoke.time_ms(
                lambda: [f.permute(0, 2, 3, 1).contiguous() for f in feats], iters=20)
        print(f"[roi_align_ab] kernel={tag} images={rois.shape[0]} rois={rois.shape[1]} "
              f"channels={feats[0].shape[1]} dtype={feats[0].dtype} ms={ms} "
              f"channels_last_ms={last_ms} nhwc_copy_ms={copy_ms}", flush=True)
    chip_smoke.phase_detect_profile(detector)
    chip_smoke.phase_detect_800_profile(det800_bf16, chip_smoke.det800_detector(device, "float32"))
    print(f"[roi_align_ab] registers={registers}", flush=True)


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
