"""Where RoIAlign's backward (K8) spends its time, by ablation: variants of
`csrc/roi_align.cu` built at once (text substitutions, each asserted to
apply), each loaded in place of the library and timed on the inputs
`chip_smoke.py` holds K8 on (the dettrain detector's pyramid, B=8, N=320,
float32 dF; the train800 bf16 detector's, B=4, N=320, bf16 dF): the device
time of K8's two kernels (torch.profiler, mean of 10 calls after warmup),
the binning's and the tile kernel's apart:

- `full`: the kernels as they are;
- `no_sums`: no roi is added to the sums (copies and weights as usual);
- `no_weights`: the roi's weights on the tile are not built (the sums read
  whatever shared memory holds);
- `no_copy`: no roi's dOut slice is copied;
- `barriers`: the roi loop keeps only its waits and barriers;
- `no_rois`: every tile's list is taken as empty (the block writes zeros).

    python3 scripts/roi_align_backward_phases.py [--root CHECKOUT]

`--root` measures another checkout's source with its own wrapper. Prints the
card's name and power limit and one `[roi_align_backward_phases]` line per
case.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SUMS = ("      add_roi<P>(acc, ", "      if (c < 0) add_roi<P>(acc, ")
WEIGHTS = ("      if (i + 1 < m)\n        build_weights(",
           "      if (i + 1 < 0)\n        build_weights(")
COPY = ("      if (g < m)\n        copy_dout(", "      if (g < 0)\n        copy_dout(")
TABLE = ("      if (g + 1 < m)\n        copy_table(", "      if (g + 1 < 0)\n        copy_table(")
VARIANTS = {
    "full": [],
    "no_sums": [SUMS],
    "no_weights": [WEIGHTS],
    "no_copy": [COPY],
    "barriers": [SUMS, WEIGHTS, COPY, TABLE],
    "no_rois": [("  const int count = counts[cell];\n", "  const int count = counts[cell] * 0;\n")],
}


def build_variants(root: Path, build_dir: Path) -> dict:
    """nvcc for every variant at once; returns name -> library path."""
    sys.path.insert(0, str(root))
    from objectpermanence_tpu_torch.ops import _build
    source = (root / "objectpermanence_tpu_torch" / "csrc" / "roi_align.cu").read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        src = build_dir / f"roi_align_{name}.cu"
        src.write_text(text)
        lib = build_dir / f"libroi_align_{name}.so"
        procs[name] = (subprocess.Popen([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                                         str(src)], stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        out = proc.communicate()[0]
        assert proc.returncode == 0, out
        libs[name] = lib
    return libs


def kernel_ms(call, launches=10):
    """Device milliseconds per call of `call` of K8's binning and tile
    kernels."""
    import torch
    import chip_smoke
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            call()
        torch.cuda.synchronize()
    kernels = chip_smoke.device_kernel_ms(prof)
    return {part: sum(ms for name, ms in kernels.items() if f"roi_align_backward_{part}" in name)
            / launches for part in ("bin_kernel", "kernel")}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    root = Path(parser.parse_args().root).resolve()
    libs = build_variants(root, root / "build" / "roi_align_backward_phases")
    import torch
    import chip_smoke
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    train_set, _ = chip_smoke.detection_sets(root / "build" / "chip_smoke_detection")
    _, (dout, rois, levels, shapes, _) = chip_smoke.phase_roi_align_grad_vs_plain(
        chip_smoke.dettrain_detector(device), train_set)
    _, (dout800, rois800, levels800, shapes800) = chip_smoke.phase_roi_align_bf16_grad_vs_plain(
        device, train_set)
    cases = {"K8": ((dout, rois, levels, shapes), torch.float32),
             "K8_bf16": ((dout800, rois800, levels800, shapes800), torch.bfloat16)}
    for tag, ((grad, r, lv, sh), dtype) in cases.items():
        row = {}
        for name, lib in libs.items():
            _build._LIBS["roi_align"] = ctypes.CDLL(str(lib))
            rk._FNS.clear()
            row[name] = kernel_ms(
                lambda: rk.roi_align_batched_backward(grad, r, lv, sh, ROI_STRIDES, dtype=dtype))
        print(f"[roi_align_backward_phases] kernel={tag} images={r.shape[0]} rois={r.shape[1]} "
              f"plan={json.dumps(rk.backward_launch_plan(grad.shape[2], 7, 2, dtype.itemsize))} "
              f"ms={json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
