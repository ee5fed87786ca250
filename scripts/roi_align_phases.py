"""Where the RoIAlign forward kernel's time goes, by ablation: variants of
`csrc/roi_align.cu` built at once (text substitutions, each asserted to
apply), each loaded in place of the library and timed on the inputs
`chip_smoke.py` times K7, K7 bf16, K9 f32 and K9 bf16 on: the kernel's own
device time (torch.profiler, mean of 10 launches after warmup), so the
wrapper's host time, which a variant that does little would show, is left
out:

- `full`: the kernel as it is;
- `setup`: the block returns once its sample, compact and pixel tables are
  built (after the out-of-contract count);
- `no_stage`: the tile is not copied (the sums read whatever shared memory
  holds);
- `no_compute`: no bin is summed (each output is its bin's index);
- `no_store`: the output tile is read but not written out.

Also K7 on the same levels in channels_last, and the compact tiles of each
case's rois (pixels of the tile, mean and 90th percentile, from the plain
geometry).

    python3 scripts/roi_align_phases.py [--root CHECKOUT]

`--root` measures another checkout's source with its own wrapper. Prints the
card's name and power limit and one `[roi_align_phases]` line per case.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

VARIANTS = {
    "full": [],
    "setup": [("  __syncthreads();  // weights, taps, pixoff\n",
               "  __syncthreads();  // weights, taps, pixoff\n  if (slice > 0) return;\n")],
    "no_stage": [("  const int inner = channel_fastest ? count : pixels;\n",
                  "  if (count > 0) return;\n  const int inner = channel_fastest ? count : pixels;\n")],
    "no_compute": [("const float2 acc = pool_bin<S>(pair, taps, weights, k, s, py, px);",
                    "const float2 acc = make_float2((float)bin, (float)bin);")],
    "no_store": [("dst[i] = otile[i];", "if (otile[i] == 1.2345e30f) dst[i] = 0.0f;")],
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
    """Device milliseconds of the forward kernel per launch of `call`."""
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
    return sum(ms for name, ms in kernels.items() if "roi_align_forward_kernel" in name) / launches


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    root = Path(parser.parse_args().root).resolve()
    libs = build_variants(root, root / "build" / "roi_align_phases")
    import numpy as np
    import torch
    import chip_smoke
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops.roi_align import _geometry
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    native = chip_smoke.detector_rois(chip_smoke.detector_setup(device),
                                      chip_smoke.fixture_video("CATER_fixture_000000")[:30])
    feats16, rois800, levels800 = chip_smoke.detector_rois(
        chip_smoke.det800_detector(device, "bfloat16"), chip_smoke.det800_frames(),
        chip_smoke.EDGE_ROIS_800)
    native_bf16 = chip_smoke.detector_rois(chip_smoke.native_bf16_detector(device),
                                           chip_smoke.det800_frames())
    cases = {"K7": (rk.roi_align_batched, native),
             "K7_bf16": (rk.roi_align_batched, native_bf16),
             "K9_f32": (rk.roi_align_windowed, ([f.float() for f in feats16], rois800, levels800)),
             "K9_bf16": (rk.roi_align_windowed, (feats16, rois800, levels800))}
    last = [f.contiguous(memory_format=torch.channels_last) for f in native[0]]
    cases["K7_channels_last"] = (rk.roi_align_batched, (last, *native[1:]))
    for tag, (fn, (feats, rois, levels)) in cases.items():
        shapes = [tuple(f.shape[-2:]) for f in feats]
        offsets = np.cumsum([0] + [h * w for h, w in shapes])
        scales = 1.0 / torch.tensor(ROI_STRIDES, dtype=torch.float32, device=device)
        pixels = []
        for b in range(rois.shape[0]):
            rows, _, _ = _geometry(shapes, rois[b], levels[b], scales, 7, 2)
            taps = torch.stack(rows, -1).reshape(rois.shape[1], -1).cpu().numpy()
            for n, level in enumerate(levels[b].tolist()):
                t = taps[n] - offsets[level]
                width = shapes[level][1]
                pixels.append(np.unique(t // width).size * np.unique(t % width).size)
        row = {"tile_pixels_mean": float(np.mean(pixels)),
               "tile_pixels_p90": float(np.percentile(pixels, 90))}
        with torch.inference_mode():
            for name, lib in libs.items():
                _build._LIBS["roi_align"] = ctypes.CDLL(str(lib))
                rk._FNS.clear()
                row[name] = kernel_ms(lambda: fn(feats, rois, levels, ROI_STRIDES))
        print(f"[roi_align_phases] kernel={tag} images={rois.shape[0]} rois={rois.shape[1]} "
              f"plan={json.dumps(rk.launch_plan(feats[0].shape[1], 7, 2, feats[0].element_size()))} "
              f"ms={json.dumps(row)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
