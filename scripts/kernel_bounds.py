"""Least time an H100 could take for each TPU kernel of the repository, at
the shapes where it runs: the larger of its operations over the fp32 peak
and its bytes over the memory rate (each input read once, each output
written once). Pure arithmetic from shapes; runs anywhere.

    python scripts/kernel_bounds.py

Peaks are NVIDIA's H100 SXM data-sheet figures at its 700 W limit: 67
TFLOP/s fp32 outside the tensor cores, 3.35 TB/s HBM3. Elements are fp32
(4 bytes), except in the bf16 modes: the RoIAlign forwards read 2-byte
features (their sums and output stay fp32), K8's bf16 mode writes a 2-byte
dF (it reads the fp32 dOut), and K1's bf16 mode reads 2-byte weights and
boxes (its outputs stay fp32). K1's bf16 mode is still counted at the fp32
peak: it multiplies float32 carries by bf16 weights and sums in float32,
which the bf16 tensor cores cannot do without rounding the carries, a
different function.

A RoIAlign forward needs only the pixels its rois reach, which depends on
the rois. Without rois this table counts the whole pyramid as read, an
upper figure that flatters the forwards most at 800 px, where the rois touch
a small part of P2; chip_smoke.py passes `roi_align` the pixels its run's
rois reach, and its `bound_ms` is the one to quote.
"""

import math

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def opnet_fused(batch=512, frames=300, objects=15, feat=6, h1=256, h2=512, itemsize=F32):
    """K1 at the bench's served batch (bench.py: 512 videos x 300 frames);
    `itemsize` 2 for the bf16 mode's weights and boxes."""
    weights = (objects * feat * 4 * h1 + h1 * 4 * h1 + h1 * objects
               + feat * 4 * h2 + h2 * 4 * h2 + h2 * 4)
    flops = 2 * weights * batch * frames
    bytes_ = (itemsize * (batch * frames * objects * feat + weights)
              + F32 * batch * frames * (4 + objects))
    dtype = "bf16" if itemsize == 2 else "f32"
    return f"B={batch} T={frames} H={h1}/{h2}, {dtype}", flops, bytes_


def lstm_forward(batch=16, frames=300, hidden=512, emit_cells=True):
    """K2 (hs and cs) and K4 (hs only): the recurrence from xproj, at the
    training batch (configs/training_config.json) and OPNet's video LSTM."""
    flops = 2 * hidden * 4 * hidden * batch * frames
    outputs = 2 if emit_cells else 1
    bytes_ = F32 * (batch * frames * 4 * hidden + hidden * 4 * hidden
                    + outputs * batch * frames * hidden)
    return f"B={batch} T={frames} H={hidden}", flops, bytes_


def lstm_backward(batch=16, frames=300, hidden=512, block_b=64):
    """K3: gates recomputed (h_prev @ W_hh), dh = dgates @ W_hh^T and
    dW_hh += h_prev^T dgates: three products of the forward's size."""
    flops = 3 * 2 * hidden * 4 * hidden * batch * frames
    tiles = math.ceil(batch / block_b)
    bytes_ = F32 * (batch * frames * (4 * hidden + 4 * hidden) + hidden * 4 * hidden
                    + batch * frames * 4 * hidden + tiles * hidden * 4 * hidden)
    return f"B={batch} T={frames} H={hidden}", flops, bytes_


def roi_align(levels, rois, images=1, channels=256, pooled=7, sampling=2, itemsize=F32,
              pixels_read=None):
    """RoIAlign over an FPN pyramid: per output element, sampling^2 samples
    of 4 bilinear taps (a multiply and an add each). The forward reads the
    pyramid (`itemsize` bytes an element: 4 for fp32, 2 for bf16) and the
    rois and writes (N, C, 7, 7) in fp32; the backward reads dOut and writes
    dF of the pyramid's size. `pixels_read`, the count of (image, level,
    pixel) taps the rois reach with a nonzero weight, makes the forward read
    only those pixels' C channels; without it the whole pyramid is counted,
    which over-counts where the rois touch only part of it (the 800 px P2)."""
    if pixels_read is None:
        pixels_read = images * sum(h * w for h, w in levels)
    out = images * rois * channels * pooled * pooled
    flops = out * sampling * sampling * 4 * 2
    bytes_ = itemsize * channels * pixels_read + F32 * (out + images * rois * 4)
    dtype = "bf16" if itemsize == 2 else "f32"
    return f"{images} img x {rois} rois, C={channels}, {dtype}", flops, bytes_


# FPN P2..P5 at the native CATER preprocess recipe (configs/preprocess_config.json:
# 320x240 padded to 320x256, 300 proposals per image, batches of 30) and at
# the 800 px recipe (DetectorConfig defaults: 1067x800 padded to 1088x800; its
# served configuration, scripts/detector_infer800.py bf16_windowed, keeps 300
# proposals per image in batches of 8).
NATIVE = [(64, 80), (32, 40), (16, 20), (8, 10)]
P800 = [(200, 272), (100, 136), (50, 68), (25, 34)]

KERNELS = [
    ("K1", "pallas_scan.py:485 opnet_fused_forward", opnet_fused()),
    ("K1", "pallas_scan.py:485 opnet_fused_forward", opnet_fused(itemsize=2)),
    ("K2", "pallas_scan.py:179 _lstm_fwd_pallas", lstm_forward()),
    ("K3", "pallas_scan.py:221 _lstm_bwd_pallas", lstm_backward()),
    ("K4", "pallas_scan.py:347 lstm_scan_pallas", lstm_forward(emit_cells=False)),
    ("K5", "pallas_roi_align.py:290 _pallas_roi_align", roi_align(NATIVE, 300)),
    ("K6", "pallas_roi_align.py:468 _pallas_roi_align_tiled", roi_align(NATIVE, 300)),
    ("K7", "pallas_roi_align.py:679 _pallas_roi_align_tiled_batched",
     roi_align(NATIVE, 300, images=30)),
    # K8 runs in the detector's train step only: batches of 8 (the dettrain
    # recipe, scripts/two_stage_run.py), 300 proposals + 20 ground-truth boxes
    ("K8", "pallas_roi_align.py:858 _pallas_roi_align_tiled_batched_bwd",
     roi_align(NATIVE, 320, images=8)),
    # K8's bf16 mode runs in the 800 px recipe's train step (train800 of
    # scripts/detector_800px_run.py: batches of 4, 300 proposals + 20 gt)
    ("K8", "pallas_roi_align.py:858 _pallas_roi_align_tiled_batched_bwd",
     roi_align(P800, 320, images=4, itemsize=2)),
    ("K9", "pallas_roi_align.py:1052 _pallas_roi_align_windowed",
     roi_align(P800, 300, images=8)),
    ("K9", "pallas_roi_align.py:1052 _pallas_roi_align_windowed",
     roi_align(P800, 300, images=8, itemsize=2)),
    # K7's bf16 mode runs for the native geometry in bf16, in chunks of 8
    ("K7", "pallas_roi_align.py:679 _pallas_roi_align_tiled_batched",
     roi_align(NATIVE, 300, images=8, itemsize=2)),
]


def main() -> None:
    print("| # | pallas_call site | shapes | GFLOP | MB | bound_ms | bound by |")
    print("|---|---|---|---|---|---|---|")
    for tag, site, (shapes, flops, bytes_) in KERNELS:
        t_ops, t_bytes = flops / PEAK_FLOPS, bytes_ / PEAK_BYTES
        print(f"| {tag} | {site} | {shapes} | {flops / 1e9:.4g} | {bytes_ / 1e6:.4g} "
              f"| {max(t_ops, t_bytes) * 1e3:.4g} | "
              f"{'operations' if t_ops >= t_bytes else 'bytes'} |")


if __name__ == "__main__":
    main()
