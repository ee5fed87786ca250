"""Least times of the port's kernels from their shapes, and the card's peaks.

The arithmetic is a frozen copy of `scripts/kernel_bounds.py` at commit
443ce38 (`opnet_fused`, `lstm_forward`, `lstm_backward`): operations over
the fp32 peak and bytes over the memory rate (each input read once, each
output written once), the larger of the two. Peaks are NVIDIA's H100 SXM
data-sheet figures at its 700 W limit: 67 TFLOP/s fp32 outside the tensor
cores (the port runs with TF32 off), 3.35 TB/s HBM3.
"""

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12
F32 = 4


def least_seconds(flops, bytes_):
    return max(flops / PEAK_FLOPS, bytes_ / PEAK_BYTES)


def opnet_fused(batch=512, frames=300, objects=15, feat=6, h1=256, h2=512, itemsize=F32):
    """K1: the whole OPNet forward, `scene @ W1_ih` included -> (flops, bytes)."""
    weights = (objects * feat * 4 * h1 + h1 * 4 * h1 + h1 * objects
               + feat * 4 * h2 + h2 * 4 * h2 + h2 * 4)
    flops = 2 * weights * batch * frames
    bytes_ = (itemsize * (batch * frames * objects * feat + weights)
              + F32 * batch * frames * (4 + objects))
    return flops, bytes_


def lstm_forward(batch=16, frames=300, hidden=512, emit_cells=True):
    """K2 (hs and cs) and K4 (hs only): the recurrence from xproj."""
    flops = 2 * hidden * 4 * hidden * batch * frames
    outputs = 2 if emit_cells else 1
    bytes_ = F32 * (batch * frames * 4 * hidden + hidden * 4 * hidden
                    + outputs * batch * frames * hidden)
    return flops, bytes_


def lstm_backward(batch=16, frames=300, hidden=512, block_b=64):
    """K3: gates recomputed (h_prev @ W_hh), dh = dgates @ W_hh^T and
    dW_hh += h_prev^T dgates: three products of the forward's size."""
    flops = 3 * 2 * hidden * 4 * hidden * batch * frames
    tiles = -(-batch // block_b)
    bytes_ = F32 * (batch * frames * (4 * hidden + 4 * hidden) + hidden * 4 * hidden
                    + batch * frames * 4 * hidden + tiles * hidden * 4 * hidden)
    return flops, bytes_
