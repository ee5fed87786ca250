"""The least time of the detector's RoIAlign forward (K7) from its shapes.

A frozen copy of `scripts/kernel_bounds.py::roi_align` at commit 443ce38
(there, K7's row: `roi_align(NATIVE, 300, images=30)`, 0.197 ms), counting
the whole pyramid P2-P5 read once: operations over the fp32 peak and
bytes over the memory rate, the larger of the two (`bounds.least_seconds`).
"""

from benchmark.bounds import F32, least_seconds


def roi_align(levels, rois, images=1, channels=256, pooled=7, sampling=2, itemsize=F32):
    """RoIAlign over an FPN pyramid `levels [(h, w)]`: per output element,
    sampling^2 samples of 4 bilinear taps (a multiply and an add each). The
    forward reads the pyramid (`itemsize` bytes an element) and the rois
    and writes (N, C, 7, 7) in fp32 -> (flops, bytes)."""
    pixels_read = images * sum(h * w for h, w in levels)
    out = images * rois * channels * pooled * pooled
    flops = out * sampling * sampling * 4 * 2
    bytes_ = itemsize * channels * pixels_read + F32 * (out + images * rois * 4)
    return flops, bytes_


def roi_align_seconds(config, images):
    """K7's least time for a chunk of `images` frames at `config`: P2-P5 of
    the padded frame, `rpn_post_nms_top_n` rois an image."""
    from benchmark.models.faster_rcnn_r50_fpn import padded_hw

    h, w = padded_hw(config)
    levels = [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32)]
    return least_seconds(*roi_align(levels, config["preprocess_config"]["rpn_post_nms_top_n"],
                                    images, config["fpn_channels"], config["roi_output_size"],
                                    config["sampling_ratio"]))
