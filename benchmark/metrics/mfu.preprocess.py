"""Model step: the forward FLOPs of the frames detected over the window's
seconds, as a share of the fp32 peak."""

from benchmark.readers import mfu_serve as read  # noqa: F401
