"""Model step: three times the forward FLOPs of the frames trained on over
the window's seconds, as a share of the fp32 peak."""

from benchmark.readers import mfu_train as read  # noqa: F401
