"""Entry and driver: host milliseconds inside each `predict_step` call
(the enqueue), mean over the window."""

from benchmark.readers import host_ms_per_call as read  # noqa: F401
