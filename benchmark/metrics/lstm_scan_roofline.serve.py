"""Kernels: K4's least time over its kernel's device time
(`readers.lstm_serve_roofline`)."""

from benchmark.readers import lstm_serve_roofline as read  # noqa: F401
