"""Kernels: K1's least time over its kernel's device time
(`readers.k1_roofline`)."""

from benchmark.readers import k1_roofline as read  # noqa: F401
