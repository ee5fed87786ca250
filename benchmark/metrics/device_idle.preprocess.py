"""Device: the share of the profiled stretch with no device operation."""

from benchmark.readers import device_idle as read  # noqa: F401
