"""The nearest-rank 95th percentile of every request's time from its
submission to its int16 boxes on the host, over all the window's requests."""

from benchmark.readers import p95_ms as read  # noqa: F401
