"""Entry and driver: host milliseconds inside `DeviceDataset.batch` and
`train_step`, mean over the window's steps."""

from benchmark.readers import host_ms_per_call as read  # noqa: F401
