"""Entry and driver: host milliseconds of each `predict_step` call outside
the port's blocking copies between host and device (the call's span less
its `objperm.host.*` spans), mean: the host's own work a call."""

from benchmark.program_readers import host_own_ms_per_call as read  # noqa: F401
