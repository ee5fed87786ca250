"""Entry and driver: host milliseconds of each step and its batch outside
the port's blocking copies between host and device (the spans less their
`objperm.host.*` spans), mean: the host's own work a step."""

from benchmark.program_readers import host_own_ms_per_call as read  # noqa: F401
