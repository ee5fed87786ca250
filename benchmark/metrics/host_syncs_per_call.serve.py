"""Entry and driver: the port's blocking copies (`host_syncs` counter) in
each `predict_step` call, mean."""

from benchmark.program_readers import host_syncs_per_call as read  # noqa: F401
