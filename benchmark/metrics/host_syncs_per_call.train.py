"""Entry and driver: the port's blocking copies (`host_syncs` counter) in
each step and its batch, mean."""

from benchmark.program_readers import host_syncs_per_call as read  # noqa: F401
