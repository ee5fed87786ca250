"""Model step: device milliseconds of the span `objperm.model.encoder` in
each step, mean: the forward alone (its backward is in the backward's)."""

from benchmark.program_readers import encoder_ms_per_call as read  # noqa: F401
