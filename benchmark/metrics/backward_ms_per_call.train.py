"""Model step: device milliseconds of the span `objperm.train.backward`
(`loss.backward()`) in each step, mean."""

from benchmark.program_readers import backward_ms_per_call as read  # noqa: F401
