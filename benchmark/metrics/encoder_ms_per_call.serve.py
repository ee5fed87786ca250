"""Model step: device milliseconds of the span `objperm.model.encoder` in
each `predict_step` call, mean."""

from benchmark.program_readers import encoder_ms_per_call as read  # noqa: F401
