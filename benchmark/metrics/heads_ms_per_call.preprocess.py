"""Model step: device milliseconds of the span `objperm.detector.heads`
(RoIAlign, the box head and the class NMS) in each video, mean."""

from benchmark.detector_readers import heads_ms_per_call as read  # noqa: F401
