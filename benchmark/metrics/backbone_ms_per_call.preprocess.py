"""Model step: device milliseconds of the span `objperm.detector.backbone`
(the frames' normalisation, ResNet-50 and the FPN) in each video, mean."""

from benchmark.detector_readers import backbone_ms_per_call as read  # noqa: F401
