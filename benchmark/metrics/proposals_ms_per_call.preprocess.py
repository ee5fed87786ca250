"""Model step: device milliseconds of the span `objperm.detector.proposals`
(the RPN head, the decode and the NMS, with any gap while the host reads
its flag) in each video, mean."""

from benchmark.detector_readers import proposals_ms_per_call as read  # noqa: F401
