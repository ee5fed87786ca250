"""Entry and driver: the port's blocking reads (`host_syncs` counter) in
each video: the frames' and outputs' copies, and any wait that NMS makes
(a NMS that checks its rounds from the host waits once a check), mean."""

from benchmark.detector_readers import host_syncs_per_call as read  # noqa: F401
