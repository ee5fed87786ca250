"""Kernels: K7's least time over its kernel's device time
(`detector_readers.roi_align_roofline`)."""

from benchmark.detector_readers import roi_align_roofline as read  # noqa: F401
