"""The Faster R-CNN detector, the counterpart of
`objectpermanence_tpu/models/detector/`: ResNet-FPN backbone, RPN, RoI
heads with padded static shapes, and multilevel RoIAlign on the card's
kernel (`ops/roi_align_kernel.py`)."""

from objectpermanence_tpu_torch.models.detector.detector import CaterDetector  # noqa: F401
