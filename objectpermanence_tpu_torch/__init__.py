"""objectpermanence_tpu_torch: the PyTorch and CUDA port of objectpermanence_tpu.

The JAX package `objectpermanence_tpu` beside this one is the reference
that every part of the port is held against. This package imports torch
and numpy only, never jax and never a module of the JAX package: what it
needs from there it keeps as its own copy. Modules mirror the JAX
package's paths (`ops/boxes.py` here is `ops/boxes.py` there).

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; without a card they raise rather than fall back.
"""

import torch

__version__ = "0.1.0"

VIDEO_NUM_FRAMES = 300
FRAME_WIDTH = 320
FRAME_HEIGHT = 240
MAX_OBJECTS_IN_FRAME = 15


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks for
    the CPU. Raises when the card is asked for (or implied) and missing."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this entry point runs on the card unless it is "
            "given device='cpu'")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
