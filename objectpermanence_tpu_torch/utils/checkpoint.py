"""Parameter checkpoints as `.npz` files, the counterpart of the params
part of `objectpermanence_tpu/utils/checkpoint.py`.

The JAX package saves orbax trees, which only JAX and orbax can read; the
port saves a flat `state_dict` (`"att_lstm.w_ih"`, ...) with
`np.savez_compressed`. A JAX checkpoint crosses over once, through
`scripts/export_torch_weights.py`.
"""

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch


def _is_orbax(path: Path) -> bool:
    return path.is_dir() and ((path / "_METADATA").exists()
                              or (path / "_CHECKPOINT_METADATA").exists())


def save_params(path, state_dict: Dict[str, torch.Tensor]) -> Path:
    """Write a state_dict as one compressed npz (overwrites)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    with open(path, "wb") as f:  # a file object keeps numpy from appending .npz
        np.savez_compressed(f, **arrays)
    return path


def load_params(path) -> Dict[str, torch.Tensor]:
    """Read an npz written by `save_params` into a CPU state_dict."""
    path = Path(path)
    if _is_orbax(path):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package, which the port cannot "
            f"read; convert it once with `python scripts/export_torch_weights.py {path} "
            f"<out>.npz` and point model_path at the npz")
    if path.is_dir():
        raise FileNotFoundError(f"no <stamp>_<dev_miou>.npz checkpoint in {path}")
    with np.load(path, allow_pickle=False) as blob:
        return {key: torch.from_numpy(blob[key].copy()) for key in blob.files}


def best_params_checkpoint(checkpoint_dir) -> Optional[Path]:
    """Best-dev checkpoint under a directory of `<stamp>_<dev_miou>.npz`
    leaves: the highest mIoU, ties broken by recency. None when
    `checkpoint_dir` is not a directory; raises when it is an orbax tree."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.is_dir():
        return None
    if _is_orbax(checkpoint_dir) or any(_is_orbax(p) for p in checkpoint_dir.iterdir()):
        raise ValueError(
            f"{checkpoint_dir} holds orbax checkpoints of the JAX package, which the port "
            f"cannot read; convert the leaf once with `python scripts/export_torch_weights.py "
            f"<leaf> <out>.npz`")

    def score(p: Path) -> Optional[float]:
        try:
            return float(p.stem.rsplit("_", 1)[1])
        except (IndexError, ValueError):
            return None

    candidates = [(score(p), p.stat().st_mtime, p) for p in checkpoint_dir.glob("*.npz")
                  if score(p) is not None]
    if not candidates:
        return None
    return max(candidates)[2]
