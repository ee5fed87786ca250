"""Checkpoints as `.npz` files, the counterpart of
`objectpermanence_tpu/utils/checkpoint.py`.

The JAX package saves orbax trees, which only JAX and orbax can read; the
port saves a flat `state_dict` (`"att_lstm.w_ih"`, ...) with
`np.savez_compressed`. A JAX checkpoint crosses over once, through
`scripts/export_torch_weights.py`. A resumable training state is a
directory with `state.npz` (the params and Adam's `exp_avg`, `exp_avg_sq`
and `step` of each, keyed `<part>/<param name>`) and `metadata.json`.
"""

import json
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


def save_train_state(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     metadata: dict) -> Path:
    """Full resumable state: params + Adam's moments and step + host
    metadata. Overwrites (a re-run after resume revisits epoch numbers)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = optimizer.state_dict()["state"]
    arrays = {}
    for index, (name, param) in enumerate(model.named_parameters()):
        arrays[f"params/{name}"] = param.detach().cpu().numpy()
        moments = state.get(index)
        if moments is not None:
            for key in ("exp_avg", "exp_avg_sq"):
                arrays[f"{key}/{name}"] = moments[key].detach().cpu().numpy()
            arrays[f"step/{name}"] = np.asarray(float(moments["step"]), np.float32)
    with open(path / "state.npz", "wb") as f:
        np.savez_compressed(f, **arrays)
    (path / "metadata.json").write_text(json.dumps(metadata, default=float))
    return path


def restore_train_state(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """Load a state written by `save_train_state` into `model` and
    `optimizer` (built over `model.parameters()`); returns the metadata."""
    path = Path(path)
    with np.load(path / "state.npz", allow_pickle=False) as blob:
        arrays = {key: blob[key] for key in blob.files}
    names = [name for name, _ in model.named_parameters()]
    model.load_state_dict({n: torch.from_numpy(arrays[f"params/{n}"]) for n in names})
    state = {}
    for index, name in enumerate(names):
        if f"step/{name}" in arrays:
            state[index] = {"step": torch.tensor(float(arrays[f"step/{name}"])),
                            "exp_avg": torch.from_numpy(arrays[f"exp_avg/{name}"]),
                            "exp_avg_sq": torch.from_numpy(arrays[f"exp_avg_sq/{name}"])}
    optimizer.load_state_dict({"state": state,
                               "param_groups": optimizer.state_dict()["param_groups"]})
    return json.loads((path / "metadata.json").read_text())


def latest_checkpoint(checkpoint_dir) -> Optional[Path]:
    """Most recent resumable checkpoint under `checkpoint_dir`, if any."""
    checkpoint_dir = Path(checkpoint_dir)
    if not checkpoint_dir.exists():
        return None
    candidates = [p for p in checkpoint_dir.iterdir() if (p / "metadata.json").exists()]
    if not candidates:
        return None
    return max(candidates, key=lambda p: (p.stat().st_mtime, p.name))
