"""Checkpoints as `.npz` files, the counterpart of
`objectpermanence_tpu/utils/checkpoint.py`.

The JAX package saves orbax trees, which only JAX and orbax can read; the
port saves a flat `state_dict` (`"att_lstm.w_ih"`, ...; for the detector,
torchvision's names, `"backbone.body.conv1.weight"`, ...) with
`np.savez_compressed`. A JAX checkpoint crosses over once, through
`scripts/export_torch_weights.py`. A resumable training state is a
directory with `state.npz` and `metadata.json`: `state.npz` holds the
model's whole state_dict (`params/<name>`: parameters, and buffers such as
the detector's frozen batch-norm tensors) and the optimizer's state of each
tensor it updates, keyed `<part>/<name>`: Adam's `exp_avg`, `exp_avg_sq`
and `step`, SGD's `momentum_buffer`. Files are written uncompressed: a
detector's random-looking floats do not compress, and zlib is slow on its
hundreds of MB.
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
        np.savez(f, **arrays)
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


_OPTIMIZER_STATE = ("exp_avg", "exp_avg_sq", "momentum_buffer")


def _optimized_names(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """The state_dict name of each tensor the optimizer updates, in its
    order (the index its state_dict keys them by)."""
    names = {id(t): n for n, t in model.state_dict(keep_vars=True).items()}
    return [names[id(t)] for group in optimizer.param_groups for t in group["params"]]


def save_train_state(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     metadata: dict) -> Path:
    """Full resumable state: the model's state_dict, the optimizer's state
    of each tensor it updates (Adam's moments and step, or SGD's momentum
    buffer), and host `metadata`. Overwrites (a re-run after resume
    revisits epoch numbers)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state = optimizer.state_dict()["state"]
    arrays = {f"params/{name}": t.detach().cpu().numpy()
              for name, t in model.state_dict().items()}
    for index, name in enumerate(_optimized_names(model, optimizer)):
        entry = state.get(index, {})
        for key in _OPTIMIZER_STATE:
            if entry.get(key) is not None:
                arrays[f"{key}/{name}"] = entry[key].detach().cpu().numpy()
        if "step" in entry:
            arrays[f"step/{name}"] = np.asarray(float(entry["step"]), np.float32)
    with open(path / "state.npz", "wb") as f:
        np.savez(f, **arrays)
    (path / "metadata.json").write_text(json.dumps(metadata, default=float))
    return path


def train_state_params(path) -> Dict[str, torch.Tensor]:
    """The model's state_dict saved in a resumable state (`save_train_state`)."""
    with np.load(Path(path) / "state.npz", allow_pickle=False) as blob:
        return {key[len("params/"):]: torch.from_numpy(blob[key].copy())
                for key in blob.files if key.startswith("params/")}


def restore_train_state(path, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> dict:
    """Load a state written by `save_train_state` into `model` and
    `optimizer` (built over the same tensors of `model` as the one saved);
    returns the metadata."""
    path = Path(path)
    with np.load(path / "state.npz", allow_pickle=False) as blob:
        arrays = {key: blob[key] for key in blob.files}
    model.load_state_dict({key[len("params/"):]: torch.from_numpy(value)
                           for key, value in arrays.items() if key.startswith("params/")})
    state = {}
    for index, name in enumerate(_optimized_names(model, optimizer)):
        entry = {key: torch.from_numpy(arrays[f"{key}/{name}"]) for key in _OPTIMIZER_STATE
                 if f"{key}/{name}" in arrays}
        if f"step/{name}" in arrays:
            entry["step"] = torch.tensor(float(arrays[f"step/{name}"]))
        if entry:
            state[index] = entry
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


def trained_params(checkpoint_dir, metrics_file):
    """`(model_path, read_from)`: what inference reads after a training run
    that wrote `checkpoint_dir` and `metrics_file`. That is the best-dev
    tree; where the last dev mIoU was NaN (a predicted box of negative area
    can make a frame's IoU 0/0 under the +1 area convention, and a NaN mIoU
    is never the best, in the JAX loop as in the port's) and no best-dev
    tree was written, the last epoch's params, saved beside the tree as
    `last_epoch.npz`."""
    checkpoint_dir = Path(checkpoint_dir)
    dev_miou = json.loads(Path(metrics_file).read_text().splitlines()[-1])["dev"]["mean_iou"]
    best = best_params_checkpoint(checkpoint_dir)
    if (best is not None) != bool(np.isfinite(dev_miou)):
        raise ValueError(f"best-dev checkpoint {best} does not fit the last dev mIoU {dev_miou}")
    if best is not None:
        return checkpoint_dir, best.name
    last = train_state_params(latest_checkpoint(checkpoint_dir / "resume"))
    return save_params(checkpoint_dir.parent / "last_epoch.npz", last), "last_epoch"
