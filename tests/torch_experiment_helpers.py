"""Shared pieces of the tests that hold the port's experiment drivers
(`objectpermanence_tpu_torch/experiments/`) against the JAX package's
scripts (`scripts/<name>.py`) on the CPU.

- `files`: every file and link under a root, for byte-for-byte checks.
- `run_quiet` and `jax_main`: a stage function, or a JAX script's `main()`
  (which reads `sys.argv`), with its printed lines returned.
- `from_jax_init`: the port's `get_model_spec` with its models built from
  JAX's init, as JAX's `training_main` builds them.
- `same_detector_start`: the port's `train_detector` starting where JAX's
  does. JAX draws its sampling priorities from `jax.random` and inits from
  `PRNGKey(seed)`; the port takes the draws as arguments (`Draws`) and
  inits from a torch generator. Patched here: the port's init loads JAX's
  `detector_init(PRNGKey(seed))` through the weight bridge, and every step
  of the port draws the uniforms JAX draws from its step key (the epoch's
  `fold_in(PRNGKey(seed + 1), epoch)`, split once a step; each image's key
  split into (rpn, roi), each into (positives, negatives), as
  `detection_loss` splits it). Both loops' loss parts are recorded.
"""

import contextlib
import dataclasses
import io
import os
import sys

import jax
import numpy as np
import pytest
import torch

import objectpermanence_tpu.train.detector_loop as jax_detector_loop
from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.detector import training as port_training
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.models.registry import model_class
from objectpermanence_tpu_torch.train import detector_loop as port_detector_loop


def files(root):
    """Every file and link under `root`, not followed: relative path ->
    its bytes, or ("link", target)."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        for name in dirnames + filenames:
            path = os.path.join(dirpath, name)
            key = os.path.relpath(path, root)
            if os.path.islink(path):
                out[key] = ("link", os.readlink(path))
            elif os.path.isfile(path):
                with open(path, "rb") as f:
                    out[key] = f.read()
    return out


def run_quiet(fn, *args, **kwargs):
    """`fn(*args, **kwargs)` with its printed lines returned."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kwargs)
    return out.getvalue()


def jax_main(module, argv):
    """A JAX script's `main()`, which reads `sys.argv`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [module.__name__] + [str(a) for a in argv])
        return run_quiet(module.main)


def from_jax_init(get_spec, default_config):
    """The port's `get_model_spec`, its models built from JAX's init
    (`PRNGKey(0)`, the training seed; `default_config` where the caller
    gives none), as JAX's `training_main` builds them."""
    def port_model(name, params, config):
        model = model_class(name)(config)
        model.load_state_dict(params_from_jax(jax.device_get(params)))
        return model

    def patched(name, config=None):
        spec = get_spec(name, config)
        params = jax_get_model_spec(name, config).init(jax.random.PRNGKey(0),
                                                       config or default_config)
        return dataclasses.replace(spec, build=lambda cfg, gen: port_model(name, params, cfg))
    return patched


def jax_config(**kwargs):
    return jdet.DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in kwargs.items()})


def jax_init(config, seed=0):
    """JAX's `detector_init(PRNGKey(seed))` on the host, and as the port's
    state_dict."""
    params = jax.device_get(jdet.detector_init(jax.random.PRNGKey(seed), config))
    return params, state_dict_from_jax(params, config.backbone_layers)


def jax_draws(key, batch, num_anchors, num_rois):
    """JAX's uniforms for `detection_loss(..., key)`, as the port's `Draws`."""
    keys = jax.random.split(key, batch * 2).reshape(batch, 2, -1)

    def pair(k, n):
        r1, r2 = jax.random.split(k)
        return np.asarray(jax.random.uniform(r1, (n,))), np.asarray(jax.random.uniform(r2, (n,)))

    rpn = [pair(keys[i, 0], num_anchors) for i in range(batch)]
    roi = [pair(keys[i, 1], num_rois) for i in range(batch)]
    return port_training.Draws(*[torch.from_numpy(np.stack(x)) for x in (
        [p for p, _ in rpn], [n for _, n in rpn], [p for p, _ in roi], [n for _, n in roi])])


def _recording(make_step, record):
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **k):
            out = step(*a, **k)
            parts = out[2] if isinstance(out, tuple) else out
            record.append({name: float(v) for name, v in parts.items()})
            return out
        if hasattr(step, "count"):  # the port's step keeps its update count
            recorded.__dict__ = step.__dict__
        return recorded
    return make


def same_detector_start(mp, jax_cfg, steps_per_epoch, seed=0):
    """Patch the port's detector training to start from JAX's init and draw
    JAX's uniforms (for `seed`, whose epochs have `steps_per_epoch` steps);
    returns the recorded loss parts, {"jax": [...], "port": [...]}, a dict
    per step."""
    _, state_dict = jax_init(jax_cfg, seed)
    mp.setattr(port_detector_loop, "init_detector",
               lambda model, seed=0: model.load_state_dict(state_dict) and model)
    steps = [0]

    def sample(cls, batch, num_anchors, num_rois, device, generator=None, rows=None):
        epoch, index = divmod(steps[0], steps_per_epoch)
        rng = jax.random.fold_in(jax.random.PRNGKey(seed + 1), epoch)
        for _ in range(index + 1):
            rng, sub = jax.random.split(rng)
        steps[0] += 1
        return jax_draws(sub, batch, num_anchors, num_rois)

    mp.setattr(port_training.Draws, "sample", classmethod(sample))
    losses = {"jax": [], "port": []}
    mp.setattr(jax_detector_loop, "make_detector_train_step",
               _recording(jax_detector_loop.make_detector_train_step, losses["jax"]))
    mp.setattr(port_detector_loop, "make_detector_train_step",
               _recording(port_detector_loop.make_detector_train_step, losses["port"]))
    return losses
