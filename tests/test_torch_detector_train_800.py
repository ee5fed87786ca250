"""The port's 800 px detector training against the JAX package's, on the
CPU, in float32 (bf16: `tests/test_torch_detector_train_800_bf16.py`, which
shares this file's cases and checks).

The JAX package's `train800` recipe (`scripts/detector_800px_run.py`:
min 800 / max 1333, so 240 x 320 frames resize to 800 x 1067 and pad to
800 x 1088; GroupNorm; `roi_backend="windowed"`; float32, or bf16 with
`--compute-dtype bfloat16`) at TINY width (ResNet 1-1-1-1, width 16, FPN 32,
RPN 200/100), one fixture frame (B=1), with the windowed and with the
`"auto"` backend. JAX's windowed RoIAlign runs its Pallas forward in
interpret mode (its backward is the gather VJP); its `"auto"` is the gather
off the TPU, and the port's `"auto"` the exact pair (K7, K8) off the card.
Same weights (JAX's `detector_init(PRNGKey(0))` through the weight bridge)
and JAX's own sampling draws.

- The four loss parts within 1e-5 relative (measured at most 9.2e-7),
  every gradient within 5e-3 x max(1, max |JAX's|): at 800 x 1088 float32
  itself is that far apart (measured 1.3e-3, the stem's gradient, summed
  over 400 x 544 positions in another order).
- One `train_detector` epoch at this geometry, windowed, with evaluation:
  finite losses, float32 masters in every checkpoint, and the windowed
  dispatches of training and evaluation counted.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.detector import training as jtr
from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
from objectpermanence_tpu_torch.models.detector import detector as det
from objectpermanence_tpu_torch.models.detector import training as tr
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.ops import roi_align_window
from objectpermanence_tpu_torch.train.detector_loop import train_detector
from objectpermanence_tpu_torch.utils.checkpoint import load_params
from test_torch_detector_800 import TINY_800, _interpret
from test_torch_detector_train import _draws, _frames, _rel
from torch_lane import one_torch_thread  # noqa: F401

LOSS_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
F32_GRAD_RTOL = 5e-3
BF16_NORM_RTOL, BF16_MIN_COSINE, BF16_GRAD_RTOL = 0.1, 0.9, 0.3
KEY_SEED = 600


class LossCase:
    """JAX's `detection_loss` and its gradients at the 800 px TINY recipe on
    one frame, and the port's on the same weights and draws."""

    def __init__(self, dtype, backend):
        kwargs = dict(TINY_800, compute_dtype=dtype, roi_backend=backend)
        self.cfg, jcfg = det.DetectorConfig(**kwargs), jdet.DetectorConfig(**kwargs)
        assert self.cfg.padded_hw == (800, 1088)
        params = jax.device_get(jax.jit(lambda k: jdet.detector_init(k, jcfg))(
            jax.random.PRNGKey(0)))
        batch = _frames({}, 1, 6)
        janchors = [jnp.asarray(a) for a in jdet.anchor_lib.pyramid_anchors(
            jcfg.feature_shapes(), jcfg.strides, jcfg.anchor_sizes)]
        arrays = [jnp.asarray(a) for a in batch]
        key = jax.random.PRNGKey(KEY_SEED)
        loss = jax.jit(jax.value_and_grad(
            lambda p: jtr.detection_loss(p, *arrays, key, jcfg, janchors), has_aux=True))
        (_, parts), grads = _interpret(lambda: loss(params))
        self.want_parts = parts
        self.want_grads = state_dict_from_jax(grads, self.cfg.backbone_layers)

        model = det.Detector(self.cfg)
        model.load_state_dict(state_dict_from_jax(params, self.cfg.backbone_layers))
        self.named = tr.trainable_tensors(model)
        draws = _draws(key, 1, sum(a.shape[0] for a in janchors),
                       self.cfg.rpn_post_nms_top_n + batch[1].shape[1])
        images, boxes, labels, valid = [torch.from_numpy(np.asarray(a)) for a in batch]
        anchors = [torch.from_numpy(np.array(a)) for a in janchors]
        roi_align_window.reset_contract_stats()
        loss, self.parts = tr.detection_loss(model, images, boxes, labels.long(), valid, self.cfg,
                                             anchors, draws)
        loss.backward()
        self.contract = roi_align_window.contract_stats()
        roi_align_window.reset_contract_stats()


_CASES = {}


def loss_case(dtype, backend):
    if (dtype, backend) not in _CASES:
        _CASES[dtype, backend] = LossCase(dtype, backend)
    return _CASES[dtype, backend]


def check_loss_parts(case):
    assert set(case.parts) == set(case.want_parts) - {"loss"}
    for name, value in case.parts.items():
        want = float(case.want_parts[name])
        assert np.isfinite(want) and want > 0
        assert _rel(value, want) <= LOSS_RTOL[case.cfg.compute_dtype], (name, float(value), want)
    # the windowed backend counts its dispatch: the 100 proposals and 20 gt rows
    windowed = case.cfg.roi_backend == "windowed"
    assert case.contract["rois"] == (120 if windowed else 0)


def _cosine(a, b):
    a, b = a.flatten().double(), b.flatten().double()
    return float(a @ b / (a.norm() * b.norm()))


def check_gradients(case):
    want = case.want_grads
    assert {n for n, _ in case.named} == set(want)
    for n, t in case.named:
        assert t.grad.dtype == torch.float32 and torch.isfinite(t.grad).all(), n
    if case.cfg.compute_dtype == "float32":
        for n, t in case.named:
            limit = F32_GRAD_RTOL * max(1.0, float(want[n].abs().max()))
            assert float((t.grad - want[n]).abs().max()) <= limit, n
        return
    got = torch.cat([t.grad.flatten() for _, t in case.named])
    ref = torch.cat([want[n].flatten() for n, _ in case.named])
    assert float((got - ref).norm() / ref.norm()) <= BF16_NORM_RTOL
    for n, t in case.named:
        if float(want[n].abs().max()) == 0:
            continue
        assert _cosine(t.grad, want[n]) >= BF16_MIN_COSINE, n
        limit = BF16_GRAD_RTOL * max(1.0, float(want[n].abs().max()))
        assert float((t.grad - want[n]).abs().max()) <= limit, n


@pytest.mark.parametrize("backend", ["windowed", "auto"])
def test_loss_parts_match_jax(backend):
    check_loss_parts(loss_case("float32", backend))


@pytest.mark.parametrize("backend", ["windowed", "auto"])
def test_every_gradient_matches_jax(backend):
    check_gradients(loss_case("float32", backend))


def detection_sets(root):
    """4 train and 2 dev fixture frames, served from memory."""
    sets = []
    for split, scenes, seed in (("train", 2, 5), ("dev", 1, 6)):
        images_dir, csv_path, frames = write_detection_fixture(root / split, scenes, 2, seed=seed)
        data = DetectionDataset(images_dir, csv_path)
        data.load_image = frames.__getitem__
        sets.append(data)
    return sets


def check_800px_epoch(dtype, tmp_path):
    train, dev = detection_sets(tmp_path / "data")
    cfg = det.DetectorConfig(**TINY_800, compute_dtype=dtype)
    roi_align_window.reset_contract_stats()
    run = train_detector(train, dev, cfg, num_epochs=1, batch_size=2, learning_rate=5e-3,
                         warmup_iters=1, print_step=1, checkpoint_dir=str(tmp_path / "ckpt"),
                         seed=0, device="cpu")
    contract = roi_align_window.contract_stats()
    roi_align_window.reset_contract_stats()
    (epoch,) = run["history"]
    assert len(epoch["train_losses"]) == 2 and np.all(np.isfinite(epoch["train_losses"]))
    assert 0.0 <= epoch["mAP"] <= 1.0
    # two train steps of 2 x (100 proposals + the padded ground truth), one
    # evaluation batch of 8 x 100 proposals (`evaluate_detector` repeats the
    # last of the 2 frames)
    gt_rows = next(train.batches(2))["gt_boxes"].shape[1]
    assert contract["rois"] == 2 * 2 * (100 + gt_rows) + 8 * 100
    assert 0 <= contract["out_of_contract"] <= contract["rois"]
    ckpt = tmp_path / "ckpt"
    for path in [ckpt / "final.npz", *ckpt.glob("best_*.npz")]:
        state = load_params(path)
        assert all(v.dtype == torch.float32 for v in state.values()), path
    meta = json.loads((ckpt / "resume" / "epoch_0001" / "metadata.json").read_text())
    assert meta["epoch"] == 1 and meta["count"] == 2
    assert all(p.dtype == torch.float32 for p in run["model"].parameters())


def test_train_detector_runs_an_800px_epoch(tmp_path):
    check_800px_epoch("float32", tmp_path)
