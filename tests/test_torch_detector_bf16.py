"""The port's bf16 detector (`compute_dtype="bfloat16"`) against the JAX
package's, stage by stage, on the CPU at TINY width
(`tests/test_torch_detector.py`'s reduced config), with frozen BN and with
GroupNorm (the 800 px recipe's norm).

Both keep float32 parameters and cast them to bf16 in the forward; the JAX
weights come across by the weight bridge unchanged. Each stage is fed JAX's
own inputs (its pyramid, its proposals, its pooled rois), so a near tie in
bf16 top-k cannot cascade. Tolerances, relative to the largest reference
value of each tensor: bf16 keeps 8 bits of mantissa (0.4% a rounding), and
the two frameworks round at other places (torch's GroupNorm accumulates in
float32 where JAX rounds mean and variance to bf16; a biased convolution is
one rounding in torch, two in JAX):

- pyramid: 1e-2 with frozen BN (measured 3.4e-3), 5e-2 with GroupNorm
  (measured 2.8e-2);
- RPN objectness and deltas (float32 out of a bf16 head fed JAX's pyramid),
  pooled rois (float32 sums of the same bf16 values, rounded to bf16): 1e-3;
- class logits and box deltas: 1e-2 (measured 3.5e-3).

And every activation of the bf16 forward is bf16 until the heads' float32
outputs, which guards against torch's promotion taking the net back to
float32 at a norm or a bias.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from objectpermanence_tpu.models.detector import detector as jdet
from objectpermanence_tpu.models.detector import roi_heads as jroi
from objectpermanence_tpu.models.detector import rpn as jrpn
from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
from objectpermanence_tpu_torch.models.detector import detector as det
from objectpermanence_tpu_torch.models.detector.convert import state_dict_from_jax
from objectpermanence_tpu_torch.models.detector.roi_heads import RoIHeads
from objectpermanence_tpu_torch.models.detector.rpn import RPNHead
from torch_lane import one_torch_thread  # noqa: F401

TINY = dict(image_hw=(120, 160), min_size=128, max_size=256, backbone_layers=(1, 1, 1, 1),
            backbone_width=16, fpn_channels=32, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=100,
            detections_per_img=20, compute_dtype="bfloat16")
PYRAMID_RTOL = {"frozen": 1e-2, "group": 5e-2}
HEAD_RTOL, ROI_RTOL, LOGIT_RTOL = 1e-3, 1e-3, 1e-2


def _f32(a):
    return np.array(a, np.float32)


def _bf16_nchw(a):
    """A JAX bf16 NHWC array -> a torch bf16 NCHW tensor (exact)."""
    return torch.from_numpy(_f32(a).transpose(0, 3, 1, 2).copy()).to(torch.bfloat16)


def _close_to_max(got, want, rtol):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= rtol * scale, f"max abs err {err} > {rtol} x max |ref| {scale}"


class Case:
    def __init__(self, norm):
        kwargs = dict(TINY, backbone_norm=norm)
        self.jcfg, self.cfg = jdet.DetectorConfig(**kwargs), det.DetectorConfig(**kwargs)
        params = jax.device_get(jdet.detector_init(jax.random.PRNGKey(0), self.jcfg))
        self.detector = det.CaterDetector(
            self.cfg, state_dict=state_dict_from_jax(params, self.cfg.backbone_layers),
            device="cpu")
        frames = np.concatenate([draw_frames(make_scene(s, num_frames=40), s)[[8]]
                                 for s in (3, 4)])
        self.frames = np.ascontiguousarray(frames[:, ::2, ::2])
        cfg = self.jcfg
        anchors = [jnp.asarray(a) for a in jdet.anchor_lib.pyramid_anchors(
            cfg.feature_shapes(), cfg.strides, cfg.anchor_sizes)]
        prepped = jdet.preprocess_images(jnp.asarray(self.frames), cfg)
        pyramid = jax.jit(lambda p, x: jdet.forward_features(p, x, cfg))(params, prepped)
        objectness, deltas = jax.jit(jrpn.rpn_head_apply)(params["rpn"], pyramid)
        proposals, _ = jax.jit(lambda o, d: jrpn.generate_proposals(
            [jax.nn.sigmoid(x) for x in o], d, anchors, cfg.padded_hw, cfg.rpn_pre_nms_top_n,
            cfg.rpn_post_nms_top_n, cfg.rpn_nms_thresh))(objectness, deltas)
        pooled = jdet.batched_roi_align([q.transpose(0, 3, 1, 2) for q in pyramid[:4]],
                                        proposals, cfg)
        logits, box_deltas = jax.jit(jax.vmap(jroi.box_head_apply, (None, 0)))(
            params["box_head"], pooled)
        self.jax = jax.device_get({"prepped": prepped, "pyramid": pyramid,
                                   "objectness": objectness, "deltas": deltas,
                                   "proposals": proposals, "pooled": pooled, "logits": logits,
                                   "box_deltas": box_deltas})
        assert self.jax["pyramid"][0].dtype == jnp.bfloat16
        assert self.jax["pooled"].dtype == jnp.bfloat16


_CASES = {}


@pytest.fixture(scope="module", params=["frozen", "group"])
def case(request):
    if request.param not in _CASES:
        _CASES[request.param] = Case(request.param)
    return _CASES[request.param]


def test_pyramid_matches_jax_bf16(case):
    model = case.detector.model
    with torch.inference_mode():
        prepped = torch.from_numpy(_f32(case.jax["prepped"]).transpose(0, 3, 1, 2).copy())
        got = det.forward_features(model, prepped)
    for level, (g, w) in enumerate(zip(got, case.jax["pyramid"])):
        assert g.dtype == torch.bfloat16
        assert tuple(g.shape[-2:]) == case.cfg.feature_shapes()[level]
        _close_to_max(g.float().numpy(), _f32(w).transpose(0, 3, 1, 2),
                      PYRAMID_RTOL[case.cfg.backbone_norm])


def test_rpn_outputs_match_jax_bf16(case):
    with torch.inference_mode():
        objectness, deltas = case.detector.model.rpn.head(
            [_bf16_nchw(p) for p in case.jax["pyramid"]])
    for got, want in zip(objectness + deltas, case.jax["objectness"] + case.jax["deltas"]):
        assert got.dtype == torch.float32
        _close_to_max(got.numpy(), want, HEAD_RTOL)


def test_pooled_rois_match_jax_bf16(case):
    """JAX's proposals on JAX's bf16 pyramid; on the CPU "auto" is the exact
    plain RoIAlign, as JAX's gather is off the TPU."""
    with torch.inference_mode():
        got = det.batched_roi_align([_bf16_nchw(p) for p in case.jax["pyramid"][:4]],
                                    torch.from_numpy(_f32(case.jax["proposals"])), case.cfg)
    assert got.dtype == torch.bfloat16
    _close_to_max(got.float().numpy(), case.jax["pooled"], ROI_RTOL)


def test_logits_match_jax_bf16(case):
    with torch.inference_mode():
        pooled = torch.from_numpy(_f32(case.jax["pooled"])).to(torch.bfloat16)
        logits, box_deltas = case.detector.model.roi_heads(pooled)
    assert logits.dtype == box_deltas.dtype == torch.float32
    _close_to_max(logits.numpy(), case.jax["logits"], LOGIT_RTOL)
    _close_to_max(box_deltas.numpy(), case.jax["box_deltas"], LOGIT_RTOL)


def test_every_activation_of_the_bf16_forward_is_bf16(case):
    """Hooks on every module of the detector: each output tensor is bf16,
    except the heads' float32 predictions (`RPNHead`, `RoIHeads`). The
    parameters stay float32."""
    model = case.detector.model
    seen, hooks = [], []

    def record(module, _inputs, output):
        outputs = output if isinstance(output, (list, tuple)) else [output]
        flat = [t for o in outputs for t in (o if isinstance(o, (list, tuple)) else [o])]
        seen.append((type(module).__name__, {t.dtype for t in flat}))

    for module in model.modules():
        if module is not model:
            hooks.append(module.register_forward_hook(record))
    try:
        boxes, labels, scores, valid = case.detector(case.frames)
    finally:
        for hook in hooks:
            hook.remove()
    heads = {"RPNHead", "RoIHeads"}
    names = {name for name, _ in seen}
    assert {"Conv2d", "FrozenBatchNorm2d" if case.cfg.backbone_norm == "frozen" else "GroupNorm",
            "Bottleneck", "ResNet", "FPN", "Linear", "TwoMLPHead"} <= names, names
    for name, dtypes in seen:
        assert dtypes == ({torch.float32} if name in heads else {torch.bfloat16}), (name, dtypes)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())
    assert boxes.dtype == scores.dtype == np.float32 and np.isfinite(boxes[valid]).all()


def test_head_modules_emit_float32_from_float32_too():
    """The heads' casts are no-ops in float32: the same classes serve the
    float32 detector."""
    head, rois = RPNHead(8, 3), RoIHeads(8, 7, 16, 5)
    objectness, _ = head([torch.randn(1, 8, 4, 4)])
    logits, _ = rois(torch.randn(2, 8, 7, 7))
    assert objectness[0].dtype == logits.dtype == torch.float32
