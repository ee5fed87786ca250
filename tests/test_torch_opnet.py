"""The port's OPNet forward against the JAX package's `opnet_apply`.

Both the module's plain composition and `opnet_fused_forward` on CPU
tensors (which runs its step loop, `opnet_forward_reference`) are held
against `opnet_apply`, at narrow widths and at the flagship's full width
on real served boxes. Tolerance atol 1e-5 on `y`: float32 on both sides,
the same arithmetic, sums in another order; over 300 steps the
recurrences stay contractive, so the gap stays near 1e-6. The flagship's
logits reach magnitude 13, where float32 resolves about 1e-6, so they are
held at atol 1e-5 plus rtol 2e-6 (measured worst case: rtol 1.01e-6).

Integer pixel boxes are held against the JAX `make_predict_step`, which
takes its XLA branch on the CPU: truncation can flip one pixel where the
float lies within rounding of an integer, so at most 1 px apart on at most
0.1% of the coordinates.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from objectpermanence_tpu.infer.reasoning import make_predict_step as jax_make_predict_step
from objectpermanence_tpu.models.reasoning import opnet_apply
from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.models.reasoning import OPNet
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward
from objectpermanence_tpu_torch.utils.checkpoint import load_params
from torch_lane import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FLAGSHIP_NPZ = REPO / "objectpermanence_tpu_torch" / "assets" / "opnet_19-08-26_0.514.npz"
BENCH_CACHE = REPO / "bench_data" / "cache" / "ingest_bench50.npz"
FULL = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 256,
        "videos_hidden_dim": 512}
NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 32,
          "videos_hidden_dim": 64}
ATOL = 1e-5
LOGITS_RTOL = 2e-6


def _random_params(config, seed):
    """OPNet pytree (numpy) with torch-style U(-k, k) weights."""
    rng = np.random.RandomState(seed)
    h1, h2, out = (config["object_to_track_hidden_dim"], config["videos_hidden_dim"],
                   config["object_to_track_pred_dim"])

    def u(shape, fan):
        k = 1.0 / np.sqrt(fan)
        return rng.uniform(-k, k, shape).astype(np.float32)

    return {"att_lstm": {"w_ih": u((90, 4 * h1), h1), "w_hh": u((h1, 4 * h1), h1)},
            "att_head": {"w": u((h1, out), h1)},
            "video_lstm": {"w_ih": u((6, 4 * h2), h2), "w_hh": u((h2, 4 * h2), h2)},
            "box_head": {"w": u((h2, 4), h2)}}


def _random_boxes(seed, batch, seq_len):
    """Boxes shaped like ingested ones: coordinates in [0, 1], visible and
    cone bits in {0, 1}."""
    rng = np.random.RandomState(seed)
    boxes = rng.uniform(0, 1, (batch, seq_len, 15, 6)).astype(np.float32)
    boxes[..., 4:] = (boxes[..., 4:] > 0.5)
    return boxes


def _bench_boxes(count=8):
    with np.load(BENCH_CACHE) as blob:
        return blob["boxes"][:count].astype(np.float32)


def _flagship():
    return {k: v.numpy() for k, v in load_params(FLAGSHIP_NPZ).items()}


def _unflatten(flat):
    out = {}
    for key, value in flat.items():
        layer, leaf = key.split(".")
        out.setdefault(layer, {})[leaf] = value
    return out


def _model(config, params):
    model = OPNet(config)
    model.load_state_dict(params_from_jax(params))
    return model.eval()


def _port_forward(path, config, params, boxes):
    boxes_t = torch.from_numpy(boxes)
    with torch.no_grad():
        if path == "module":
            y, logits = _model(config, params)(boxes_t)
        else:
            state = params_from_jax(params)
            y, logits = opnet_fused_forward(
                boxes_t, state["att_lstm.w_ih"], state["att_lstm.w_hh"], state["att_head.w"],
                state["video_lstm.w_ih"], state["video_lstm.w_hh"], state["box_head.w"])
    return y.numpy(), logits.numpy()


@pytest.mark.parametrize("path", ["module", "fused_cpu"])
@pytest.mark.parametrize("seed", [0, 1])
def test_opnet_narrow_matches_opnet_apply(path, seed):
    params = _random_params(NARROW, seed)
    boxes = _random_boxes(seed + 10, batch=3, seq_len=20)
    want_y, want_logits = (np.asarray(a) for a in opnet_apply(params, boxes))
    y, logits = _port_forward(path, NARROW, params, boxes)
    assert y.shape == (3, 20, 4) and logits.shape == (3, 15, 20)
    np.testing.assert_allclose(y, want_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits, want_logits, rtol=LOGITS_RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["module", "fused_cpu"])
def test_opnet_full_width_flagship_matches_opnet_apply(path):
    params = _unflatten(_flagship())
    boxes = _bench_boxes()
    want_y, want_logits = (np.asarray(a) for a in opnet_apply(params, boxes))
    y, logits = _port_forward(path, FULL, params, boxes)
    assert y.shape == (8, 300, 4) and logits.shape == (8, 15, 300)
    np.testing.assert_allclose(y, want_y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(logits, want_logits, rtol=LOGITS_RTOL, atol=ATOL)


@pytest.mark.parametrize("out_dtype", ["int32", "int16"])
def test_pixel_boxes_match_jax_predict_step(out_dtype):
    params = _unflatten(_flagship())
    boxes = _bench_boxes()
    jax_step = jax_make_predict_step(jax_get_model_spec("opnet"), out_dtype=np.dtype(out_dtype))
    want = np.asarray(jax_step(jax.tree.map(jax.numpy.asarray, params), boxes))
    step = make_predict_step(get_model_spec("opnet"), device="cpu",
                             out_dtype=getattr(torch, out_dtype))
    got = step(_model(FULL, params), boxes).numpy()
    assert got.dtype == want.dtype == np.dtype(out_dtype)
    assert got.shape == want.shape == (8, 300, 4)
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def test_cpu_path_counts_no_launch():
    params = _random_params(NARROW, 5)
    before = opnet_fused_forward.launches
    _port_forward("fused_cpu", NARROW, params, _random_boxes(6, 2, 4))
    assert opnet_fused_forward.launches == before


def _weights(config=NARROW):
    state = params_from_jax(_random_params(config, 7))
    return [state[k] for k in ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w",
                               "video_lstm.w_ih", "video_lstm.w_hh", "box_head.w")]


@pytest.mark.parametrize("case", ["wrong_features", "float64", "non_contiguous",
                                  "not_4d", "weight_shape", "numpy_input"])
def test_fused_forward_refuses_what_the_kernel_does_not_take(case):
    boxes = torch.from_numpy(_random_boxes(8, 2, 5))
    weights = _weights()
    error = ValueError
    if case == "wrong_features":
        boxes = boxes[..., :5].contiguous()
    elif case == "float64":
        boxes, error = boxes.double(), TypeError
    elif case == "non_contiguous":
        boxes = boxes.transpose(0, 1)
    elif case == "not_4d":
        boxes = boxes.reshape(2, 5, 90)
    elif case == "weight_shape":
        weights[1] = weights[1][:, :-4].contiguous()
    elif case == "numpy_input":
        boxes, error = boxes.numpy(), TypeError
    with pytest.raises(error):
        opnet_fused_forward(boxes, *weights)
