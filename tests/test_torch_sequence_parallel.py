"""The port's sequence parallelism (`parallel/sequence.py`) against the JAX
package's (`objectpermanence_tpu/parallel/sequence.py`), at world 4 over
gloo, (data 2, model 2), against JAX's functions on a (2, 2) mesh of the
conftest's virtual CPU devices, same weights (through the weight bridge)
and inputs.

One spawn (`torch_dp_workers.sp_suite`) runs every case; each rank returns
the global result, and each rank's is held at JAX's own limits
(`tests/test_sequence_parallel.py`): the IoU's per-video means at rtol 1e-5,
atol 1e-6, its masked sums at 1e-5, the counts exactly; the OPNet forward
(boxes and logits), the transformer forward and a generic frame-sharded
stage at rtol 2e-5, atol 2e-6 (the stage's per-frame sums at atol 2e-5).
Frames that the model width does not divide, and a batch that the data
width does not divide, raise.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from objectpermanence_tpu.models.registry import get_model_spec as jax_get_model_spec
from objectpermanence_tpu.parallel.mesh import make_mesh as jax_make_mesh
from objectpermanence_tpu.parallel.sequence import (
    frame_sharded as jax_frame_sharded,
    make_sequence_parallel_iou as jax_sp_iou,
    make_sequence_parallel_opnet_forward as jax_sp_opnet,
    make_sequence_parallel_transformer_forward as jax_sp_transformer,
)
from objectpermanence_tpu_torch.models.convert import params_from_jax
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_dp_workers import MP_BATCH, MP_FRAMES, NARROW, TRANSFORMER, mp_batch, sp_suite, start

FORWARD = dict(rtol=2e-5, atol=2e-6)


def _jax_stage(p, boxes, gate):
    feats = jnp.einsum("bfod,dh->bfoh", boxes, p["w"]) + p["b"]
    pooled = jnp.einsum("bfoh,bfo->bfh", jax.nn.relu(feats), jax.nn.softmax(gate, axis=-1))
    return pooled, pooled.sum(-1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sp")
    rng = np.random.RandomState(40)
    boxes, labels, mask = mp_batch(41)
    inputs = {"pred": rng.rand(MP_BATCH, MP_FRAMES, 4).astype(np.float32), "labels": labels,
              "mask": mask, "boxes": boxes,
              "boxes5": rng.rand(MP_BATCH, MP_FRAMES, 15, 5).astype(np.float32),
              "w": rng.randn(6, 10).astype(np.float32), "b": rng.randn(10).astype(np.float32),
              "gate": rng.rand(MP_BATCH, MP_FRAMES, 15).astype(np.float32)}
    np.savez(out / "sp_inputs.npz", **inputs)
    opnet = jax.device_get(jax_get_model_spec("opnet").init(jax.random.PRNGKey(0), NARROW))
    transformer_spec = jax_get_model_spec("transformer_lstm")
    transformer = jax.device_get(transformer_spec.init(jax.random.PRNGKey(1), TRANSFORMER))
    save_params(out / "sp_opnet.npz", params_from_jax(opnet))
    save_params(out / "sp_transformer.npz", params_from_jax(transformer))
    wait = start(sp_suite, 4, out, str(out))
    try:
        mesh = jax_make_mesh(n_data=2, n_model=2)
        want = {}
        want["iou_mean"], want["iou_msum"], want["iou_mcnt"] = jax_sp_iou(mesh)(
            jnp.asarray(inputs["pred"]), jnp.asarray(labels), jnp.asarray(mask))
        want["opnet_y"], want["opnet_logits"] = jax_sp_opnet(mesh)(opnet, jnp.asarray(boxes))
        want["transformer_y"] = jax_sp_transformer(mesh)(transformer,
                                                         jnp.asarray(inputs["boxes5"]))
        want["pooled"], want["pooled_sum"] = jax_frame_sharded(mesh, _jax_stage)(
            {"w": jnp.asarray(inputs["w"]), "b": jnp.asarray(inputs["b"])},
            jnp.asarray(boxes), jnp.asarray(inputs["gate"]))
        want = {k: np.asarray(v) for k, v in want.items()}
    finally:
        wait()
    ranks = []
    for rank in range(4):
        with np.load(out / f"sp_rank{rank}.npz") as blob:
            got = {k: blob[k] for k in blob.files}
        ranks.append((got, json.loads((out / f"sp_rank{rank}.json").read_text())))
    return ranks, want


@pytest.mark.parametrize("rank", range(4))
def test_sp_iou_matches_jax(runs, rank):
    got, want = runs[0][rank][0], runs[1]
    np.testing.assert_allclose(got["iou_mean"], want["iou_mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["iou_msum"], want["iou_msum"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got["iou_mcnt"], want["iou_mcnt"])


@pytest.mark.parametrize("rank", range(4))
def test_sp_opnet_forward_matches_jax(runs, rank):
    got, want = runs[0][rank][0], runs[1]
    assert got["opnet_y"].shape == (MP_BATCH, MP_FRAMES, 4)
    assert got["opnet_logits"].shape == (MP_BATCH, 15, MP_FRAMES)
    np.testing.assert_allclose(got["opnet_y"], want["opnet_y"], **FORWARD)
    np.testing.assert_allclose(got["opnet_logits"], want["opnet_logits"], **FORWARD)


@pytest.mark.parametrize("rank", range(4))
def test_sp_transformer_forward_matches_jax(runs, rank):
    got, want = runs[0][rank][0], runs[1]
    np.testing.assert_allclose(got["transformer_y"], want["transformer_y"], **FORWARD)


@pytest.mark.parametrize("rank", range(4))
def test_frame_sharded_generic_stage_matches_jax(runs, rank):
    got, want = runs[0][rank][0], runs[1]
    np.testing.assert_allclose(got["pooled"], want["pooled"], **FORWARD)
    np.testing.assert_allclose(got["pooled_sum"], want["pooled_sum"], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("what", ["frames", "batch"])
def test_sp_raises_when_the_mesh_does_not_divide(runs, what):
    for _, raised in runs[0]:
        assert raised[what] is not None and "does not divide" in raised[what], raised
