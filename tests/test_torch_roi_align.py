"""The port's RoIAlign against the JAX package's, on the CPU.

The plain `roi_align` and `multilevel_roi_align` (`ops/roi_align.py`, the
plain version of the RoIAlign kernel) against JAX's gather path, and
against the Pallas kernels K5 (`roi_align_pallas`), K6
(`roi_align_pallas_tiled`) and K7 (`roi_align_pallas_batched`) run in
interpret mode, as `tests/test_pallas_roi_align.py` runs them. The K5/K6/K7
entry points of the port (`ops/roi_align_kernel.py`) take CPU tensors to
the plain version, so they must equal it exactly.

The features' gradient: autograd through the plain batched RoIAlign, the
autograd Function (`roi_align_trainable`: on the CPU the plain forward and
the plain K8, `roi_align_batched_backward_reference`) and the explicit
plain backward, against `jax.grad` of the vmapped gather and of
interpret-mode `roi_align_pallas_batched` (whose custom VJP is K8), at the
same tolerance.

Tolerance rtol 1e-5 / atol 1e-6, the JAX tests' own: both sides sum the
same float32 taps in another order. That holds because the port places the
samples where XLA does (XLA rounds `y1 + g * roi_h / pooled` as a product
with the reciprocal of `pooled` and one fused multiply-add); with plain
division and separate roundings a sample moves by an ulp, and a
standard-normal feature map then differs by up to 2e-6.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import objectpermanence_tpu.ops.pallas_roi_align as pra
from objectpermanence_tpu.models.detector.roi_heads import assign_levels as jax_assign_levels
from objectpermanence_tpu.ops import roi_align as jax_roi
from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
from objectpermanence_tpu_torch.ops import roi_align_kernel as kernel
from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align, roi_align
from torch_lane import one_torch_thread  # noqa: F401

SHAPES = [(16, 20), (8, 10), (4, 5), (2, 3)]  # P2..P5 of a 64 x 80 image
TOL = dict(rtol=1e-5, atol=1e-6)


def _rois(rng, n):
    """Rois of every size class: under 1 px, across the image edge (and
    beyond [-1, H] entirely), and up to 600 px, so every level is used."""
    rois = []
    for i in range(n):
        kind = i % 6
        if kind == 0:    # below 1 pixel
            x1, y1 = rng.uniform(0, 70), rng.uniform(0, 55)
            rois.append([x1, y1, x1 + rng.uniform(0, 0.9), y1 + rng.uniform(0, 0.9)])
        elif kind == 1:  # across the edge
            x1, y1 = rng.uniform(-30, 10), rng.uniform(40, 70)
            rois.append([x1, y1, x1 + rng.uniform(20, 60), y1 + rng.uniform(10, 40)])
        else:
            size = [20, 80, 200, 600][kind - 2]
            x1, y1 = rng.uniform(-10, 40), rng.uniform(-10, 30)
            rois.append([x1, y1, x1 + size * rng.uniform(0.8, 1.2),
                         y1 + size * rng.uniform(0.8, 1.2)])
    return np.array(rois, np.float32)


def _features(rng, batch=None, channels=8):
    lead = () if batch is None else (batch,)
    return [rng.standard_normal(lead + (channels, h, w)).astype(np.float32) for h, w in SHAPES]


def _interpret(fn, *args, **kwargs):
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return np.asarray(fn(*args, **kwargs))
    finally:
        pra.pl.pallas_call = orig


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_assign_levels_matches_jax():
    rng = np.random.RandomState(0)
    rois = _rois(rng, 60)
    # boxes whose level sits on a power of two of 224 px
    rois[:4] = [[0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448], [0, 0, 0, 0]]
    want = np.asarray(jax_assign_levels(jnp.asarray(rois)))
    got = assign_levels(torch.from_numpy(rois))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(want.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("scale", [0.25, 0.125, 1.0])
def test_single_level_roi_align_matches_jax(scale):
    rng = np.random.RandomState(1)
    feat = rng.standard_normal((8, 16, 20)).astype(np.float32)
    rois = _rois(rng, 24)
    want = np.asarray(jax_roi.roi_align(jnp.asarray(feat), jnp.asarray(rois), scale))
    got = roi_align(torch.from_numpy(feat), torch.from_numpy(rois), scale).numpy()
    assert got.shape == (24, 8, 7, 7)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n", [17, 21, 60])
def test_multilevel_matches_jax_gather(n):
    rng = np.random.RandomState(n)
    feats = _features(rng)
    rois = _rois(rng, n)
    levels = np.array(jax_assign_levels(jnp.asarray(rois)))
    want = np.asarray(jax_roi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                                   jnp.asarray(rois), jnp.asarray(levels),
                                                   ROI_STRIDES))
    got = multilevel_roi_align(_torch(feats), torch.from_numpy(rois), torch.from_numpy(levels),
                               ROI_STRIDES).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(want).max() > 0.1  # the rois do pool real features


@pytest.mark.parametrize("entry,jax_fn", [("roi_align_single", "roi_align_pallas"),
                                          ("roi_align_tiled", "roi_align_pallas_tiled")])
@pytest.mark.parametrize("n", [17, 21])
def test_single_image_entries_match_interpret_pallas(entry, jax_fn, n):
    rng = np.random.RandomState(100 + n)
    feats = _features(rng)
    rois = _rois(rng, n)
    levels = np.array(jax_assign_levels(jnp.asarray(rois)))
    kwargs = {"channel_chunk": 4} if jax_fn == "roi_align_pallas_tiled" else {}
    want = _interpret(getattr(pra, jax_fn), [jnp.asarray(f) for f in feats], jnp.asarray(rois),
                      jnp.asarray(levels), ROI_STRIDES, **kwargs)
    fn = getattr(kernel, entry)
    args = (_torch(feats), torch.from_numpy(rois), torch.from_numpy(levels), ROI_STRIDES)
    before = fn.launches
    got = fn(*args).numpy()
    assert fn.launches == before  # the CPU runs the plain version, no launch
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got, multilevel_roi_align(*args).numpy())


def test_batched_entry_matches_interpret_pallas_and_vmapped_gather():
    rng = np.random.RandomState(3)
    batch, n = 3, 17
    feats = _features(rng, batch)
    rois = np.stack([_rois(rng, n) for _ in range(batch)])
    levels = np.array(jax.vmap(jax_assign_levels)(jnp.asarray(rois)))
    jfeats = [jnp.asarray(f) for f in feats]
    gather = np.asarray(jax.vmap(
        lambda *a: jax_roi.multilevel_roi_align(list(a[:4]), a[4], a[5], ROI_STRIDES))(
        *jfeats, jnp.asarray(rois), jnp.asarray(levels)))
    pallas = _interpret(pra.roi_align_pallas_batched, jfeats, jnp.asarray(rois),
                        jnp.asarray(levels), ROI_STRIDES, channel_chunk=4)
    before = kernel.roi_align_batched.launches
    got = kernel.roi_align_batched(_torch(feats), torch.from_numpy(rois),
                                   torch.from_numpy(levels), ROI_STRIDES).numpy()
    assert kernel.roi_align_batched.launches == before
    assert got.shape == (batch, n, 8, 7, 7)
    np.testing.assert_allclose(got, gather, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    plain = kernel.roi_align_batched_reference(_torch(feats), torch.from_numpy(rois),
                                               torch.from_numpy(levels), ROI_STRIDES)
    np.testing.assert_array_equal(got, plain.numpy())


def test_channels_last_levels_give_the_same_result():
    rng = np.random.RandomState(4)
    feats = _torch(_features(rng, 2))
    rois = torch.from_numpy(np.stack([_rois(rng, 9) for _ in range(2)]))
    levels = assign_levels(rois)
    nhwc = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    np.testing.assert_array_equal(
        kernel.roi_align_batched(nhwc, rois, levels, ROI_STRIDES).numpy(),
        kernel.roi_align_batched(feats, rois, levels, ROI_STRIDES).numpy())


@pytest.mark.parametrize("bad", ["dtype", "levels_shape", "device_mix", "pooled", "strides"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    rng = np.random.RandomState(5)
    feats = _torch(_features(rng, 2))
    rois = torch.from_numpy(np.stack([_rois(rng, 5) for _ in range(2)]))
    levels = assign_levels(rois)
    args = dict(features=feats, rois=rois, levels=levels, strides=ROI_STRIDES)
    if bad == "dtype":
        args["rois"] = rois.double()
    elif bad == "levels_shape":
        args["levels"] = levels[:, :3]
    elif bad == "device_mix":
        args["features"] = feats[:3] + [feats[3].to("meta")]
    elif bad == "pooled":
        args["pooled"] = 40
    else:
        args["strides"] = ROI_STRIDES[:3]
    with pytest.raises((TypeError, ValueError)):
        kernel.roi_align_batched(**args)


def _grad_case(seed, batch=2, n=12):
    rng = np.random.RandomState(seed)
    feats = _features(rng, batch)
    rois = np.stack([_rois(rng, n) for _ in range(batch)])
    levels = np.array(jax.vmap(jax_assign_levels)(jnp.asarray(rois)))
    cot = rng.standard_normal((batch, n, 8, 7, 7)).astype(np.float32)
    return feats, rois, levels, cot


def _jax_feature_grads(feats, rois, levels, cot, pallas: bool):
    rois, levels, cot = jnp.asarray(rois), jnp.asarray(levels), jnp.asarray(cot)

    def loss(fs):
        if pallas:
            out = pra.roi_align_pallas_batched(fs, rois, levels, ROI_STRIDES, channel_chunk=4)
        else:
            out = jax.vmap(lambda *a: jax_roi.multilevel_roi_align(list(a[:4]), a[4], a[5],
                                                                   ROI_STRIDES))(*fs, rois, levels)
        return jnp.sum(out * cot)

    fs = [jnp.asarray(f) for f in feats]
    if not pallas:
        return [np.asarray(g) for g in jax.grad(loss)(fs)]
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        return [np.asarray(g) for g in jax.grad(loss)(fs)]
    finally:
        pra.pl.pallas_call = orig


def _port_feature_grads(fn, feats, rois, levels, cot):
    leaves = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    fn(leaves, torch.from_numpy(rois), torch.from_numpy(levels), ROI_STRIDES).backward(
        torch.from_numpy(cot))
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("seed", [3, 8])
@pytest.mark.parametrize("port", ["plain_autograd", "function"])
@pytest.mark.parametrize("reference", ["gather", "interpret_pallas"])
def test_feature_gradients_match_jax(reference, port, seed):
    feats, rois, levels, cot = _grad_case(seed)
    want = _jax_feature_grads(feats, rois, levels, cot, pallas=reference == "interpret_pallas")
    fn = kernel.roi_align_batched_reference if port == "plain_autograd" else \
        kernel.roi_align_trainable
    before = (kernel.roi_align_batched.launches, kernel.roi_align_batched_backward.launches)
    got = _port_feature_grads(fn, feats, rois, levels, cot)
    assert (kernel.roi_align_batched.launches,
            kernel.roi_align_batched_backward.launches) == before  # no launch on the CPU
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    assert max(np.abs(w).max() for w in want) > 0.1


def test_plain_backward_equals_autograd_and_the_function():
    feats, rois, levels, cot = _grad_case(5, batch=3, n=17)
    autograd = _port_feature_grads(kernel.roi_align_batched_reference, feats, rois, levels, cot)
    function = _port_feature_grads(kernel.roi_align_trainable, feats, rois, levels, cot)
    explicit = kernel.roi_align_batched_backward(
        torch.from_numpy(cot), torch.from_numpy(rois), torch.from_numpy(levels),
        [f.shape[-2:] for f in feats], ROI_STRIDES)
    for a, f, e in zip(autograd, function, explicit):
        assert e.shape == a.shape and e.is_contiguous()
        np.testing.assert_allclose(e.numpy(), a, **TOL)
        np.testing.assert_array_equal(f, e.numpy())


def test_backward_of_an_empty_batch_is_zero():
    feats = [torch.zeros((2, 8, h, w)) for h, w in SHAPES]
    rois = torch.zeros((2, 0, 4))
    levels = torch.zeros((2, 0), dtype=torch.int32)
    before = kernel.roi_align_batched_backward.launches
    grads = kernel.roi_align_batched_backward(torch.zeros((2, 0, 8, 7, 7)), rois, levels, SHAPES,
                                              ROI_STRIDES)
    assert kernel.roi_align_batched_backward.launches == before
    assert [tuple(g.shape) for g in grads] == [tuple(f.shape) for f in feats]
    assert all(not g.any() for g in grads)


@pytest.mark.parametrize("bad", ["dtype", "batch", "shapes"])
def test_backward_rejects_what_the_kernel_does_not_take(bad):
    cot = torch.zeros((2, 5, 8, 7, 7))
    rois = torch.zeros((2, 5, 4))
    levels = torch.zeros((2, 5), dtype=torch.int32)
    shapes = SHAPES
    if bad == "dtype":
        cot = cot.double()
    elif bad == "batch":
        cot = cot[:1]
    else:
        shapes = SHAPES[:3]
    with pytest.raises((TypeError, ValueError)):
        kernel.roi_align_batched_backward(cot, rois, levels, shapes, ROI_STRIDES)
