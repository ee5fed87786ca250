"""RoIAlign's gradient for bfloat16 features (K8's bf16 mode) and the
windowed RoIAlign's autograd Function (`roi_align_windowed_trainable`, K9
forward and K8 backward) against the JAX package's, on the CPU.

K8 sums the float32 cotangent with float32 interpolation weights into
float32 buffers and rounds dF to bf16 once. Its plain version, which a CPU
tensor runs, is the float32 backward cast to bf16, so the bf16 mode equals
the float32 mode rounded, bit for bit. JAX's versions round earlier:

- JAX's interpret-mode K8 (`_pallas_roi_align_tiled_batched_bwd` under
  `_tiled_batched_diff`, reached by differentiating
  `roi_align_pallas_batched` on bf16 features) rounds its interpolation
  weights and its first product to bf16. This is the deliberate difference
  of the port; measured at these shapes it is at most 4.5e-3 x max |ref|
  per level, held at 1e-2 x max |ref| (JAX's own bf16 RoIAlign tests allow
  2e-2).
- JAX's gather VJP on bf16 features (the backward of its `"auto"` path on
  the CPU, and of its windowed trainable) rounds each tap's share to bf16
  and adds them in bf16; measured 5.5e-3 x max |ref|, held at 1e-2. On the
  same values in float32, rounded to bf16 once, it is the port's function:
  held within one bf16 ulp of max |ref| (its float32 sums run in another
  order, which can move a rounding by one ulp).

The windowed trainable against JAX's (interpret mode, channel chunk 4,
window 32 as `tests/test_torch_roi_align_window.py` runs it), on squares
in contract and one 500 x 6 px roi out of it: forwards at that file's
tolerances (float32 1e-5, bf16 2e-2), gradients as above (float32 at rtol
1e-5 of max |ref|: both sum float32 in another order). JAX's mismatch is
kept: the forward drops the long roi's out-of-window taps and the backward
keeps them, so the backward is the exact RoIAlign's transpose, which the
forward's is for the rois in contract only.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import objectpermanence_tpu.ops.pallas_roi_align as pra
from objectpermanence_tpu.models.detector.roi_heads import assign_levels as jax_assign_levels
from objectpermanence_tpu.ops.roi_align import multilevel_roi_align as jax_multilevel_roi_align
from objectpermanence_tpu_torch.models.detector import detector as det
from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
from objectpermanence_tpu_torch.ops import roi_align_window as window_lib

BF16_GRAD_RTOL = 1e-2   # x max |ref| per level: JAX rounds weights or shares to bf16
F32_GRAD_RTOL = 1e-5    # x max |ref| per level: float32 sums in another order
TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
SHAPES = [(16, 20), (8, 10), (4, 5), (2, 3)]
WINDOW_SHAPES = [(64, 128), (32, 64), (16, 32), (8, 16)]
WINDOW = dict(channel_chunk=4, win=32)


@contextlib.contextmanager
def _interpret():
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pra.pl.pallas_call = orig


def _levels(rois):
    return np.array(jax.vmap(jax_assign_levels)(jnp.asarray(rois)))


def _k8_case():
    """Two images, 8 channels, the small pyramid of JAX's bf16 RoIAlign test,
    16 squares of 20-500 px per image (overlapping, so taps are shared),
    a normal cotangent."""
    rng = np.random.RandomState(11)
    feats = [rng.rand(2, 8, h, w).astype(np.float32) for h, w in SHAPES]
    rois = []
    for _ in range(2):
        sizes = rng.choice([20, 80, 200, 500], 16)
        corners = rng.uniform(0, 1, (16, 2)) * [40, 30]
        rois.append(np.concatenate([corners, corners + sizes[:, None]], 1))
    rois = np.array(rois, np.float32)
    grad = rng.standard_normal((2, 16, 8, 7, 7)).astype(np.float32)
    return feats, rois, _levels(rois), grad


def _jax_vjp(forward, feats, grad):
    _, vjp = jax.vjp(forward, feats)
    return [np.array(d, np.float32) for d in vjp(jnp.asarray(grad))[0]]


def _jax_gather(feats, rois, levels):
    return jax.vmap(lambda *a: jax_multilevel_roi_align(list(a[:4]), a[4], a[5], ROI_STRIDES))(
        *feats, jnp.asarray(rois), jnp.asarray(levels))


def _port_k8(grad, rois, levels, dtype):
    before = rk.roi_align_batched_backward.launches
    out = rk.roi_align_batched_backward(torch.from_numpy(grad), torch.from_numpy(rois),
                                        torch.from_numpy(levels), SHAPES, ROI_STRIDES,
                                        dtype=dtype)
    assert rk.roi_align_batched_backward.launches == before  # the CPU runs the plain version
    assert all(d.dtype == dtype and d.is_contiguous() for d in out)
    return out


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def _assert_levels_close(got, want, rtol):
    for level, (g, w) in enumerate(zip(got, want)):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else g
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rtol * max(scale, 1e-30), (level, err, scale)


def test_k8_bf16_is_the_float32_backward_rounded_once():
    _, rois, levels, grad = _k8_case()
    bf16 = _port_k8(grad, rois, levels, torch.bfloat16)
    f32 = _port_k8(grad, rois, levels, torch.float32)
    for b, f in zip(bf16, f32):
        assert torch.equal(b, f.to(torch.bfloat16))
    assert sum(int((f != 0).sum()) for f in f32) > 0


def test_k8_bf16_plain_against_jax_interpret_kernel():
    """The deliberate difference: JAX's bf16 K8 rounds its weights and its
    first product to bf16, the port does not."""
    feats, rois, levels, grad = _k8_case()
    with _interpret():
        want = _jax_vjp(lambda fs: pra.roi_align_pallas_batched(
            fs, jnp.asarray(rois), jnp.asarray(levels), ROI_STRIDES, channel_chunk=4),
            [jnp.asarray(f, jnp.bfloat16) for f in feats], grad)
    got = _port_k8(grad, rois, levels, torch.bfloat16)
    _assert_levels_close(got, want, BF16_GRAD_RTOL)


@pytest.mark.parametrize("jax_features", ["bfloat16", "float32_rounded_once"])
def test_k8_bf16_plain_against_jax_gather_vjp(jax_features):
    feats, rois, levels, grad = _k8_case()
    got = _port_k8(grad, rois, levels, torch.bfloat16)
    dtype = jnp.bfloat16 if jax_features == "bfloat16" else jnp.float32
    want = _jax_vjp(lambda fs: _jax_gather(fs, rois, levels),
                    [jnp.asarray(f, dtype) for f in feats], grad)
    if jax_features == "bfloat16":
        _assert_levels_close(got, want, BF16_GRAD_RTOL)
        return
    for g, w in zip(got, want):
        w16 = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        scale = float(np.abs(w16).max())
        assert scale == 0 or float(np.abs(g.float().numpy() - w16).max()) <= _bf16_ulp(scale)


def _window_case():
    """JAX's contract case (`tests/test_torch_roi_align_window.py`): nine
    squares in contract and one 500 x 6 px roi (125 level-0 pixels, beyond
    the 64 px window of chunk 4), on one image of 4 channels."""
    rng = np.random.RandomState(9)
    feats = [rng.rand(1, 4, h, w).astype(np.float32) for h, w in WINDOW_SHAPES]
    rois = []
    for size in (24, 90, 220):
        for _ in range(3):
            x1, y1 = rng.uniform(0, 40), rng.uniform(0, 30)
            rois.append([x1, y1, x1 + size, y1 + size])
    x1, y1 = rng.uniform(0, 8), rng.uniform(0, 200)
    rois.append([x1, y1, x1 + 500.0, y1 + 6.0])
    rois = np.array(rois, np.float32)[None]
    grad = rng.standard_normal((1, len(rois[0]), 4, 7, 7)).astype(np.float32)
    return feats, rois, _levels(rois), grad


def _port_windowed_trainable(feats, rois, levels, dtype, grad, fn=None):
    fn = fn or functools.partial(rk.roi_align_windowed_trainable, **WINDOW)
    leaves = [torch.from_numpy(f).to(dtype).requires_grad_(True) for f in feats]
    out = fn(leaves, torch.from_numpy(rois), torch.from_numpy(levels), ROI_STRIDES)
    out.backward(torch.from_numpy(grad))
    return out.detach(), [leaf.grad for leaf in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_trainable_matches_jax(dtype):
    feats, rois, levels, grad = _window_case()
    jdtype, tdtype = getattr(jnp, dtype), getattr(torch, dtype)
    pra.reset_contract_stats()
    with _interpret():
        out, vjp = jax.vjp(lambda fs: pra.roi_align_windowed_trainable(
            fs, jnp.asarray(rois), jnp.asarray(levels), ROI_STRIDES, r_blk=4, **WINDOW),
            [jnp.asarray(f, jdtype) for f in feats])
        want_grads = [np.asarray(d, np.float32) for d in vjp(jnp.asarray(grad))[0]]
        want = np.asarray(out, np.float32)
        jax.effects_barrier()
    want_stats = pra.contract_stats()
    pra.reset_contract_stats()
    window_lib.reset_contract_stats()
    got, grads = _port_windowed_trainable(feats, rois, levels, tdtype, grad)
    assert window_lib.contract_stats() == want_stats == {"rois": 10, "out_of_contract": 1}
    window_lib.reset_contract_stats()
    assert got.dtype == torch.float32 and all(g.dtype == tdtype for g in grads)
    np.testing.assert_allclose(got.numpy(), want, **(TOL if dtype == "float32" else BF16_TOL))
    _assert_levels_close(grads, want_grads,
                         F32_GRAD_RTOL if dtype == "float32" else BF16_GRAD_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_backward_is_the_exact_backward(dtype):
    """The backward keeps the taps the forward drops: it is the exact
    RoIAlign's (`roi_align_trainable`'s) bit for bit, while the forward is
    the exact one's only on the rois in contract."""
    feats, rois, levels, grad = _window_case()
    tdtype = getattr(torch, dtype)
    out, grads = _port_windowed_trainable(feats, rois, levels, tdtype, grad)
    exact_out, exact_grads = _port_windowed_trainable(feats, rois, levels, tdtype, grad,
                                                      rk.roi_align_trainable)
    window_lib.reset_contract_stats()
    for g, e in zip(grads, exact_grads):
        assert torch.equal(g, e)
    np.testing.assert_allclose(out[0, :9].numpy(), exact_out[0, :9].numpy(), **TOL)
    assert not np.allclose(out[0, 9].numpy(), exact_out[0, 9].numpy(), **TOL)


def test_windowed_backward_is_its_forwards_transpose_in_contract_only():
    """<F, dF(g)> = <forward(F), g> for a cotangent on the nine squares, and
    not for one on the long roi (float32: the pairing holds to 1e-5)."""
    feats, rois, levels, grad = _window_case()
    features = [torch.from_numpy(f) for f in feats]
    for rows, holds in ((slice(0, 9), True), (slice(9, 10), False)):
        cot = np.zeros_like(grad)
        cot[0, rows] = grad[0, rows]
        out, grads = _port_windowed_trainable(feats, rois, levels, torch.float32, cot)
        window_lib.reset_contract_stats()
        lhs = sum(float((f.double() * g.double()).sum()) for f, g in zip(features, grads))
        rhs = float((out.double() * torch.from_numpy(cot).double()).sum())
        assert (abs(lhs - rhs) <= 1e-5 * abs(rhs)) == holds, (lhs, rhs)


def _bf16_pyramid(cfg):
    """fp32 masters of a 4-level bf16 pyramid, cast as the layers cast
    their parameters, so the gradient reaches the masters through the cast."""
    gen = torch.Generator().manual_seed(0)
    masters = [torch.randn((1, 32, h, w), generator=gen).requires_grad_(True)
               for h, w in cfg.feature_shapes()[:4]]
    pyramid = [m.to(torch.bfloat16) for m in masters]
    for p in pyramid:
        p.retain_grad()
    return masters, pyramid


@pytest.mark.parametrize("entry", ["check_supported", "batched_roi_align", "roi_align_trainable",
                                   "roi_align_windowed_trainable"])
def test_former_refusals_now_return_bf16_grads_to_fp32_masters(entry):
    """What raised before: the config check, the RoIAlign dispatch with a
    gradient recorded and the autograd Function, for bf16 features (and the
    windowed backend, through `check_supported`'s config). dF comes back in
    bf16, and the masters' gradients in float32, equal to it."""
    backend = "windowed" if entry in ("check_supported", "roi_align_windowed_trainable") else "auto"
    cfg = det.DetectorConfig(min_size=128, max_size=256, image_hw=(120, 160), fpn_channels=32,
                             compute_dtype="bfloat16", roi_backend=backend)
    masters, pyramid = _bf16_pyramid(cfg)
    rois = torch.tensor([[[4.0, 4.0, 40.0, 40.0], [10.0, 20.0, 200.0, 120.0]]])
    levels = torch.zeros((1, 2), dtype=torch.int32)
    window_lib.reset_contract_stats()
    if entry in ("check_supported", "batched_roi_align"):
        det.check_supported(cfg)
        out = det.batched_roi_align(pyramid, rois, cfg)
        assert out.dtype == torch.bfloat16
    else:
        out = getattr(rk, entry)(pyramid, rois, levels, ROI_STRIDES)
        assert out.dtype == torch.float32
    out.float().sum().backward()
    window_lib.reset_contract_stats()
    for p, m in zip(pyramid, masters):
        assert p.grad.dtype == torch.bfloat16 and m.grad.dtype == torch.float32
        assert torch.equal(m.grad, p.grad.float())
    assert float(masters[0].grad.abs().sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_k8_refuses_another_gradient_dtype(dtype):
    _, rois, levels, grad = _k8_case()
    with pytest.raises(TypeError, match="dtype"):
        rk.roi_align_batched_backward(torch.from_numpy(grad), torch.from_numpy(rois),
                                      torch.from_numpy(levels), SHAPES, ROI_STRIDES, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 4, 6, 8), (3, 1, 1, 16)])
def test_nchw_copy_is_one_contiguous_copy_in_the_dtype(shape, dtype):
    """K8's NHWC float32 buffers leave as contiguous NCHW in dF's dtype, for
    every level shape (a 1 x 1 level and a single image included)."""
    nhwc = torch.randn(shape, generator=torch.Generator().manual_seed(0))
    out = rk.nchw_copy(nhwc, dtype)
    assert out.dtype == dtype and out.is_contiguous() and out.data_ptr() != nhwc.data_ptr()
    assert out.shape == (shape[0], shape[3], shape[1], shape[2])
    assert torch.equal(out, nhwc.permute(0, 3, 1, 2).to(dtype))
