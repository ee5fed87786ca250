"""The port's windowed RoIAlign (K9's function, `ops/roi_align_window.py`)
and the bf16 modes of K7 and K9 against the JAX package's kernels, on the
CPU.

JAX's `roi_align_pallas_windowed` runs in interpret mode, as
`tests/test_pallas_roi_align.py` runs it, and under `jax.jit`, as the
detector runs it: XLA then computes the sample coordinates as a product with
the float32 reciprocal of `pooled` and one fused multiply-add, which the
port copies (eagerly, JAX divides, and a sample can move by an ulp). The
window origins are integers from the same float32 corner, so the taps that
drop are the same on both sides.

- float32, at the JAX tests' rtol 1e-5 / atol 1e-6 (both sides sum the same
  float32 taps in another order): the cases of
  `test_windowed_roi_align_matches_gather`, `_800px_shapes`,
  `_right_edge_small_cc` and `_contract_stats`, with rois in and out of
  contract; the out-of-contract ones differ from the exact RoIAlign.
- The out-of-contract mask equals JAX's `windowed_out_of_contract_mask` bit
  for bit, for 4- and 2-byte features and channel chunks 128 and 4; the
  counters add up as JAX's do.
- bfloat16: JAX's bf16 kernels round their interpolation weights (and K7 its
  first product) to bf16; the port computes float32 from the bf16 values.
  Held at 2e-2, the tolerance of JAX's own bf16 test.
"""

import contextlib
import functools
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import objectpermanence_tpu.ops.pallas_roi_align as pra
from objectpermanence_tpu.models.detector.roi_heads import assign_levels as jax_assign_levels
from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
from objectpermanence_tpu_torch.ops import roi_align_kernel as kernel
from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _jax_windowed(feats, rois, levels, **kwargs):
    """JAX's windowed kernel, jitted, in interpret mode -> (numpy float32,
    JAX's contract counters after this one dispatch)."""
    fn = jax.jit(lambda f, r, l: pra.roi_align_pallas_windowed(f, r, l, ROI_STRIDES, **kwargs))
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    pra.reset_contract_stats()
    try:
        out = fn([jnp.asarray(f) for f in feats], jnp.asarray(rois), jnp.asarray(levels))
        jax.effects_barrier()
        return np.asarray(out, np.float32), pra.contract_stats()
    finally:
        pra.pl.pallas_call = orig
        pra.reset_contract_stats()


def _levels(rois):
    return np.array(jax.vmap(jax_assign_levels)(jnp.asarray(rois)))


def _port_windowed(feats, rois, levels, **kwargs):
    return kernel.roi_align_windowed([torch.from_numpy(f) for f in feats],
                                     torch.from_numpy(rois), torch.from_numpy(levels),
                                     ROI_STRIDES, **kwargs).numpy()


def _port_exact(feats, rois, levels):
    return kernel.roi_align_batched_reference([torch.from_numpy(f) for f in feats],
                                              torch.from_numpy(rois), torch.from_numpy(levels),
                                              ROI_STRIDES).numpy()


def _squares(rng, batch, sizes, per_size, x_max, y_max):
    rois = []
    for _ in range(batch):
        img = []
        for size in sizes:
            for _ in range(per_size):
                x1, y1 = rng.uniform(0, x_max), rng.uniform(0, y_max)
                img.append([x1, y1, x1 + size, y1 + size])
        rois.append(img)
    return np.array(rois, np.float32)


def _case_matches_gather():
    rng = np.random.RandomState(7)
    shapes = [(60, 68), (30, 34), (15, 17), (8, 9)]
    feats = [rng.rand(2, 8, h, w).astype(np.float32) for h, w in shapes]
    return feats, _squares(rng, 2, (20, 80, 200, 420), 3, 100, 80), \
        dict(channel_chunk=4, win=32), dict(r_blk=4)


def _case_800px_shapes():
    rng = np.random.RandomState(8)
    shapes = [(200, 272), (100, 136), (50, 68), (25, 34)]
    feats = [rng.rand(1, 4, h, w).astype(np.float32) for h, w in shapes]
    return feats, _squares(rng, 1, (30, 100, 300, 700), 4, 380, 280), \
        dict(channel_chunk=4, win=48), dict(r_blk=8)


def _case_right_edge_small_cc():
    rng = np.random.RandomState(5)
    shapes = [(64, 128), (32, 64), (16, 32), (8, 16)]
    feats = [rng.rand(1, 4, h, w).astype(np.float32) for h, w in shapes]
    rois = np.array([[[480.0, 240.0, 505.0, 262.0], [495.0, 20.0, 510.0, 40.0],
                      [40.0, 220.0, 70.0, 254.0], [100.0, 100.0, 130.0, 130.0]]], np.float32)
    return feats, rois, dict(channel_chunk=4, win=48), dict(r_blk=4)


def _case_contract_stats():
    """Canonical squares (in contract) and three ~80:1 rois, 500 px wide:
    125 level-0 pixels, far beyond the 64-px window (win 32 widened by the
    chunk-4 x quantum)."""
    rng = np.random.RandomState(9)
    shapes = [(64, 128), (32, 64), (16, 32), (8, 16)]
    feats = [rng.rand(1, 4, h, w).astype(np.float32) for h, w in shapes]
    rois = list(_squares(rng, 1, (24, 90, 220), 3, 40, 30)[0])
    for _ in range(3):
        x1, y1 = rng.uniform(0, 8), rng.uniform(0, 200)
        rois.append([x1, y1, x1 + 500.0, y1 + 6.0])
    return feats, np.array(rois, np.float32)[None], dict(channel_chunk=4, win=32), dict(r_blk=4)


CASES = {"matches_gather": _case_matches_gather, "800px_shapes": _case_800px_shapes,
         "right_edge_small_cc": _case_right_edge_small_cc, "contract_stats": _case_contract_stats}
# rois out of contract per case: only the ~80:1 ones
OUT_OF_CONTRACT = {"matches_gather": 0, "800px_shapes": 0, "right_edge_small_cc": 0,
                   "contract_stats": 3}


@contextlib.contextmanager
def _warns(expected: bool):
    """The contract warning, or no RuntimeWarning at all."""
    if expected:
        with pytest.warns(RuntimeWarning, match="exceed the window contract"):
            yield
    else:
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            yield


def _level_shapes(feats):
    return [(f.shape[2], f.shape[3], float(s)) for f, s in zip(feats, ROI_STRIDES)]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_windowed_matches_jax_windowed_kernel(name):
    feats, rois, options, tiling = CASES[name]()
    levels = _levels(rois)
    want, want_stats = _jax_windowed(feats, rois, levels, **options, **tiling)
    window_lib.reset_contract_stats()
    before = kernel.roi_align_windowed.launches
    with _warns(bool(OUT_OF_CONTRACT[name])):
        got = _port_windowed(feats, rois, levels, **options)
        stats = window_lib.contract_stats()
    assert kernel.roi_align_windowed.launches == before  # the CPU runs the plain version
    assert got.shape == want.shape == rois.shape[:2] + (feats[0].shape[1], 7, 7)
    np.testing.assert_allclose(got, want, **TOL)
    # the counters add up as JAX's
    assert stats == want_stats == {"rois": rois.shape[0] * rois.shape[1],
                                   "out_of_contract": OUT_OF_CONTRACT[name]}
    mask = window_lib.windowed_out_of_contract_mask(
        torch.from_numpy(rois), torch.from_numpy(levels), _level_shapes(feats),
        channels=feats[0].shape[1], **options).numpy()
    exact = _port_exact(feats, rois, levels)
    # in contract: the exact RoIAlign; out of contract: really approximated
    np.testing.assert_allclose(got[~mask], exact[~mask], **TOL)
    for b, n in zip(*np.nonzero(mask)):
        assert not np.allclose(got[b, n], exact[b, n], **TOL)
    window_lib.reset_contract_stats()


@pytest.mark.parametrize("chunk", [128, 4])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_contract_mask_equals_jax_bit_for_bit(itemsize, chunk):
    rng = np.random.RandomState(itemsize * 1000 + chunk)
    shapes = [(200, 272), (100, 136), (50, 68), (25, 34)]
    level_shapes = [(h, w, float(s)) for (h, w), s in zip(shapes, ROI_STRIDES)]
    rois = _squares(rng, 2, (20, 60, 150, 400, 900), 6, 1000, 720)
    # elongated rois of every level, some across the image edge
    for i in range(12):
        x1, y1 = rng.uniform(-40, 900), rng.uniform(-40, 700)
        long_, short = rng.uniform(80, 700), rng.uniform(2, 30)
        rois[i % 2, i] = [x1, y1, x1 + long_, y1 + short] if i % 3 else \
            [x1, y1, x1 + short, y1 + long_]
    levels = _levels(rois)
    channels = 256 if chunk == 128 else 4
    want = np.asarray(jax.jit(lambda r, l: pra.windowed_out_of_contract_mask(
        r, l, level_shapes, channels=channels, itemsize=itemsize, channel_chunk=chunk))(
        jnp.asarray(rois), jnp.asarray(levels)))
    got = window_lib.windowed_out_of_contract_mask(
        torch.from_numpy(rois), torch.from_numpy(levels), level_shapes, channels=channels,
        itemsize=itemsize, channel_chunk=chunk).numpy()
    assert got.dtype == np.bool_ and got.shape == rois.shape[:2]
    np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < want.size


def test_window_quant_matches_jax():
    for itemsize in (4, 2):
        for cc in (128, 64, 32, 4, 3):
            for win in (24, 32, 48):
                assert window_lib.window_quant(itemsize, cc, win) == \
                    pra._window_quant(itemsize, cc, win)
    assert window_lib.Window.of([(200, 272)], 256, 4).size == 56
    assert window_lib.Window.of([(200, 272)], 256, 2).size == 64


def test_counters_accumulate_warn_once_and_switch_off(monkeypatch):
    feats, rois, options, _ = _case_contract_stats()
    levels = _levels(rois)
    window_lib.reset_contract_stats()
    with pytest.warns(RuntimeWarning, match="exceed the window contract"):
        _port_windowed(feats, rois, levels, **options)
        window_lib.contract_stats()
    _port_windowed(feats, rois, levels, **options)
    with warnings.catch_warnings():
        warnings.simplefilter("error")     # warned once already
        assert window_lib.contract_stats() == {"rois": 24, "out_of_contract": 6}
    monkeypatch.setenv("OP_TPU_ROI_CONTRACT_STATS", "0")
    _port_windowed(feats, rois, levels, **options)
    assert window_lib.contract_stats() == {"rois": 24, "out_of_contract": 6}
    window_lib.reset_contract_stats()
    assert window_lib.contract_stats() == {"rois": 0, "out_of_contract": 0}


def _bf16_case():
    """`test_batched_and_windowed_roi_align_bf16`'s inputs."""
    rng = np.random.RandomState(11)
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3)]
    feats32 = [rng.rand(2, 8, h, w).astype(np.float32) for h, w in shapes]
    rois = []
    for _ in range(2):
        xy = rng.uniform(0, 60, (16, 2))
        wh = rng.uniform(1, 40, (16, 2))
        rois.append(np.concatenate([xy, xy + wh], -1))
    return feats32, np.array(rois, np.float32)


def _bf16_torch(feats32):
    return [torch.from_numpy(f).to(torch.bfloat16) for f in feats32]


def test_plain_bf16_modes_match_jax_bf16_kernels():
    feats32, rois = _bf16_case()
    levels = _levels(rois)
    feats16 = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats32]
    orig = pra.pl.pallas_call
    pra.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        want_k7 = np.asarray(jax.jit(lambda f, r, l: pra.roi_align_pallas_batched(
            f, r, l, ROI_STRIDES, channel_chunk=4))(feats16, jnp.asarray(rois),
                                                    jnp.asarray(levels)), np.float32)
        want_k9 = np.asarray(jax.jit(lambda f, r, l: pra.roi_align_pallas_windowed(
            f, r, l, ROI_STRIDES, channel_chunk=4, r_blk=4, win=32))(
            feats16, jnp.asarray(rois), jnp.asarray(levels)), np.float32)
        jax.effects_barrier()
    finally:
        pra.pl.pallas_call = orig
    t16, trois, tlevels = _bf16_torch(feats32), torch.from_numpy(rois), torch.from_numpy(levels)
    got_k7 = kernel.roi_align_batched(t16, trois, tlevels, ROI_STRIDES)
    got_k9 = kernel.roi_align_windowed(t16, trois, tlevels, ROI_STRIDES, channel_chunk=4, win=32)
    assert got_k7.dtype == got_k9.dtype == torch.float32
    np.testing.assert_allclose(got_k7.numpy(), want_k7, **BF16_TOL)
    np.testing.assert_allclose(got_k9.numpy(), want_k9, **BF16_TOL)
    # the plain bf16 mode is the float32 function of the bf16 values
    upcast = [f.float() for f in t16]
    np.testing.assert_array_equal(got_k7.numpy(), kernel.roi_align_batched(
        upcast, trois, tlevels, ROI_STRIDES).numpy())
    window_lib.reset_contract_stats()


def test_bf16_window_is_the_wider_one():
    """The window follows the features' dtype: a roi 60 level-0 px wide
    leaves the 56-px float32 window at C=256 but fits the 64-px bf16 one."""
    rng = np.random.RandomState(2)
    shapes = [(200, 272), (100, 136), (50, 68), (25, 34)]
    feats = [torch.from_numpy(rng.rand(1, 256, h, w).astype(np.float32)) for h, w in shapes]
    rois = torch.tensor([[[40.0, 40.0, 280.0, 52.0]]])           # 60 x 3 px at P2
    levels = torch.zeros((1, 1), dtype=torch.int32)
    window_lib.reset_contract_stats()
    with pytest.warns(RuntimeWarning):
        f32 = kernel.roi_align_windowed(feats, rois, levels, ROI_STRIDES)
        assert window_lib.contract_stats()["out_of_contract"] == 1
    bf16 = kernel.roi_align_windowed([f.to(torch.bfloat16) for f in feats], rois, levels,
                                     ROI_STRIDES)
    assert window_lib.contract_stats() == {"rois": 2, "out_of_contract": 1}
    exact = multilevel_roi_align([f[0].to(torch.bfloat16).float() for f in feats], rois[0],
                                 levels[0], ROI_STRIDES)
    np.testing.assert_array_equal(bf16[0].numpy(), exact.numpy())
    assert not torch.allclose(f32[0], multilevel_roi_align([f[0] for f in feats], rois[0],
                                                           levels[0], ROI_STRIDES))
    window_lib.reset_contract_stats()


@pytest.mark.parametrize("bad", ["mixed_dtype", "float16"])
def test_windowed_wrapper_rejects_what_the_kernel_does_not_take(bad):
    feats = [torch.zeros((1, 8, h, w)) for h, w in [(16, 20), (8, 10), (4, 5), (2, 3)]]
    if bad == "mixed_dtype":
        feats[1] = feats[1].to(torch.bfloat16)
    else:
        feats = [f.half() for f in feats]
    rois = torch.zeros((1, 3, 4))
    with pytest.raises(TypeError):
        kernel.roi_align_windowed(feats, rois, torch.zeros((1, 3), dtype=torch.int32),
                                  ROI_STRIDES)
