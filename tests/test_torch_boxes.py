"""The port's box geometry against `objectpermanence_tpu/ops/boxes.py`.

Integer pixels must be equal: the product is taken in float32, as the JAX
package takes it on the device (`make_predict_step`), then truncated toward
zero. IoU of integer boxes in float64 as numpy computes it, of float32
boxes in float32: atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectpermanence_tpu.ops.boxes import FRAME_SHAPES as JAX_FRAME_SHAPES
from objectpermanence_tpu.ops.boxes import denormalize_boxes as jax_denormalize_boxes
from objectpermanence_tpu.ops.boxes import iou_xyxy as jax_iou_xyxy
from objectpermanence_tpu_torch.ops.boxes import FRAME_SHAPES, denormalize_boxes, iou_xyxy


def _boxes(rng, count):
    x1 = rng.uniform(-10, 300, count)
    y1 = rng.uniform(-10, 220, count)
    return np.stack([x1, y1, x1 + rng.uniform(0, 60, count), y1 + rng.uniform(0, 60, count)], -1)


def test_denormalize_matches_jax_device_path():
    rng = np.random.RandomState(0)
    normalized = rng.uniform(-0.2, 1.2, (50, 300, 4)).astype(np.float32)
    want = np.asarray(jax_denormalize_boxes(jnp.asarray(normalized)))
    got = denormalize_boxes(torch.from_numpy(normalized)).numpy()
    assert np.array_equal(FRAME_SHAPES, JAX_FRAME_SHAPES)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert denormalize_boxes(torch.from_numpy(normalized), torch.int16).dtype == torch.int16


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_iou_matches_jax_package(dtype):
    rng = np.random.RandomState(1)
    a, b = _boxes(rng, 400).astype(dtype), _boxes(rng, 400).astype(dtype)
    b[:50] = a[:50]  # identical boxes: IoU 1
    want = jax_iou_xyxy(a, b)
    got = iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:50], 1.0)
