"""The port's 800 px detector training in bf16 against the JAX package's
(`--compute-dtype bfloat16` of its `train800` recipe), on the CPU: the
cases and checks of `tests/test_torch_detector_train_800.py` (TINY width,
one frame, windowed and `"auto"`), with bf16's tolerances.

Both sides round every activation to bf16, at different places (each
library's bf16 convolutions, GroupNorm and RoIAlign round differently), so
they agree as far as bf16 lets two runs agree:
- the loss parts within 2e-2 relative (measured 8.1e-3, the classifier's);
- the whole gradient (every tensor, concatenated) within 0.1 of JAX's in
  norm, relative (measured 4.9%; JAX's bf16 gradient is 5.1% from its
  float32 one, the port's 4.0%);
- each tensor's cosine with JAX's at least 0.9 (measured 0.925 and up, the
  stem's GroupNorm) and its largest difference within 0.3 x max(1, max
  |JAX's|) (measured 0.26, layer1's conv3: the backbone's weight gradients
  sum 10^5 bf16-rounded terms that mostly cancel).
The gradients reach the float32 masters in float32, and a `train_detector`
epoch keeps float32 masters in its checkpoints.
"""

import pytest

from test_torch_detector_train_800 import (
    check_800px_epoch, check_gradients, check_loss_parts, loss_case,
)
from torch_lane import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("backend", ["windowed", "auto"])
def test_loss_parts_match_jax(backend):
    check_loss_parts(loss_case("bfloat16", backend))


@pytest.mark.parametrize("backend", ["windowed", "auto"])
def test_every_gradient_matches_jax(backend):
    check_gradients(loss_case("bfloat16", backend))


def test_train_detector_runs_an_800px_epoch(tmp_path):
    check_800px_epoch("bfloat16", tmp_path)
