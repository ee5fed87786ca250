"""The benchmark's own tests, on the CPU (those marked `gpu` skip without a
card):

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

# small sizes of the cells, for runs on the CPU; the transformer's
# feed-forward stays 2048 wide, which the port fixes
TINY_CONFIGS = {
    "opnet": {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
              "videos_hidden_dim": 24},
    "transformer_lstm": {"boxes_features_dim": 16, "num_attention_heads": 2,
                         "num_attention_layers": 2, "num_lstm_layers": 2,
                         "lstm_hidden_dim": 24, "ff_dim": 2048},
}
TINY_MIXES = {
    "serve": {"kind": "serve", "videos": 4, "frames": 12, "depth": 2, "pool": 2, "warmup": 1,
              "checked": 3, "trace_calls": 3, "reference_rows": 2},
    "train": {"kind": "train", "videos": 4, "frames": 12, "learning_rate": 1e-3,
              "checked_steps": 3, "schedule": 8, "trace_calls": 3},
}


@pytest.fixture
def manifest():
    from benchmark import harness
    return harness.load_json(harness.MANIFEST)


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
