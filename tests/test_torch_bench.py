"""`bench_torch.py`, the port's `bench.py`, on the CPU at a small batch: it
prints one JSON line with `bench.py`'s keys, imports nothing of JAX, and
without `--device cpu` it needs the card and raises."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from torch_lane import ONE_THREAD_ENV

REPO = Path(__file__).resolve().parent.parent
# bench.py's result keys, read from its source (importing it would start JAX)
BENCH_KEYS = re.findall(r'^\s+"(\w+)":', (REPO / "bench.py").read_text().split(
    "print(json.dumps({", 1)[1].split("}))", 1)[0], re.M)


def _bench(*args):
    """bench_torch.py in a fresh interpreter where `import jax` fails, on one
    CPU thread and with no card."""
    code = ("import runpy, sys; sys.modules['jax'] = None; "
            f"sys.argv = ['bench_torch.py', *{list(args)!r}]; "
            "runpy.run_path('bench_torch.py', run_name='__main__'); "
            "assert not [m for m in sys.modules if m.startswith('objectpermanence_tpu.')]")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **ONE_THREAD_ENV})


def test_bench_prints_one_json_line_with_bench_keys_on_cpu():
    assert sorted(BENCH_KEYS) == sorted(["metric", "value", "unit", "vs_baseline", "compute_fps",
                                         "compute_fps_bf16", "link_efficiency", "data"])
    proc = _bench("--device", "cpu", "--batch", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    assert list(result) == BENCH_KEYS
    assert result["metric"] == "opnet_inference_frames_per_sec_per_chip"
    assert result["unit"] == "frames/sec" and result["value"] > 0 and result["compute_fps"] > 0
    assert result["vs_baseline"] == round(result["value"] / 5000.0, 3)
    assert result["compute_fps_bf16"] is None     # bf16 operands exist on the card only
    assert result["data"] == "real:ingest_bench50.npz+opnet_19-08-26_0.514.npz"


def test_bench_needs_the_card_by_default():
    proc = _bench()
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert proc.stdout == ""
