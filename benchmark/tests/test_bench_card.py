"""On the card: one short run of each cell from a fresh process, correct,
with the launch proof on standard error. Skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["opnet.serve_b512", "transformer_lstm.train_b16",
                                  "transformer_lstm.serve_b512"])
def test_a_short_run_is_correct(cuda_card, manifest, cell):
    if cell not in {c["name"] for c in manifest["workloads"]}:
        pytest.skip(f"{cell} is not in the manifest")
    proc = subprocess.run([sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", cell,
                           "--seed", "2147483777", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert "the window ran the port kernels" in proc.stderr
