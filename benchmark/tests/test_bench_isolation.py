"""The benchmark loads neither JAX nor the JAX package, and reads none of
the repository's other benchmark scripts or data."""

import os
import re
import subprocess
import sys
import textwrap

from benchmark import harness

BLOCK = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "orbax"):
            raise ImportError(f"{name} is blocked in this interpreter")
sys.meta_path.insert(0, _Block())
sys.path.insert(0, ROOT)
"""


def test_every_module_imports_without_jax():
    body = """
        import importlib, importlib.util, pathlib
        from benchmark import harness
        bench = harness.BENCH_DIR
        names = 0
        for path in sorted(bench.rglob("*.py")):
            rel = path.relative_to(bench.parent)
            if "tests" in rel.parts:
                continue
            if rel.parts[1] == "metrics" or path.name == "run.py" or path.name == "calibrate.py":
                spec = importlib.util.spec_from_file_location(f"m{names}", path)
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
            else:
                importlib.import_module(".".join(rel.with_suffix("").parts).replace(".__init__", ""))
            names += 1
        # the port's modules that a run imports
        import objectpermanence_tpu_torch.infer.reasoning, objectpermanence_tpu_torch.train.loop
        harness.launch_counters()
        found = sorted({m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
        assert not found, found
        assert harness.leaked_modules() == []
        print(names)
    """
    code = BLOCK.replace("ROOT", repr(str(harness.ROOT))) + textwrap.dedent(body)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=harness.ROOT,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_the_leak_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "objectpermanence_tpu_torch_x", sys)
    assert harness.leaked_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.leaked_modules() == ["jax"]


def test_no_source_reads_the_other_benchmarks():
    pattern = re.compile(r"bench_torch\.py|bench\.py|bench_data/|scripts/")
    for path in harness.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        for line in path.read_text().splitlines():
            if pattern.search(line):
                # a frozen copy names its origin in a docstring or comment only
                assert re.search(r"commit\s+443ce38", path.read_text()), (path, line)
                assert not re.search(r"open\(|load\(|import ", line), (path, line)
