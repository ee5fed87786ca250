"""Every port test file runs torch on one thread through `torch_lane.py`, and
no other file decides the count (read with `ast`).

- A file whose own imports load torch (torch, the port, or a test module
  that does) imports `one_torch_thread` at its top level. The exception is
  `test_torch_kernels_gpu.py`: every test there is marked `gpu` and runs only
  on the card, where no other worker shares the host.
- No file but `torch_lane.py` and `torch_dp_workers.py` (whose spawned ranks
  import neither pytest nor `torch_lane`) reads or sets a thread count of
  torch's, or spells a key of `ONE_THREAD_ENV`.
"""

import ast
from functools import cache
from pathlib import Path

from torch_lane import ONE_THREAD_ENV

TESTS = Path(__file__).resolve().parent
GPU_ONLY = "test_torch_kernels_gpu.py"
DECIDES = {"torch_lane.py", "torch_dp_workers.py"}


@cache
def _tree(name):
    return ast.parse((TESTS / name).read_text())


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@cache
def _loads_torch(name):
    for module in _imported(_tree(name)):
        top = module.split(".")[0]
        if top in ("torch", "objectpermanence_tpu_torch"):
            return True
        if top != "torch_lane" and (TESTS / f"{top}.py").exists() and _loads_torch(f"{top}.py"):
            return True
    return False


def _takes_fixture(tree):
    return any(isinstance(node, ast.ImportFrom) and node.module == "torch_lane"
               and "one_torch_thread" in {alias.name for alias in node.names}
               for node in tree.body)


def _all_gpu(tree):
    def marked(fn):
        return any(isinstance(d, ast.Attribute) and d.attr == "gpu" for d in fn.decorator_list)
    tests = [node for node in tree.body
             if isinstance(node, ast.FunctionDef) and node.name.startswith("test_")]
    return bool(tests) and all(marked(fn) for fn in tests)


def _decides_threads(tree):
    return any((isinstance(node, ast.Attribute) and node.attr.endswith("_threads"))
               or (isinstance(node, ast.Constant) and node.value in ONE_THREAD_ENV)
               for node in ast.walk(tree))


def test_every_port_test_file_takes_the_one_thread_policy():
    names = sorted(p.name for p in TESTS.glob("test_torch_*.py"))
    assert _all_gpu(_tree(GPU_ONLY))
    missing = [name for name in names
               if name != GPU_ONLY and _loads_torch(name) and not _takes_fixture(_tree(name))]
    assert not missing, f"import one_torch_thread from torch_lane in {missing}"
    helpers = sorted(p.name for p in TESTS.glob("torch_*.py"))
    deciding = [name for name in names + helpers
                if name not in DECIDES and _decides_threads(_tree(name))]
    assert not deciding, f"torch's threads are decided in torch_lane.py, not in {deciding}"
