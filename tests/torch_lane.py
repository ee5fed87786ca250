"""The port's tests run torch on one thread, decided here.

The suite runs its files in several worker processes that share the host's
cores, and torch starts one intra-op thread per core in each of them. The
workers' pools then contend, and the small ops of the tests' narrow nets
stall behind that contention (25-40x on the detector's training steps), so
the time goes to the pools and not to the checks.

- `one_torch_thread`: every `tests/test_torch_*.py` that runs torch imports
  it (`from torch_lane import one_torch_thread  # noqa: F401`), and an
  imported autouse fixture is active in the importing module. It restores
  the count after the module, for the files that run later in the worker.
- `ONE_THREAD_ENV`: the entries a child interpreter's environment adds.
- `kept_torch_threads`: undoes what a body sets, for code that sets its own.

`tests/test_torch_lane.py` holds every port test file to this. A spawned
rank of `torch_dp_workers.py` sets its own count, since it imports neither
pytest nor this module.
"""

import contextlib

import pytest
import torch

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1"}


@contextlib.contextmanager
def kept_torch_threads():
    """Torch's thread count on exit is what it was on entry."""
    threads = torch.get_num_threads()
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    with kept_torch_threads():
        torch.set_num_threads(1)
        yield
