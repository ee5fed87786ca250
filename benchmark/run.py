"""Run one cell of `BENCHMARK.json` once on the card:

    python3 benchmark/run.py --workload opnet.serve_b512 --seed 7 --seconds 10 --trace 0

Prints the result as the last line of standard output, and the numbers
that decide `correct`, each beside its limit, as the last lines of standard
error. Exits with 2 and prints no result where the card is missing, with 3
where the run loaded JAX or the JAX package.
"""

import time

STARTED = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every compiler cache at a fixed path inside the checkout (the port's
# kernels build into build/torch_kernels/ there by themselves)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
sys.path[0] = str(ROOT)  # the checkout, not this folder: its modules are the package's

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], STARTED))
