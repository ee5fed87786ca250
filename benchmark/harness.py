"""One run of one cell: set-up, the timed window, with `--trace 1` a
profiled stretch after it, the launch proof, the check against the
reference, and the result line. Everything a cell uses is found by name
(see `benchmark/__init__.py`)."""

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from time import perf_counter

import numpy as np
import torch

from benchmark import tracing

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"
CACHE = BENCH_DIR / "cache" / "ingest_bench50.npz"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "objectpermanence_tpu")


@dataclass
class Context:
    seed: int
    device: torch.device
    config: dict
    mix: dict
    adapter: object
    reference: object
    kind: object
    limits: dict
    cache: dict
    log: object = None


@dataclass
class Run:
    """What the metric readers read."""
    ctx: Context
    setup_s: float
    window: object          # kinds.Window of the plain stretch
    trace: object = None    # trace.Trace of the profiled stretch (`--trace 1`)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def context(manifest, name, seed, device, config=None, mix=None):
    """The cell `name` of `manifest`; `config` and `mix` replace the files'
    (the tests run cells at small sizes on the CPU)."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(cells)}")
    cell = cells[name]
    config = config or load_json(BENCH_DIR / "configs" / f"{cell['config']}.json")
    mix = mix or load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    with np.load(CACHE) as blob:
        cache = {k: blob[k] for k in blob.files}
    return Context(seed=seed, device=device, config=config, mix=mix, log=_stderr,
                   adapter=importlib.import_module(f"benchmark.models.{cell['config']}"),
                   reference=importlib.import_module(f"benchmark.reference.{cell['config']}"),
                   kind=importlib.import_module(f"benchmark.kinds.{mix['kind']}"),
                   limits=load_json(BENCH_DIR / "limits" / f"{name}.json"), cache=cache)


def _stderr(text):
    print(text, file=sys.stderr, flush=True)


def metrics_of(manifest, cell_name, trace):
    """The manifest's metrics that this cell reports in a run: its end-to-end
    metrics with `--trace 0`, its per-layer ones with `--trace 1`."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    """`metrics/<name>.py`'s `read(run)`."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def launch_counters():
    """Zero the port's launch counters; returns a reader of them."""
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_forward, lstm_scan_hs,
    )
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward

    wrappers = {"K1": opnet_fused_forward, "K2": lstm_scan_forward, "K3": lstm_scan_backward,
                "K4": lstm_scan_hs}
    for fn in wrappers.values():
        fn.launches = 0
    return lambda: {tag: fn.launches for tag, fn in wrappers.items()}


def judge(ctx, numbers):
    """-> (correct, [(name, value, limit)]) over the numbers the cell's
    limits name; each must be at or under its limit."""
    compared = [(name, numbers[name], entry["limit"])
                for name, entry in ctx.limits["numbers"].items()]
    return all(value <= limit for _, value, limit in compared), compared


def run_cell(manifest, name, seed, seconds, trace, device, started, config=None, mix=None,
             log=None):
    """Every step of a run after the look for a card -> (the result without
    its "device" key, that key's measured entries, the compared numbers as
    (name, value, limit))."""
    log = log or _stderr
    ctx = context(manifest, name, seed, device, config, mix)
    ctx.log = lambda what: log(f"set-up: {what} at {perf_counter() - started:.3f} s")
    ctx.log("imports and the cell's files read")
    kind = ctx.kind
    state = kind.setup(ctx)
    setup_s = perf_counter() - started
    counters = launch_counters()
    window = kind.window(ctx, state, seconds)
    launches = counters()
    run = Run(ctx=ctx, setup_s=setup_s, window=window)
    if trace:
        with tracing.profiled(device) as holder:
            calls = kind.stretch(ctx, state, torch.profiler.record_function)
        run.trace = tracing.reduce(holder.profile, calls)
    memory = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    expected = kind.expected_launches(ctx, state, window.attempted)
    proof = all(launches[k] == v for k, v in expected.items())
    if device.type == "cuda":
        log(f"launches in the window: {launches}; expected {expected}: "
            f"{'the window ran the port kernels' if proof else 'MISMATCH'}")
    else:
        proof = True
        log("no card: the port ran its plain paths, so no kernel launch is counted")

    values = {}
    for metric in metrics_of(manifest, name, trace):
        value = reader(metric["name"])(run)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    kind.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = kind.numbers(ctx, state)
    ok, compared = judge(ctx, numbers)
    log(f"checked: {json.dumps({k: v for k, v in numbers.items() if k not in ctx.limits['numbers']})}")
    result = {"correct": bool(ok and proof and window.failed == 0 and window.attempted > 0),
              "attempted": window.attempted,
              "failed": window.failed,
              "metrics": values}
    extra = {"memory_peak_bytes": memory}
    if run.trace is not None:
        extra.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return result, extra, compared


def leaked_modules():
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return f"not read ({err})"


def main(argv, started):
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    manifest = load_json(MANIFEST)
    cells = {c["name"]: c for c in manifest["workloads"]}
    chips = cells[args.workload]["chips"] if args.workload in cells else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    result, extra, compared = run_cell(manifest, args.workload, args.seed, args.seconds,
                                       bool(args.trace), device, started)
    leaked = leaked_modules()
    if leaked:
        print(f"no result: the run loaded {leaked}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                        "count": chips, **extra}
    result["checks"] = result.pop("checks")
    print(f"card: {card_line()}", file=sys.stderr)
    for name, value, limit in compared:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
