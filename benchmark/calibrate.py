"""The readings that the limits of `limits/<cell>.json` are set from, on
the card, for a cell and a list of seeds, in one process:

    python3 benchmark/calibrate.py --workload opnet.serve_b512 --seeds 1,2,3 --seconds 2

For each seed it runs the cell as a run does (set-up, a window of
`--seconds`, the check) and prints one JSON line: `program`, the numbers of
the sound run; `control`, the same numbers with the reference in TF32 in
the program's place; and, for a train cell, `half_batch`, with the
reference that takes the mean over half of each batch in its place. A
state left unchanged needs no run: it reads `change_gap` 1.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(manifest, name, seed, seconds, device):
    ctx = harness.context(manifest, name, seed, device)
    state = ctx.kind.setup(ctx)
    window = ctx.kind.window(ctx, state, seconds)
    ctx.kind.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": window.attempted,
           "program": ctx.kind.numbers(ctx, state),
           "control": ctx.kind.numbers(ctx, state, precision="tf32")}
    if ctx.mix["kind"] == "train":
        out["half_batch"] = ctx.kind.numbers(ctx, state, rows=ctx.mix["videos"] // 2)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    manifest = harness.load_json(harness.MANIFEST)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(manifest, args.workload, seed, args.seconds, torch.device("cuda", 0))
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
