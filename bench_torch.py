"""Headline benchmark of the PyTorch/CUDA port: OPNet inference frames per
second on one card, the counterpart of `bench.py`.

    python3 bench_torch.py                       # on the card
    python3 bench_torch.py --device cpu --batch 2   # a small run on the CPU

The workload is `bench.py`'s: the trained flagship OPNet
(`objectpermanence_tpu_torch/assets/opnet_19-08-26_0.514.npz`) over the
committed ingest cache (`bench_data/cache/ingest_bench50.npz`), tiled to
512 videos of 300 frames, resident on the device, through
`make_predict_step` with int16 pixel boxes out: on the card, the fused
kernel (K1). Prints ONE JSON line with `bench.py`'s keys:

- `value`: frames/s of the pipelined serving loop, the D2H copy of each
  batch's int16 boxes included (up to 4 batches in flight), best of 3;
- `compute_fps`: frames/s of 24 chained calls with no copy
  back, timed by CUDA events (by the host clock on the CPU), best of 3;
- `compute_fps_bf16`: the same with K1's bf16 operands
  (`compute_dtype=torch.bfloat16`); null off the card, where that mode does
  not exist, as `bench.py` gives null off the TPU;
- `link_efficiency`: `value / compute_fps`;
- `vs_baseline`: `value` over the 5,000 frames/s target of `bench.py`.

Runs on the card unless `--device cpu`; without a card it raises. Imports
nothing of JAX.
"""

import argparse
import json
import sys
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
WEIGHTS = REPO / "objectpermanence_tpu_torch" / "assets" / "opnet_19-08-26_0.514.npz"
CACHE = REPO / "bench_data" / "cache" / "ingest_bench50.npz"
BASELINE_FPS = 5000.0  # the north-star target of bench.py, frames/s per chip
BATCH_VIDEOS, NUM_FRAMES = 512, 300
WARMUP_ITERS, MEASURE_ITERS, PIPELINE_DEPTH, REPEATS = 2, 24, 4, 3


def served_boxes(batch: int) -> torch.Tensor:
    """The committed ingest cache's boxes tiled to `batch` videos of 300 frames."""
    with np.load(CACHE) as blob:
        boxes = blob["boxes"][:, :NUM_FRAMES].astype(np.float32)
    reps = -(-batch // boxes.shape[0])
    return torch.from_numpy(np.tile(boxes, (reps, 1, 1, 1))[:batch])


def _chained_seconds(run, device, iters: int) -> float:
    """Seconds of `iters` chained calls: CUDA events on the card, the host
    clock on the CPU."""
    if device.type != "cuda":
        start = time.perf_counter()
        for i in range(iters):
            run(i)
        return time.perf_counter() - start
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        run(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _served_seconds(run, device, iters: int) -> float:
    """Seconds of the serving loop: each batch's int16 boxes copied to the
    host as it finishes, with up to `PIPELINE_DEPTH` batches in flight."""
    def collect(done, host):
        if done is not None:
            done.synchronize()
        assert host.shape[1:] == (NUM_FRAMES, 4) and host.dtype == torch.int16

    start = time.perf_counter()
    in_flight = deque()
    for i in range(iters):
        host = run(i).to("cpu", non_blocking=True)
        done = torch.cuda.Event() if device.type == "cuda" else None
        if done is not None:
            done.record()
        in_flight.append((done, host))
        if len(in_flight) > PIPELINE_DEPTH:
            collect(*in_flight.popleft())
    while in_flight:
        collect(*in_flight.popleft())
    return time.perf_counter() - start


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--batch", type=int, default=BATCH_VIDEOS,
                        help=f"videos per call (default {BATCH_VIDEOS})")
    args = parser.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from objectpermanence_tpu_torch import resolve_device
    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.utils.checkpoint import load_params

    device = resolve_device(args.device)
    config = load_model_config("opnet")
    spec = get_model_spec("opnet", config)
    model = spec.build(config)
    model.load_state_dict(load_params(WEIGHTS))
    model = model.to(device).eval()
    boxes = served_boxes(args.batch).to(device)
    device_batches = [boxes, torch.roll(boxes, 1, dims=0)]
    print(f"bench data: {CACHE.name} + {WEIGHTS.name} ({args.batch} videos, {device})",
          file=sys.stderr)

    def fps(step, timer) -> float:
        def run(i):
            return step(model, device_batches[i % 2])
        for i in range(WARMUP_ITERS):
            run(i).cpu()
        best = min(timer(run, device, MEASURE_ITERS) for _ in range(REPEATS))
        return args.batch * NUM_FRAMES * MEASURE_ITERS / best

    step = make_predict_step(spec, device=device, out_dtype=torch.int16)
    compute_fps = fps(step, _chained_seconds)
    compute_fps_bf16 = None
    if device.type == "cuda":
        compute_fps_bf16 = fps(make_predict_step(spec, device=device, out_dtype=torch.int16,
                                                 compute_dtype=torch.bfloat16), _chained_seconds)
    frames_per_sec = fps(step, _served_seconds)
    print(json.dumps({
        "metric": "opnet_inference_frames_per_sec_per_chip",
        "value": round(frames_per_sec, 1),
        "unit": "frames/sec",
        "vs_baseline": round(frames_per_sec / BASELINE_FPS, 3),
        "compute_fps": round(compute_fps, 1),
        "compute_fps_bf16": round(compute_fps_bf16, 1) if compute_fps_bf16 else None,
        "link_efficiency": round(frames_per_sec / compute_fps, 3),
        "data": f"real:{CACHE.name}+{WEIGHTS.name}",
    }), flush=True)


if __name__ == "__main__":
    main()
