"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version at the main path's full-width shapes, drives the
main path (OPNet inference over ingested detections) through the port's
CLI, times the kernel beside its bound, its plain version and a library
yardstick, and prints as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure exits non-zero before that line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
FLAGSHIP_NPZ = REPO / "objectpermanence_tpu_torch" / "assets" / "opnet_19-08-26_0.514.npz"
BENCH_CACHE = REPO / "bench_data" / "cache" / "ingest_bench50.npz"
WORK_DIR = REPO / "build" / "chip_smoke"
BATCH, FRAMES = 512, 300
RAGGED_BATCH = 37
MAIN_PATH_VIDEOS = 64
ATOL = 1e-4          # kernel vs plain, float32 with sums in another order
PX_MAX, PX_SHARE = 1, 1e-3  # integer boxes: <= 1 px apart on <= 0.1% of coordinates
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12


def log(phase, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def time_ms(fn, iters, warmup=2):
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flagship_weights(device):
    from objectpermanence_tpu_torch.utils.checkpoint import load_params
    state = load_params(FLAGSHIP_NPZ)
    keys = ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w", "video_lstm.w_ih",
            "video_lstm.w_hh", "box_head.w")
    return [state[k].to(device).contiguous() for k in keys]


def served_boxes(batch, device):
    """The committed ingest cache's boxes tiled to `batch` videos."""
    with np.load(BENCH_CACHE) as blob:
        boxes = blob["boxes"][:, :FRAMES].astype(np.float32)
    reps = -(-batch // boxes.shape[0])
    return torch.from_numpy(np.tile(boxes, (reps, 1, 1, 1))[:batch]).to(device)


def pixel_diff(a, b):
    diff = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(diff.max()), float((diff > 0).float().mean())


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=repr(name), count=count, torch=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return name, count, smi


def phase_build():
    from objectpermanence_tpu_torch.ops import _build
    t0 = time.perf_counter()
    builds = _build.build("opnet_fused")
    for name, b in builds.items():
        log("build", kernel=name, seconds=f"{time.perf_counter() - t0:.2f}",
            nvcc_seconds=f"{b.seconds:.2f}", library=b.path.relative_to(REPO))
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  " + line.strip(), flush=True)


def compare_kernel(batch, weights, device):
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import (
        opnet_forward_reference, opnet_fused_forward,
    )
    boxes = served_boxes(batch, device)
    y, logits = opnet_fused_forward(boxes, *weights)
    torch.cuda.synchronize()
    want_y, want_logits = opnet_forward_reference(boxes, *weights)
    assert y.shape == (batch, FRAMES, 4) and logits.shape == (batch, 15, FRAMES)
    assert torch.isfinite(y).all() and torch.isfinite(logits).all(), "non-finite output"
    err_y = (y - want_y).abs().max().item()
    err_logits = (logits - want_logits).abs().max().item()
    px_max, px_share = pixel_diff(denormalize_boxes(y), denormalize_boxes(want_y))
    log("kernel_vs_plain", batch=batch, frames=FRAMES, max_abs_err_y=err_y,
        max_abs_err_logits=err_logits, px_max_diff=px_max, px_diff_share=px_share)
    assert err_y <= ATOL and err_logits <= ATOL, f"kernel disagrees with plain at B={batch}"
    assert px_max <= PX_MAX and px_share <= PX_SHARE, f"pixel boxes disagree at B={batch}"
    return max(err_y, err_logits)


def phase_main_path(weights, device):
    """`python -m objectpermanence_tpu_torch inference` on a 64-video
    fixture through its main(), with the launch count read around it."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import (
        opnet_forward_reference, opnet_fused_forward,
    )

    shutil.rmtree(WORK_DIR, ignore_errors=True)
    pred_dir, labels_dir, _ = write_fixture_dataset(WORK_DIR / "data",
                                                    num_videos=MAIN_PATH_VIDEOS, seed=5)
    tree = WORK_DIR / "checkpoints" / "opnet"
    tree.mkdir(parents=True)
    shutil.copy(FLAGSHIP_NPZ, tree / "19-08-26_0.514.npz")
    shipped = json.loads((REPO / "configs" / "inference_config.json").read_text())
    inference_config = {**shipped, "sample_dir": str(pred_dir), "labels_dir": str(labels_dir),
                        "model_path": str(tree), "videos_dir": None, "device": "cuda",
                        "cache_dir": str(WORK_DIR / "cache")}
    (WORK_DIR / "inference.json").write_text(json.dumps(inference_config))
    results = WORK_DIR / "results"

    opnet_fused_forward.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(["inference", "--model_type", "opnet", "--results_dir", str(results),
                   "--inference_config", str(WORK_DIR / "inference.json"),
                   "--model_config", str(REPO / "configs" / "opnet_model_config.json")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = opnet_fused_forward.launches
    assert rc == 0, f"CLI exit {rc}"
    assert launches > 0, "the main path did not launch the fused kernel"

    files = sorted(results.glob("*_bb.json"))
    assert len(files) == MAIN_PATH_VIDEOS, f"{len(files)} prediction files"
    predicted = np.stack([np.array(json.loads(f.read_text())) for f in files])
    assert predicted.shape == (MAIN_PATH_VIDEOS, FRAMES, 4)
    assert predicted.dtype.kind == "i", "predictions are not integer pixels"

    dataset = ingest_directory(pred_dir, labels_dir, 6)
    assert [f"{n}_bb.json" for n in dataset.names] == [f.name for f in files]
    want_y, _ = opnet_forward_reference(torch.from_numpy(dataset.boxes).to(device), *weights)
    px_max, px_share = pixel_diff(torch.from_numpy(predicted),
                                  denormalize_boxes(want_y).cpu())
    log("main_path", videos=len(files), frames=FRAMES, batch_size=inference_config["batch_size"],
        launches=launches, seconds=f"{seconds:.3f}", px_max_diff_vs_plain=px_max,
        px_diff_share=px_share)
    assert px_max <= PX_MAX and px_share <= PX_SHARE, "main path disagrees with plain"
    return launches


class CudnnOPNet(torch.nn.Module):
    """Yardstick only, never used by the port: the same function from
    library calls, two cuDNN LSTMs with the softmax selection between."""

    def __init__(self, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head):
        super().__init__()
        self.lstm1 = torch.nn.LSTM(w1_ih.shape[0], w1_hh.shape[0], bias=False, batch_first=True)
        self.lstm2 = torch.nn.LSTM(w2_ih.shape[0], w2_hh.shape[0], bias=False, batch_first=True)
        with torch.no_grad():
            self.lstm1.weight_ih_l0.copy_(w1_ih.t())
            self.lstm1.weight_hh_l0.copy_(w1_hh.t())
            self.lstm2.weight_ih_l0.copy_(w2_ih.t())
            self.lstm2.weight_hh_l0.copy_(w2_hh.t())
        self.w_att, self.w_head = w_att, w_head

    def forward(self, boxes):
        b, t, o, f = boxes.shape
        h1, _ = self.lstm1(boxes.reshape(b, t, o * f))
        logits = h1 @ self.w_att
        selected = torch.einsum("btof,bto->btf", boxes, torch.softmax(logits, dim=-1))
        h2, _ = self.lstm2(selected)
        return h2 @ self.w_head, logits.transpose(1, 2)


def phase_times(weights, device, launches, max_abs_err):
    from objectpermanence_tpu_torch.ops.opnet_fused import (
        opnet_forward_reference, opnet_fused_forward,
    )
    boxes = served_boxes(BATCH, device)
    library = CudnnOPNet(*weights).to(device)
    with torch.inference_mode():
        lib_y, _ = library(boxes)
        kernel_y, _ = opnet_fused_forward(boxes, *weights)
        library_err = (lib_y - kernel_y).abs().max().item()
        # in turns: plain, kernel, library, kernel, plain
        plain_a = time_ms(lambda: opnet_forward_reference(boxes, *weights), iters=3, warmup=1)
        kernel_a = time_ms(lambda: opnet_fused_forward(boxes, *weights), iters=20)
        library_ms = time_ms(lambda: library(boxes), iters=10)
        kernel_b = time_ms(lambda: opnet_fused_forward(boxes, *weights), iters=20)
        plain_b = time_ms(lambda: opnet_forward_reference(boxes, *weights), iters=3, warmup=1)
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2

    batch, frames, objects, feat = boxes.shape
    w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head = weights
    macs_per_frame = sum(w.numel() for w in weights)  # each weight is used once per frame
    flops = 2 * macs_per_frame * batch * frames
    bytes_moved = 4 * (boxes.numel() + macs_per_frame + batch * frames * (4 + objects))
    bound_ms = max(flops / PEAK_FP32_FLOPS, bytes_moved / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP32_FLOPS >= bytes_moved / PEAK_BYTES_PER_S \
        else "bytes"
    log("times", batch=batch, frames=frames, kernel_ms=kernel_ms, kernel_ms_runs=[kernel_a, kernel_b],
        plain_ms=plain_ms, plain_ms_runs=[plain_a, plain_b], library_ms=library_ms,
        library_max_abs_err_y=library_err, frames_per_s=batch * frames / (kernel_ms / 1e3),
        gflop=flops / 1e9, mbytes=bytes_moved / 1e6, bound_ms=bound_ms, bound_by=bound_by)
    return {"name": "opnet_fused_forward", "route": "cuda",
            "source": "objectpermanence_tpu_torch/csrc/opnet_fused.cu",
            "replaces": "objectpermanence_tpu/ops/pallas_scan.py:485",
            "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import objectpermanence_tpu_torch  # noqa: F401  fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    name, count, _ = phase_device()
    phase_build()
    weights = flagship_weights(device)
    max_abs_err = compare_kernel(BATCH, weights, device)
    compare_kernel(RAGGED_BATCH, weights, device)
    launches = phase_main_path(weights, device)
    kernel = phase_times(weights, device, launches, max_abs_err)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
