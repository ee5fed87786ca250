"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (`opnet_fused`: K1;
`lstm_scan`: K2, K3, K4), holds each against its plain PyTorch version at
the main paths' full-width shapes, drives both main paths through the
port's CLI (OPNet inference over ingested detections, and OPNet training
on a fixture dataset followed by inference from its best checkpoint),
reading each kernel's launch count around each path, profiles one
full-width train step, times every kernel beside its bound, its plain
version and a library yardstick, and prints
as its last line
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
# training: the shipped batch of 16 and a ragged one; the flagship's two
# LSTM layers as (input width, hidden width)
TRAIN_BATCH, RAGGED_TRAIN_BATCH = 16, 13
LSTM_LAYERS = {"att_lstm": (90, 256), "video_lstm": (6, 512)}
TRAIN_VIDEOS, DEV_VIDEOS, TRAIN_EPOCHS = 64, 16, 2
ATOL = 1e-4          # kernel vs plain, float32 with sums in another order
# gradients summed over B x T terms (dW_hh, dW_ih, dx): 1e-4 relative to
# their largest reference value, at least 1e-4 absolute
GRAD_RTOL = 1e-4
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


def reset_launches():
    """Every kernel wrapper's launch count to 0; returns a reader of them."""
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_forward, lstm_scan_hs,
    )
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward
    wrappers = {"K1": opnet_fused_forward, "K2": lstm_scan_forward, "K3": lstm_scan_backward,
                "K4": lstm_scan_hs}
    for fn in wrappers.values():
        fn.launches = 0
    return lambda: {tag: fn.launches for tag, fn in wrappers.items()}


def phase_build():
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops.lstm_scan import launch_plan
    t0 = time.perf_counter()
    builds = _build.build("opnet_fused", "lstm_scan")
    for name, b in builds.items():
        log("build", kernel=name, seconds=f"{time.perf_counter() - t0:.2f}",
            nvcc_seconds=f"{b.seconds:.2f}", library=b.path.relative_to(REPO))
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  " + line.strip(), flush=True)
    for layer, (_, hidden) in LSTM_LAYERS.items():
        for backward in (False, True):
            units, blocks, smem = launch_plan(hidden, backward)
            log("plan", layer=layer, hidden=hidden, kernel="K3" if backward else "K2/K4",
                units_per_block=units, blocks=blocks, smem_bytes=smem)


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
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference

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

    read = reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(["inference", "--model_type", "opnet", "--results_dir", str(results),
                   "--inference_config", str(WORK_DIR / "inference.json"),
                   "--model_config", str(REPO / "configs" / "opnet_model_config.json")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read()
    launches = counts["K1"]
    assert rc == 0, f"CLI exit {rc}"
    assert launches > 0, "the main path did not launch the fused kernel"
    assert counts["K2"] == counts["K3"] == counts["K4"] == 0, f"inference ran LSTM kernels: {counts}"

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


def lstm_case(layer, batch, weights, device, seed=0):
    """One flagship LSTM layer's weights and its real input at `batch`
    videos: the served scene (att_lstm), or the box the flagship's attention
    selects in each frame (video_lstm; the plain layers compute it). The
    output cotangent comes from a seeded normal. (A box the net was not
    trained on, such as slot 0's zeros while the snitch is hidden, can make
    the video LSTM's backward grow without bound over 300 steps, in the plain
    loop as in the kernel.)"""
    from objectpermanence_tpu_torch.ops.lstm import lstm_forward
    boxes = served_boxes(batch, device)
    scene = boxes.reshape(batch, FRAMES, -1)
    if layer == "att_lstm":
        w_ih, w_hh, x = weights[0], weights[1], scene
    else:
        with torch.no_grad():
            probs = torch.softmax(lstm_forward(scene, weights[0], weights[1]) @ weights[2], -1)
            x = torch.einsum("btof,bto->btf", boxes, probs)
        w_ih, w_hh = weights[3], weights[4]
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dout = torch.randn((batch, FRAMES, w_hh.shape[0]), generator=gen).to(device)
    return x.contiguous(), w_ih, w_hh, dout


def max_err(got, want):
    return (got - want).abs().max().item()


def grad_limit(want):
    return GRAD_RTOL * max(1.0, want.abs().max().item())


def compare_lstm(layer, batch, weights, device):
    """K2, K4 and K3 against their plain versions on the same inputs, and
    the autograd layer (K2 + K3 + the torch products) against autograd
    through the plain step loop."""
    from objectpermanence_tpu_torch.ops.lstm import lstm_forward
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_backward_reference, lstm_scan_forward,
        lstm_scan_forward_reference, lstm_scan_fused, lstm_scan_hs,
    )
    x, w_ih, w_hh, dout = lstm_case(layer, batch, weights, device)
    xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
    hs, cs = lstm_scan_forward(xproj, w_hh)
    hs_only = lstm_scan_hs(xproj, w_hh)
    torch.cuda.synchronize()
    want_hs, want_cs = lstm_scan_forward_reference(xproj, w_hh)
    assert torch.isfinite(hs).all() and torch.isfinite(cs).all(), "non-finite K2 output"

    h_prev = torch.cat([torch.zeros_like(want_hs[:1]), want_hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(want_cs[:1]), want_cs[:-1]])
    dh_out = dout.transpose(0, 1).contiguous()
    dxproj, d_w_hh = lstm_scan_backward(xproj, h_prev, c_prev, want_cs, dh_out, w_hh)
    torch.cuda.synchronize()
    want_dxproj, want_d_w_hh = lstm_scan_backward_reference(xproj, h_prev, c_prev, want_cs,
                                                            dh_out, w_hh)

    def layer_grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in (x, w_ih, w_hh)]
        out = fn(leaves)
        out.backward(dout)
        return out.detach(), [t.grad for t in leaves]

    out, (dx, d_w_ih, d_w_hh_ag) = layer_grads(
        lambda t: lstm_scan_fused({"w_ih": t[1], "w_hh": t[2]}, t[0]))
    torch.cuda.synchronize()
    want_out, (want_dx, want_d_w_ih, want_d_w_hh_ag) = layer_grads(
        lambda t: lstm_forward(t[0], t[1], t[2]))

    errs = {"hs": max_err(hs, want_hs), "cs": max_err(cs, want_cs),
            "hs_only": max_err(hs_only, want_hs), "dxproj": max_err(dxproj, want_dxproj),
            "dW_hh": max_err(d_w_hh, want_d_w_hh), "out": max_err(out, want_out),
            "autograd_dW_ih": max_err(d_w_ih, want_d_w_ih),
            "autograd_dW_hh": max_err(d_w_hh_ag, want_d_w_hh_ag),
            "autograd_dx": max_err(dx, want_dx)}
    limits = {"hs": ATOL, "cs": ATOL, "hs_only": ATOL, "dxproj": ATOL, "out": ATOL,
              "dW_hh": grad_limit(want_d_w_hh), "autograd_dW_ih": grad_limit(want_d_w_ih),
              "autograd_dW_hh": grad_limit(want_d_w_hh_ag), "autograd_dx": grad_limit(want_dx)}
    log("lstm_vs_plain", layer=layer, batch=batch, frames=FRAMES,
        **{f"max_abs_err_{k}": v for k, v in errs.items()},
        **{f"limit_{k}": limits[k] for k in ("dW_hh", "autograd_dW_ih", "autograd_dx")})
    bad = [k for k in errs if not errs[k] <= limits[k]]
    assert not bad, f"lstm kernels disagree with plain ({layer}, B={batch}): {bad}"
    return {"K2": max(errs["hs"], errs["cs"]), "K3": max(errs["dxproj"], errs["dW_hh"]),
            "K4": errs["hs_only"]}


def phase_lstm_vs_plain(weights, device):
    worst = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    for layer in LSTM_LAYERS:
        for batch in (TRAIN_BATCH, RAGGED_TRAIN_BATCH):
            for tag, err in compare_lstm(layer, batch, weights, device).items():
                worst[tag] = max(worst[tag], err)
    return worst


def phase_train_path(device):
    """`python -m objectpermanence_tpu_torch training` at full width on a
    fixture dataset, then `inference` from its best-dev checkpoint, each with
    the launch counts read around it."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference
    from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint, load_params

    work = WORK_DIR / "train_path"
    shutil.rmtree(work, ignore_errors=True)
    train_pred, train_labels, train_cont = write_fixture_dataset(
        work / "train", num_videos=TRAIN_VIDEOS, seed=11)
    dev_pred, dev_labels, dev_cont = write_fixture_dataset(
        work / "dev", num_videos=DEV_VIDEOS, seed=12)
    shipped = json.loads((REPO / "configs" / "training_config.json").read_text())
    training_config = {**shipped, "num_epochs": TRAIN_EPOCHS, "print_step": 2,
                       "checkpoints_path": str(work / "checkpoints"),
                       "cache_dir": str(work / "cache"),
                       "metrics_file": str(work / "metrics.jsonl"),
                       "train_sample_dir": str(train_pred), "train_labels_dir": str(train_labels),
                       "train_containment_file": str(train_cont),
                       "dev_sample_dir": str(dev_pred), "dev_labels_dir": str(dev_labels),
                       "dev_containment_file": str(dev_cont)}
    (work / "training.json").write_text(json.dumps(training_config))
    model_config = str(REPO / "configs" / "opnet_model_config.json")

    read = reset_launches()
    t0 = time.perf_counter()
    rc = cli_main(["training", "--model_type", "opnet", "--model_config", model_config,
                   "--training_config", str(work / "training.json")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    assert rc == 0, f"training CLI exit {rc}"
    epochs = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in epochs] == list(range(1, TRAIN_EPOCHS + 1))
    for e in epochs:
        for split in ("train", "dev"):
            assert np.isfinite(e[split]["loss"]), f"non-finite {split} loss: {e}"
    assert launches["K2"] > 0 and launches["K3"] > 0, f"training skipped K2/K3: {launches}"
    assert launches["K4"] > 0, f"the eval step skipped K4: {launches}"
    assert launches["K1"] == 0, f"the train path launched the inference kernel: {launches}"
    tree = work / "checkpoints" / "opnet"
    best = best_params_checkpoint(tree)
    assert best is not None and best.suffix == ".npz", f"no best-dev npz in {tree}"
    resume_state = tree / "resume" / f"epoch_{TRAIN_EPOCHS:04d}"
    assert (resume_state / "state.npz").exists() and (resume_state / "metadata.json").exists()
    log("train_path", train_videos=TRAIN_VIDEOS, dev_videos=DEV_VIDEOS, frames=FRAMES,
        batch_size=shipped["batch_size"], epochs=TRAIN_EPOCHS, seconds=f"{seconds:.3f}",
        launches=json.dumps(launches), best=best.name,
        **{f"epoch{e['epoch']}_train_loss": e["train"]["loss"] for e in epochs},
        **{f"epoch{e['epoch']}_dev_loss": e["dev"]["loss"] for e in epochs},
        **{f"epoch{e['epoch']}_dev_miou": e["dev"]["mean_iou"] for e in epochs})

    # the trained model through the inference CLI, and so through K1
    shipped_inf = json.loads((REPO / "configs" / "inference_config.json").read_text())
    inference_config = {**shipped_inf, "sample_dir": str(dev_pred),
                        "labels_dir": str(dev_labels), "model_path": str(tree),
                        "videos_dir": None, "device": "cuda", "cache_dir": str(work / "cache")}
    (work / "inference.json").write_text(json.dumps(inference_config))
    read = reset_launches()
    rc = cli_main(["inference", "--model_type", "opnet", "--results_dir", str(work / "results"),
                   "--inference_config", str(work / "inference.json"),
                   "--model_config", model_config])
    torch.cuda.synchronize()
    inference_launches = read()
    assert rc == 0, f"inference CLI exit {rc}"
    assert inference_launches["K1"] > 0, f"inference skipped K1: {inference_launches}"
    files = sorted((work / "results").glob("*_bb.json"))
    assert len(files) == DEV_VIDEOS, f"{len(files)} prediction files"
    predicted = np.stack([np.array(json.loads(f.read_text())) for f in files])
    dataset = ingest_directory(dev_pred, dev_labels, 6)
    state = load_params(best)
    trained = [state[k].to(device) for k in ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w",
                                             "video_lstm.w_ih", "video_lstm.w_hh",
                                             "box_head.w")]
    want_y, _ = opnet_forward_reference(torch.from_numpy(dataset.boxes).to(device), *trained)
    px_max, px_share = pixel_diff(torch.from_numpy(predicted), denormalize_boxes(want_y).cpu())
    log("train_path_inference", videos=len(files), launches=json.dumps(inference_launches),
        px_max_diff_vs_plain=px_max, px_diff_share=px_share)
    assert px_max <= PX_MAX and px_share <= PX_SHARE, "trained model's inference disagrees"
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


def lstm_bounds(batch, frames, hidden):
    """bound_ms and what bounds it for K2, K3 and K4 at these shapes, from
    scripts/kernel_bounds.py (one dW_hh tile: the kernel writes it once)."""
    sys.path.insert(0, str(REPO / "scripts"))
    import kernel_bounds as kb
    cases = {"K2": kb.lstm_forward(batch, frames, hidden),
             "K3": kb.lstm_backward(batch, frames, hidden, block_b=batch),
             "K4": kb.lstm_forward(batch, frames, hidden, emit_cells=False)}
    out = {}
    for tag, (_, flops, bytes_) in cases.items():
        t_ops, t_bytes = flops / kb.PEAK_FLOPS, bytes_ / kb.PEAK_BYTES
        out[tag] = (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_lstm_layer(layer, weights, device):
    """K2, K3, K4, their plain versions and cuDNN's nn.LSTM(bias=False) at
    the training batch, in turns: plain, kernel, library, kernel, plain."""
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_backward_reference, lstm_scan_forward,
        lstm_scan_forward_reference, lstm_scan_hs,
    )
    x, w_ih, w_hh, dout = lstm_case(layer, TRAIN_BATCH, weights, device)
    xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
    hs, cs = lstm_scan_forward(xproj, w_hh)
    h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
    dh_out = dout.transpose(0, 1).contiguous()
    calls = {
        "K2": (lambda: lstm_scan_forward(xproj, w_hh),
               lambda: lstm_scan_forward_reference(xproj, w_hh)),
        "K3": (lambda: lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh),
               lambda: lstm_scan_backward_reference(xproj, h_prev, c_prev, cs, dh_out, w_hh)),
        "K4": (lambda: lstm_scan_hs(xproj, w_hh),
               lambda: lstm_scan_forward_reference(xproj, w_hh)),
    }
    cudnn = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], bias=False, batch_first=True).to(device)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.t())
        cudnn.weight_hh_l0.copy_(w_hh.t())
    x_leaf = x.detach().clone().requires_grad_(True)

    def cudnn_forward():
        with torch.no_grad():
            cudnn(x)

    def cudnn_forward_backward():
        out, _ = cudnn(x_leaf)
        out.backward(dout)

    library_forward = time_ms(cudnn_forward, iters=20)
    library_backward = time_ms(cudnn_forward_backward, iters=20) - library_forward
    bounds = lstm_bounds(TRAIN_BATCH, FRAMES, w_hh.shape[0])
    rows = {}
    for tag, (kernel, plain) in calls.items():
        plain_a = time_ms(plain, iters=2, warmup=1)
        kernel_a = time_ms(kernel, iters=20)
        kernel_b = time_ms(kernel, iters=20)
        plain_b = time_ms(plain, iters=2, warmup=1)
        rows[tag] = {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
                     "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
                     "library_ms": library_backward if tag == "K3" else library_forward,
                     "bound_ms": bounds[tag][0], "bound_by": bounds[tag][1]}
        log("times", kernel=tag, layer=layer, batch=TRAIN_BATCH, frames=FRAMES,
            hidden=w_hh.shape[0], **rows[tag])
    return rows


def phase_train_step_profile(device, steps=20, profile_steps=5):
    """Where a full-width train step spends its time: the flagship trained on
    the first 16 served videos with the port's own train step; the mean step
    time by CUDA events, then a torch.profiler window with each kernel's
    device time per step and the share of the window the device was busy."""
    from objectpermanence_tpu_torch.models.registry import init_model
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    spec, model = init_model("opnet", config, checkpoint_path=str(FLAGSHIP_NPZ), device=device,
                             train=True)
    with np.load(BENCH_CACHE) as blob:
        labels = torch.from_numpy(blob["labels"][:TRAIN_BATCH, :FRAMES].astype(np.float32))
    boxes, labels = served_boxes(TRAIN_BATCH, device), labels.to(device)
    mask = torch.zeros(labels.shape, dtype=torch.bool, device=device)
    weights = torch.ones(TRAIN_BATCH, device=device)
    step = make_train_step(spec, make_optimizer(model.parameters(), 1e-3))
    step_ms = time_ms(lambda: step(model, boxes, labels, mask, weights), iters=steps, warmup=3)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        window_ms = time_ms(lambda: step(model, boxes, labels, mask, weights),
                            iters=profile_steps, warmup=0) * profile_steps
    kernels = {}  # device ms by kernel name, without its argument list
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            name = event.name.replace("(anonymous namespace)::", "").split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + event.device_time / 1e3
    per_step = {name: ms / profile_steps
                for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])}
    busy_ms = sum(kernels.values())
    assert busy_ms > 0, "the profiler saw no device time"
    log("train_step_profile", batch=TRAIN_BATCH, frames=FRAMES, step_ms=step_ms,
        samples_per_s=TRAIN_BATCH / (step_ms / 1e3), window_ms=window_ms,
        device_busy_share=busy_ms / window_ms,
        per_step_ms=json.dumps(dict(list(per_step.items())[:6])))


LSTM_KERNELS = {
    "K2": ("lstm_scan_forward", "objectpermanence_tpu/ops/pallas_scan.py:179"),
    "K3": ("lstm_scan_backward", "objectpermanence_tpu/ops/pallas_scan.py:221"),
    "K4": ("lstm_scan_hs", "objectpermanence_tpu/ops/pallas_scan.py:347"),
}


def phase_lstm_times(weights, device, launches, errors):
    """The kernels line's rows for K2-K4 at H=512 (video_lstm); the H=256
    layer (att_lstm) is timed and logged beside it."""
    time_lstm_layer("att_lstm", weights, device)
    rows = time_lstm_layer("video_lstm", weights, device)
    return [{"name": name, "route": "cuda",
             "source": "objectpermanence_tpu_torch/csrc/lstm_scan.cu", "replaces": site,
             "launches": launches[tag], "max_abs_err": errors[tag], "ms": rows[tag]["ms"],
             "plain_ms": rows[tag]["plain_ms"], "bound_ms": rows[tag]["bound_ms"],
             "bound_by": rows[tag]["bound_by"], "library_ms": rows[tag]["library_ms"]}
            for tag, (name, site) in LSTM_KERNELS.items()]


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
    lstm_errors = phase_lstm_vs_plain(weights, device)
    launches = phase_main_path(weights, device)
    train_launches = phase_train_path(device)
    phase_train_step_profile(device)
    kernels = [phase_times(weights, device, launches, max_abs_err)]
    kernels += phase_lstm_times(weights, device, train_launches, lstm_errors)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
