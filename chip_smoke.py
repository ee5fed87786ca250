"""Smoke run of the PyTorch/CUDA port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (`opnet_fused`: K1, in
float32 and with bf16 operands; `lstm_scan`: K2, K3, K4; `roi_align`: K7,
with K5/K6 as its one-image entries, K8, its backward (bf16 dF too), and K9,
the windowed RoIAlign; K7 and K9 in float32 and bfloat16), holds each against
its plain PyTorch version at the main paths' full-width shapes, holds the five
other reasoning models (`baseline_lstm`, `non_linear_lstm`, `transformer_lstm`,
also with `reference_compat`, `opnet_lstm_mlp`, `opnet_moe`) at their shipped
widths against the CPU's plain loops, forward (K4) and one train step's
gradients (K2/K3), drives the main paths (OPNet inference over ingested
detections, in float32 through the CLI and with bf16 operands through
`make_predict_step`, then the CLI's `analysis` of its predictions; OPNet
training on a fixture dataset followed by inference and `cater_inference`
from its best checkpoint; training then inference of each of the five other
models through the CLI; `preprocess`, the full-width Faster R-CNN over fixture
videos, followed by OPNet inference over the pickles it wrote, all through
the port's CLI; Faster R-CNN training through `train_detector` at the
dettrain recipe's full width, resumed, then detection from its best
checkpoint; the same at the 800 px `train800` recipe in bf16, then steps of
its fp32 twin and of bf16 with "auto"; `preprocess` at the 800 px bf16
recipe, then chunks of its fp32 twin, of the default `DetectorConfig()` and
of the native geometry in bf16), reading each kernel's launch count around
each path, runs one detector train step at each geometry and one 800 px
video again with the plain RoIAlign swapped in, profiles one full-width train
step of OPNet, of each other reasoning model (with its inference at B=512)
and of the detector (native fp32, 800 px bf16 and fp32) and detector chunks
at both geometries, runs `bench_torch.py`, holds the full-width SiamRPN
tracker on the card against the CPU (its forward at the 271 and 287 px
searches and a batch-32 train step's gradients), drives the programmed
models through the CLI (`detector_heuristic` and `detector_tracker` on
fixture videos, against their CPU runs), trains SiamRPN with
`siam_train_main` and tracks a video from its checkpoint, profiles its train
step and its per-frame network (all of which launch none of the port's
kernels: SiamRPN is library convs), builds the native ingest library and
ingests 64 simulated 300-frame videos (the port's simulator and perfect
perception) natively and in Python (arrays equal, both host times), trains
the shipped OPNet an epoch on them under a one-rank NCCL process group (DDP,
`training_main(mesh=make_mesh())`; K2/K3/K4) and without one (within 1e-6),
runs an FSDP2 step and the dettrain detector's step under DDP (K7/K8), each
against its single-device twin and timed beside it, holds each model-parallel
mesh at world 1 over NCCL against its plain twin and times it beside it (a
tensor-parallel train step, K2/K3; the sequence-parallel OPNet and
transformer_lstm forwards and IoU, K4; the pipeline's forward, K4, and train
step, K2/K3, as one stage of OPNet's four stage functions over 4
microbatches; the expert-parallel MoE head against the dense one), runs
`dryrun_multichip(1, device="cuda")` in that group, drives the six experiment
drivers of `objectpermanence_tpu_torch/experiments/` through their main()s on
simulated splits (`containment_run` datagen, train on K2/K3/K4, analyze on K1
held against the plain forward; `variant_sweep` on K1-K4, `cater_grid_run` on
K1 and K4, `make_unbsub` on the host, `unbiased_eval` on K1, `moe_balance` on
K4), drives the six perception and tracker drivers the same way on rendered
simulated splits (`two_stage_run` render, dettrain on K7/K8, preprocess on
K7, opnet on K2/K3/K4, analyze on K1 held against the plain forward;
`detector_800px_run` steptime on K7/K8/K9, train800 in bf16 on K9/K8 bf16,
native on K7/K8, contract on none; `detector_infer800` on K9 and K9 bf16;
`detector_transfer_demo` on K7/K8 and, with `--bf16`, their bf16 modes;
`tracker_benchmark` and `siam_run` on SiamRPN's library convolutions, none
of the port's kernels), times every kernel beside its
bound, its plain version and a library yardstick where there is one, and
prints as its last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Any failure exits non-zero before that line. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result. Imports nothing of JAX.
"""

import json
import os
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
PREPROCESS_CONFIG = REPO / "configs" / "preprocess_config.json"
BATCH, FRAMES = 512, 300
RAGGED_BATCH = 37
MAIN_PATH_VIDEOS = 64
# training: the shipped batch of 16 and a ragged one; the flagship's two
# LSTM layers as (input width, hidden width)
TRAIN_BATCH, RAGGED_TRAIN_BATCH = 16, 13
LSTM_LAYERS = {"att_lstm": (90, 256), "video_lstm": (6, 512)}
TRAIN_VIDEOS, DEV_VIDEOS, TRAIN_EPOCHS = 64, 16, 2
# K4's batch in the eval step, min(inference_batch_size, max(len(train),
# len(dev))) (train/loop.py): 64 on the train path's 64 + 16 fixture videos,
# 400 at the shipped configs/training_config.json with a real dataset
EVAL_BATCHES = (64, 400)
ATOL = 1e-4          # kernel vs plain, float32 with sums in another order
# gradients summed over B x T terms (dW_hh, dW_ih, dx): 1e-4 relative to
# their largest reference value, at least 1e-4 absolute
GRAD_RTOL = 1e-4
PX_MAX, PX_SHARE = 1, 1e-3  # integer boxes: <= 1 px apart on <= 0.1% of coordinates
# the detector at the shipped preprocess config (configs/preprocess_config.json)
DETECTOR_VIDEOS, CHUNK = 3, 30
DETECTOR_SEED = 21   # fixture scenes of the preprocess videos
ROI_RTOL = 1e-4      # RoIAlign vs plain: 1e-4 x max(1, max |ref|), values reach 1e3
# detector training at the dettrain recipe (scripts/two_stage_run.py): GroupNorm
# ResNet-50 FPN 256, 240 x 320 frames, RPN 500/300, batch 8, SGD lr 5e-3; cut to
# 3 epochs (2, then a resume) of 48 + 16 fixture frames (24 + 8 scenes, 2 frames
# each) from 16 epochs of the rendered 3,200-video set
DETTRAIN = dict(min_size=240, max_size=320, backbone_norm="group", rpn_pre_nms_top_n=500,
                rpn_post_nms_top_n=300)
DET_BATCH, DET_LR, DET_TRAIN_SCENES, DET_DEV_SCENES, DET_EPOCHS = 8, 5e-3, 24, 8, 2
DET_ROIS = 320       # 300 proposals + 20 ground-truth boxes per image
LOSS_RTOL = 1e-5     # swap step: loss parts, relative
BOX_PX = 0.25        # detections kernel vs plain RoIAlign: boxes within 0.25 px
FRAME_FLIP_SHARE = 1e-3  # ... on all but at most 0.1% of frames
# the 800 px recipe as served (scripts/detector_infer800.py bf16_windowed): GroupNorm
# ResNet-50 FPN 256, min 800 / max 1333 (240 x 320 frames -> 800 x 1067, padded to
# 800 x 1088), RPN 500/300, the windowed RoIAlign, bf16 compute, batch 8; its fp32
# twin is fp32_windowed. Not cut in width or depth; seeded weights, fixture frames.
DET800 = dict(backbone_norm="group", rpn_pre_nms_top_n=500, rpn_post_nms_top_n=300,
              roi_backend="windowed")
DET800_BATCH = 8
DET800_SEED = 41     # fixture scene of the 800 px video
# rois over 800 x 1088 frames: sub-pixel, across and beyond the edges, 2000 px, a
# zero box, the far corner; then five of 600 x 8 px (and 8 x 600), at P2 far over
# the 56-64 px window, so out of the windowed kernel's contract
EDGE_ROIS_800 = [[10.2, 20.7, 10.6, 21.1], [-75.0, 500.0, 60.0, 650.0],
                 [750.0, -125.0, 1050.0, 25.0], [-12.0, -12.0, 1990.0, 1999.0],
                 [0.0, 0.0, 0.0, 0.0], [1087.5, 799.5, 1088.0, 800.0],
                 [100.0, 200.0, 700.0, 208.0], [300.0, 500.5, 900.0, 508.5],
                 [50.0, 100.0, 58.0, 700.0], [1000.0, 10.0, 1008.0, 610.0],
                 [480.0, 790.0, 1080.0, 798.0]]
OUT_OF_CONTRACT_MIN = 4
# the 800 px training recipe, the JAX package's `train800` stage
# (scripts/detector_800px_run.py): `train_detector` at DET800's geometry and widths
# (GroupNorm ResNet-50 FPN 256, 800 x 1088 padded, RPN 500/300, windowed), batch 4,
# SGD lr 5e-3, bf16 (`--compute-dtype bfloat16`) with its fp32 twin; cut from 12
# epochs of the rendered set to 2 + 1 epochs of the 48 + 16 fixture frames, seeded
# weights
TRAIN800_BATCH, TRAIN800_EPOCHS, TRAIN800_TWIN_STEPS = 4, 2, 3
# the swap step in bf16: K8 adds the rois' shares in another order than the plain
# scatter, which moves the float32 sums' last bits, which can move a bf16 rounding
# of dF by one ulp and, through the bf16 backbone's backward,
# its gradients: each within 1e-2 x max(1, max |plain's|); the first SGD step moves
# a parameter by lr x its gradient, so each parameter after the update within lr
# times that limit, plus two float32 ulps of the parameter
SWAP_BF16_RTOL = 1e-2


def cli_batch():
    """The CLI's served batch (configs/inference_config.json), where K1 is also timed."""
    return json.loads((REPO / "configs" / "inference_config.json").read_text())["batch_size"]


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


def device_kernel_ms(prof):
    """Device milliseconds by kernel name (without its argument list) in a
    torch.profiler window; the GPU spans of `record_function` annotations
    (such as `Optimizer.step#SGD.step`) cover kernels already counted and
    are left out."""
    kernels = {}
    for event in prof.events():
        if (event.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(event, "is_user_annotation", False)):
            name = event.name.replace("(anonymous namespace)::", "").split("(")[0]
            kernels[name] = kernels.get(name, 0.0) + event.device_time / 1e3
    return kernels


def reset_launches(by_dtype=False):
    """Every kernel wrapper's launch count to 0; returns a reader of them.
    With `by_dtype`, K7, K8 and K9 read their float32 launches and
    "K7_bf16", "K8_bf16", "K9_bf16" their bfloat16 ones, as the wrappers
    count them."""
    from objectpermanence_tpu_torch.ops.lstm_scan import (
        lstm_scan_backward, lstm_scan_forward, lstm_scan_hs,
    )
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_fused_forward
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_backward, roi_align_single, roi_align_tiled,
        roi_align_windowed,
    )
    wrappers = {"K1": opnet_fused_forward, "K2": lstm_scan_forward, "K3": lstm_scan_backward,
                "K4": lstm_scan_hs, "K5": roi_align_single, "K6": roi_align_tiled,
                "K7": roi_align_batched, "K8": roi_align_batched_backward,
                "K9": roi_align_windowed}
    for fn in wrappers.values():
        fn.launches = 0
        fn.launches_bf16 = 0

    def read():
        counts = {tag: fn.launches for tag, fn in wrappers.items()}
        if by_dtype:
            for tag in ("K7", "K8", "K9"):
                counts[f"{tag}_bf16"] = wrappers[tag].launches_bf16
                counts[tag] -= wrappers[tag].launches_bf16
        return counts
    return read


def phase_build():
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops.lstm_scan import launch_plan
    from objectpermanence_tpu_torch.ops.opnet_fused import launch_plan as k1_plan
    t0 = time.perf_counter()
    builds = _build.build("opnet_fused", "lstm_scan", "roi_align")
    for name, b in builds.items():
        log("build", kernel=name, seconds=f"{time.perf_counter() - t0:.2f}",
            nvcc_seconds=f"{b.seconds:.2f}", library=b.path.relative_to(REPO))
        for line in b.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print("  " + line.strip(), flush=True)
    for layer, (_, hidden) in LSTM_LAYERS.items():
        for batch in (TRAIN_BATCH, RAGGED_TRAIN_BATCH, *EVAL_BATCHES):
            plan = launch_plan(hidden, batch=batch)
            log("plan", layer=layer, hidden=hidden, kernel="K2/K4", batch=batch,
                video_groups=plan["groups"], unit_slices=plan["slices"],
                videos_per_thread=plan["tile"], k_splits=plan["splits"],
                rows_staged=plan["stage"], units_per_block=plan["units"],
                videos_per_group=plan["videos"], blocks=plan["blocks"],
                smem_bytes=plan["smem"], passes=plan["passes"])
        for batch in (TRAIN_BATCH, RAGGED_TRAIN_BATCH):
            plan = launch_plan(hidden, backward=True, batch=batch)
            log("plan", layer=layer, hidden=hidden, kernel="K3", batch=batch,
                video_groups=plan["groups"], unit_slices=plan["slices"],
                units_per_block=plan["units"], blocks=plan["blocks"], smem_bytes=plan["smem"],
                videos_staged=plan["stage"], unit_lanes=plan["lanes"])
    hidden = (LSTM_LAYERS["att_lstm"][1], LSTM_LAYERS["video_lstm"][1])
    for dtype in (torch.float32, torch.bfloat16):
        for batch in (BATCH, cli_batch()):
            plan = k1_plan(batch, *hidden, dtype)
            log("plan", kernel="K1_bf16" if dtype == torch.bfloat16 else "K1", batch=batch,
                hidden=f"{hidden[0]}/{hidden[1]}", video_groups=plan["groups"],
                unit_slices=plan["slices"], blocks=plan["blocks"], smem_bytes=plan["smem"],
                scratch_floats=plan["scratch"])


def compare_kernel(batch, weights, device, compute_dtype=torch.float32):
    """K1 (or its bf16 operand mode) against its plain version on the same
    operands (float32 sums in another order): y and the logits within 1e-4,
    pixel boxes <= 1 px apart on <= 0.1%. For the bf16 mode, beside it and
    not gated, how far bf16 moves the pixel boxes from float32 K1."""
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import (
        opnet_forward_reference, opnet_fused_forward,
    )
    boxes = served_boxes(batch, device)
    y, logits = opnet_fused_forward(boxes, *weights, compute_dtype=compute_dtype)
    torch.cuda.synchronize()
    want_y, want_logits = opnet_forward_reference(boxes, *weights, compute_dtype=compute_dtype)
    assert y.dtype == logits.dtype == torch.float32
    assert y.shape == (batch, FRAMES, 4) and logits.shape == (batch, 15, FRAMES)
    assert torch.isfinite(y).all() and torch.isfinite(logits).all(), "non-finite output"
    err_y = (y - want_y).abs().max().item()
    err_logits = (logits - want_logits).abs().max().item()
    px_max, px_share = pixel_diff(denormalize_boxes(y), denormalize_boxes(want_y))
    fields = {}
    if compute_dtype != torch.float32:
        y32, _ = opnet_fused_forward(boxes, *weights)
        moved = (denormalize_boxes(y).to(torch.int64)
                 - denormalize_boxes(y32).to(torch.int64)).abs()
        fields = {"fp32_boxes_moved": int((moved.amax(-1) > 0).sum()),
                  "fp32_boxes": batch * FRAMES, "fp32_px_max_diff": int(moved.max()),
                  "fp32_px_mean_diff": float(moved.float().mean()),
                  "fp32_max_abs_diff_y": (y - y32).abs().max().item()}
    phase = "kernel_vs_plain" if compute_dtype == torch.float32 else "opnet_bf16_vs_plain"
    log(phase, batch=batch, frames=FRAMES, max_abs_err_y=err_y, max_abs_err_logits=err_logits,
        px_max_diff=px_max, px_diff_share=px_share, **fields)
    assert err_y <= ATOL and err_logits <= ATOL, f"{phase}: kernel disagrees at B={batch}"
    assert px_max <= PX_MAX and px_share <= PX_SHARE, f"{phase}: pixel boxes disagree at B={batch}"
    return max(err_y, err_logits)


def bf16_ulp(x):
    """One bf16 ulp at magnitude `x` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def phase_opnet_bf16_vs_plain(weights, device):
    bf16 = torch.bfloat16
    return max(compare_kernel(b, weights, device, bf16) for b in (BATCH, RAGGED_BATCH))


def phase_main_path_bf16(weights, device):
    """`make_predict_step(compute_dtype=torch.bfloat16)` over the main path's
    64 ingested fixture videos at the shipped inference batch size, with the
    launch counts read around it: K1 (its bf16 mode) once per batch, nothing
    else; the pixel boxes against the plain bf16 loop's."""
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.data.ingest import batches, ingest_directory
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
    from objectpermanence_tpu_torch.models.registry import init_model
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference
    work = WORK_DIR / "main_path_bf16"
    shutil.rmtree(work, ignore_errors=True)
    pred_dir, labels_dir, _ = write_fixture_dataset(work / "data", num_videos=MAIN_PATH_VIDEOS,
                                                    seed=5)
    batch_size = json.loads((REPO / "configs" / "inference_config.json").read_text())["batch_size"]
    config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    spec, model = init_model("opnet", config, checkpoint_path=str(FLAGSHIP_NPZ), device=device)
    dataset = ingest_directory(pred_dir, labels_dir, spec.feature_width)
    step = make_predict_step(spec, device=device, compute_dtype=torch.bfloat16)
    step32 = make_predict_step(spec, device=device)

    read = reset_launches()
    t0 = time.perf_counter()
    predicted = torch.cat([step(model, b["boxes"]) for b in batches(dataset, batch_size)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read()
    chunks = -(-len(dataset.names) // batch_size)
    assert counts["K1"] == chunks and sum(counts.values()) == chunks, counts
    assert predicted.shape == (MAIN_PATH_VIDEOS, FRAMES, 4) and predicted.dtype == torch.int32
    boxes = torch.from_numpy(dataset.boxes).to(device)
    want_y, _ = opnet_forward_reference(boxes, *weights, compute_dtype=torch.bfloat16)
    px_max, px_share = pixel_diff(predicted, denormalize_boxes(want_y))
    fp32 = torch.cat([step32(model, b["boxes"]) for b in batches(dataset, batch_size)])
    moved = (predicted.to(torch.int64) - fp32.to(torch.int64)).abs()
    log("main_path_bf16", videos=MAIN_PATH_VIDEOS, frames=FRAMES, batch_size=batch_size,
        launches=json.dumps(counts), seconds=f"{seconds:.3f}", px_max_diff_vs_plain=px_max,
        px_diff_share=px_share, fp32_boxes_moved=int((moved.amax(-1) > 0).sum()),
        fp32_px_max_diff=int(moved.max()))
    assert px_max <= PX_MAX and px_share <= PX_SHARE, "bf16 main path disagrees with plain"
    return counts["K1"]


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
    assert all(counts[k] == 0 for k in ("K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")), \
        f"inference ran other kernels: {counts}"

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
    hs_again, cs_again = lstm_scan_forward(xproj, w_hh)
    torch.cuda.synchronize()
    want_hs, want_cs = lstm_scan_forward_reference(xproj, w_hh)
    assert torch.isfinite(hs).all() and torch.isfinite(cs).all(), "non-finite K2 output"
    assert torch.equal(hs, hs_again) and torch.equal(cs, cs_again), "two K2 calls differ"
    assert torch.equal(hs_only, hs), "K4's hs is not K2's"

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


def compare_k4(layer, batch, weights, device):
    """K4 alone at an eval batch against the plain loop; two calls bitwise
    equal."""
    from objectpermanence_tpu_torch.ops.lstm_scan import lstm_scan_forward_reference, lstm_scan_hs
    x, w_ih, w_hh, _ = lstm_case(layer, batch, weights, device)
    xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
    hs, hs_again = lstm_scan_hs(xproj, w_hh), lstm_scan_hs(xproj, w_hh)
    torch.cuda.synchronize()
    want_hs, _ = lstm_scan_forward_reference(xproj, w_hh)
    err = max_err(hs, want_hs)
    log("lstm_vs_plain", layer=layer, batch=batch, frames=FRAMES, kernel="K4",
        max_abs_err_hs_only=err, bitwise_repeat=torch.equal(hs, hs_again))
    assert torch.isfinite(hs).all() and err <= ATOL, f"K4 disagrees with plain ({layer}, B={batch})"
    assert torch.equal(hs, hs_again), f"two K4 calls differ ({layer}, B={batch})"
    return err


def phase_lstm_vs_plain(weights, device):
    worst = {"K2": 0.0, "K3": 0.0, "K4": 0.0}
    for layer in LSTM_LAYERS:
        for batch in (TRAIN_BATCH, RAGGED_TRAIN_BATCH):
            for tag, err in compare_lstm(layer, batch, weights, device).items():
                worst[tag] = max(worst[tag], err)
        for batch in EVAL_BATCHES:
            worst["K4"] = max(worst["K4"], compare_k4(layer, batch, weights, device))
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


# the five learned architectures beside OPNet, at their shipped widths
# (configs/<name>_model_config.json; opnet_moe on OPNet's config with its defaults,
# 4 experts x 128): seeded weights, the served boxes (5 features for the baselines)
NEW_MODELS = ("baseline_lstm", "non_linear_lstm", "transformer_lstm", "opnet_lstm_mlp",
              "opnet_moe")
MODELS_SEED = 17
COMPAT_BATCH = 2     # transformer_lstm's reference_compat attends over all B*T tokens
MODELS_EPOCHS = 1    # models_path: the train path's 64 + 16 fixture videos, cut to 1 epoch


def model_setup(name, device, **overrides):
    """`(spec, the model on the CPU, its copy on the card)` from a seed, in
    eval mode, at the shipped config."""
    import copy
    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    config = {**load_model_config(name), **overrides}
    spec = get_model_spec(name, config)
    cpu = spec.build(config, torch.Generator().manual_seed(MODELS_SEED)).eval()
    return spec, cpu, copy.deepcopy(cpu).to(device)


def lstm_layers(model):
    from objectpermanence_tpu_torch.ops.lstm import LSTM
    return sum(isinstance(m, LSTM) for m in model.modules())


def compare_model(name, device, batch, **overrides):
    """One model's `forward_layers` on the card (K4) against the CPU's plain
    loop, and one train step's gradients on the card (K2/K3) against the
    CPU's, dropout off on both sides (eval mode); the launch counts read
    around each."""
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    spec, cpu, gpu = model_setup(name, device, **overrides)
    layers = lstm_layers(cpu)
    boxes = served_boxes(batch, device)[..., :spec.feature_width].contiguous()
    with np.load(BENCH_CACHE) as blob:
        labels = torch.from_numpy(blob["labels"][:batch, :FRAMES].astype(np.float32))
    labels = torch.from_numpy(np.tile(labels.numpy(), (-(-batch // len(labels)), 1, 1))[:batch])
    mask = torch.zeros(labels.shape, dtype=torch.bool)
    weights = torch.ones(batch)

    read = reset_launches()
    with torch.no_grad():
        got = gpu.forward_layers(boxes)
    torch.cuda.synchronize()
    forward_counts = read()
    with torch.no_grad():
        want = cpu.forward_layers(boxes.cpu())
    got, want = (got, want) if spec.double_output else ((got,), (want,))
    errs = {"y": max_err(got[0].cpu(), want[0])}
    if spec.double_output:
        errs["logits"] = max_err(got[1].cpu(), want[1])
    px_max, px_share = pixel_diff(denormalize_boxes(got[0]).cpu(), denormalize_boxes(want[0]))

    steps = {}
    for side, model, dev in (("card", gpu, device), ("cpu", cpu, torch.device("cpu"))):
        step = make_train_step(spec, make_optimizer(model.parameters(), 1e-3))
        read = reset_launches()
        metrics = step(model, boxes.to(dev), labels.to(dev), mask.to(dev), weights.to(dev))
        if side == "card":
            torch.cuda.synchronize()
            train_counts = read()
        steps[side] = (metrics, {k: p.grad.cpu() for k, p in model.named_parameters()})
    grad_errs = {k: max_err(g, steps["cpu"][1][k]) / grad_limit(steps["cpu"][1][k])
                 for k, g in steps["card"][1].items()}
    loss_err = abs(steps["card"][0]["loss"].item() - steps["cpu"][0]["loss"].item())
    worst = max(grad_errs, key=grad_errs.get)
    log("models_vs_plain", model=name, batch=batch, frames=FRAMES, lstm_layers=layers,
        **{f"max_abs_err_{k}": v for k, v in errs.items()}, px_max_diff_vs_plain=px_max,
        px_diff_share=px_share, loss_abs_err=loss_err,
        worst_grad=worst, worst_grad_err_over_limit=grad_errs[worst],
        forward_launches=json.dumps(forward_counts), train_launches=json.dumps(train_counts),
        **overrides)
    assert all(v <= ATOL for v in errs.values()), f"{name}: forward disagrees with plain {errs}"
    assert px_max <= PX_MAX and px_share <= PX_SHARE, f"{name}: pixel boxes disagree"
    assert grad_errs[worst] <= 1.0, f"{name}: gradient {worst} disagrees with plain"
    assert loss_err <= ATOL, f"{name}: train loss disagrees with plain"
    assert forward_counts["K4"] == layers and sum(forward_counts.values()) == layers, \
        f"{name}: forward launches {forward_counts}"
    assert train_counts["K2"] == train_counts["K3"] == layers and \
        sum(train_counts.values()) == 2 * layers, f"{name}: train launches {train_counts}"


def phase_models_vs_plain(device):
    """Each new architecture at its shipped width and the train batch of 16,
    and transformer_lstm with `reference_compat` at 2 videos."""
    for name in NEW_MODELS:
        compare_model(name, device, TRAIN_BATCH)
    compare_model("transformer_lstm", device, COMPAT_BATCH, reference_compat=True)


def phase_models_path(device):
    """For each new architecture, `python -m objectpermanence_tpu_torch
    training` at its shipped width on the train path's fixture splits (64 +
    16 videos, cut to 1 epoch), then `inference` from what it wrote, each
    with the launch counts read around it: K2 = K3 = LSTM layers x steps, K4
    in the eval step and in inference, K1 never. The written boxes are held
    against the CPU's plain forward on the same weights."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.config import load_model_config
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.models.registry import init_model
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.utils.checkpoint import trained_params

    work = WORK_DIR / "models_path"
    shutil.rmtree(work, ignore_errors=True)
    train = write_fixture_dataset(work / "train", num_videos=TRAIN_VIDEOS, seed=11)
    dev_pred, dev_labels, dev_cont = write_fixture_dataset(work / "dev", num_videos=DEV_VIDEOS,
                                                           seed=12)
    shipped = json.loads((REPO / "configs" / "training_config.json").read_text())
    shipped_inf = json.loads((REPO / "configs" / "inference_config.json").read_text())
    steps = MODELS_EPOCHS * -(-TRAIN_VIDEOS // shipped["batch_size"])
    totals = {}
    for name in NEW_MODELS:
        run = work / name
        run.mkdir()
        config = load_model_config(name)
        (run / "model.json").write_text(json.dumps(config))
        (run / "training.json").write_text(json.dumps({
            **shipped, "num_epochs": MODELS_EPOCHS, "print_step": 2,
            "checkpoints_path": str(run / "checkpoints"), "cache_dir": str(work / "cache"),
            "metrics_file": str(run / "metrics.jsonl"),
            "train_sample_dir": str(train[0]), "train_labels_dir": str(train[1]),
            "train_containment_file": str(train[2]), "dev_sample_dir": str(dev_pred),
            "dev_labels_dir": str(dev_labels), "dev_containment_file": str(dev_cont)}))
        read = reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["training", "--model_type", name, "--model_config",
                       str(run / "model.json"), "--training_config", str(run / "training.json")])
        torch.cuda.synchronize()
        train_seconds = time.perf_counter() - t0
        train_counts = read()
        assert rc == 0, f"{name}: training CLI exit {rc}"
        epoch = json.loads((run / "metrics.jsonl").read_text().splitlines()[-1])
        assert np.isfinite(epoch["train"]["loss"]) and np.isfinite(epoch["dev"]["loss"]), epoch
        model_path, read_from = trained_params(run / "checkpoints" / name, run / "metrics.jsonl")

        (run / "inference.json").write_text(json.dumps({
            **shipped_inf, "sample_dir": str(dev_pred), "labels_dir": str(dev_labels),
            "model_path": str(model_path), "videos_dir": None, "device": "cuda",
            "cache_dir": str(work / "cache")}))
        read = reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["inference", "--model_type", name, "--results_dir", str(run / "results"),
                       "--inference_config", str(run / "inference.json"),
                       "--model_config", str(run / "model.json")])
        torch.cuda.synchronize()
        inference_seconds = time.perf_counter() - t0
        inference_counts = read()
        assert rc == 0, f"{name}: inference CLI exit {rc}"

        files = sorted((run / "results").glob("*_bb.json"))
        predicted = np.stack([np.array(json.loads(f.read_text())) for f in files])
        assert predicted.shape == (DEV_VIDEOS, FRAMES, 4) and predicted.dtype.kind == "i"
        spec, model = init_model(name, config, checkpoint_path=str(model_path), device="cpu")
        dataset = ingest_directory(dev_pred, dev_labels, spec.feature_width)
        assert [f"{n}_bb.json" for n in dataset.names] == [f.name for f in files]
        with torch.no_grad():
            want = model.forward_layers(torch.from_numpy(dataset.boxes))
        want = want[0] if spec.double_output else want
        px_max, px_share = pixel_diff(torch.from_numpy(predicted), denormalize_boxes(want))
        layers = lstm_layers(model)
        log("models_path", model=name, train_videos=TRAIN_VIDEOS, dev_videos=DEV_VIDEOS,
            frames=FRAMES, epochs=MODELS_EPOCHS, steps=steps, lstm_layers=layers,
            train_seconds=f"{train_seconds:.3f}", inference_seconds=f"{inference_seconds:.3f}",
            train_launches=json.dumps(train_counts),
            inference_launches=json.dumps(inference_counts), read_from=read_from,
            train_loss=epoch["train"]["loss"], dev_loss=epoch["dev"]["loss"],
            dev_miou=epoch["dev"]["mean_iou"], px_max_diff_vs_plain=px_max,
            px_diff_share=px_share)
        assert train_counts["K1"] == inference_counts["K1"] == 0, f"{name} launched K1"
        assert train_counts["K2"] == train_counts["K3"] == layers * steps, train_counts
        assert train_counts["K4"] > 0 and inference_counts["K4"] > 0, (train_counts,
                                                                      inference_counts)
        assert inference_counts["K2"] == inference_counts["K3"] == 0, inference_counts
        assert px_max <= PX_MAX and px_share <= PX_SHARE, f"{name}: inference disagrees"
        for counts in (train_counts, inference_counts):
            for tag in ("K2", "K3", "K4"):
                totals[tag] = totals.get(tag, 0) + counts[tag]
    return totals


def phase_analysis_path():
    """`python -m objectpermanence_tpu_torch analysis` over the main path's
    predictions against the fixture's labels, with every annotation file
    the fixture writes."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    data = WORK_DIR / "data"
    out = WORK_DIR / "analysis.csv"
    read = reset_launches()
    rc = cli_main(["analysis", "--predictions_dir", str(WORK_DIR / "results"),
                   "--labels_dir", str(data / "labels"),
                   "--containment_annotations", str(data / "containment_annotations.txt"),
                   "--containment_only_static_annotations",
                   str(data / "containment_only_static.txt"),
                   "--containment_with_movements_annotations",
                   str(data / "containment_with_move.txt"),
                   "--visibility_ratio_gt_0", str(data / "visibility_rate_gt_0.txt"),
                   "--visibility_ratio_gt_30", str(data / "visibility_rate_gt_30.txt"),
                   "--visibility_ratio_gt_99", str(data / "visibility_rate_gt_99.txt"),
                   "--iou_thresholds", "0.5,0.9", "--output_file", str(out)])
    counts = read()
    assert rc == 0, f"analysis CLI exit {rc}"
    lines = out.read_text().splitlines()
    header = lines[0].split(",")
    overall = [float(line.split(",")[header.index("overall_iou")]) for line in lines[1:]]
    log("analysis_path", videos=len(lines) - 1, columns=len(header),
        mean_overall_iou=float(np.mean(overall)), launches=json.dumps(counts))
    assert len(lines) - 1 == MAIN_PATH_VIDEOS, f"{len(lines) - 1} rows"
    for column in ("overall_iou", "overall_map_0.5", "overall_map_0.9", "contained_mean_iou",
                   "full_occlusion_mean_iou", "visibility_gt_99_mean_map_0.9"):
        assert column in header, f"no {column} column"
    assert all(0.0 <= v <= 1.0 for v in overall), "IoU out of [0, 1]"
    assert sum(counts.values()) == 0, f"analysis launched kernels: {counts}"


def phase_cater_path(device):
    """`python -m objectpermanence_tpu_torch cater_inference` from the OPNet
    checkpoint tree of `phase_train_path` over its dev videos: K1 only, one
    class row per video, the classes those of the plain forward's last boxes
    (a box within a pixel of the plain one may cross a grid line)."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.homography import grid_classes_for_centers
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference
    from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint, load_params
    work = WORK_DIR / "train_path"
    inference = json.loads((work / "inference.json").read_text())
    read = reset_launches()
    rc = cli_main(["cater_inference", "--model_type", "opnet", "--results_dir",
                   str(WORK_DIR / "cater"), "--inference_config", str(work / "inference.json"),
                   "--model_config", str(REPO / "configs" / "opnet_model_config.json")])
    torch.cuda.synchronize()
    counts = read()
    assert rc == 0, f"cater_inference CLI exit {rc}"
    lines = (WORK_DIR / "cater" / "class_pred_results.csv").read_text().splitlines()
    assert lines[0] == "video_names,class_predictions", lines[0]
    rows = [line.split(",") for line in lines[1:]]
    classes = np.array([int(c) for _, c in rows])

    dataset = ingest_directory(inference["sample_dir"], inference["labels_dir"], 6)
    assert [n for n, _ in rows] == [f"{n}.avi" for n in dataset.names]
    state = load_params(best_params_checkpoint(inference["model_path"]))
    trained = [state[k].to(device) for k in ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w",
                                             "video_lstm.w_ih", "video_lstm.w_hh",
                                             "box_head.w")]
    want_y, _ = opnet_forward_reference(torch.from_numpy(dataset.boxes).to(device), *trained)
    last = denormalize_boxes(want_y)[:, -1].cpu().numpy().astype(np.float64)
    want = grid_classes_for_centers(np.stack([(last[:, 0] + last[:, 2]) / 2,
                                              (last[:, 1] + last[:, 3]) / 2], -1))
    log("cater_path", videos=len(rows), launches=json.dumps(counts),
        classes_equal_plain=int((classes == want).sum()), distinct_classes=len(set(classes)))
    assert len(rows) == DEV_VIDEOS and classes.min() >= 0 and classes.max() < 36
    assert counts["K1"] > 0 and sum(counts.values()) == counts["K1"], counts
    assert (classes != want).sum() <= 1, f"classes {classes} != plain {want}"


def phase_bench_torch():
    """`python3 bench_torch.py` in its own process on the card: its one
    JSON line, with `bench.py`'s keys."""
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    result = json.loads(lines[0])
    assert list(result) == ["metric", "value", "unit", "vs_baseline", "compute_fps",
                            "compute_fps_bf16", "link_efficiency", "data"], result
    assert result["value"] > 0 and result["compute_fps"] > 0 and result["compute_fps_bf16"] > 0
    print("[bench_torch] " + lines[0], flush=True)
    return result


def profile_top(fn, calls, top=5):
    """A torch.profiler window of `calls` calls: the device's busy share of
    it and its `top` kernels' device ms per call."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        window_ms = time_ms(fn, iters=calls, warmup=0) * calls
    kernels = device_kernel_ms(prof)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return sum(kernels.values()) / window_ms, {name[:60]: ms / calls for name, ms in ranked}


def phase_models_step_profile(device, smi, steps=10):
    """Each new architecture at its shipped width: one train step at the
    train batch of 16 (train mode, dropout on for transformer_lstm, as
    training runs it) and one inference batch of 512 through
    `make_predict_step`, each the mean of `steps` calls (inference: half as
    many) by CUDA events, then a profiler window of each with the device's
    busy share and its leading kernels."""
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    for name in NEW_MODELS:
        spec, _, model = model_setup(name, device)
        boxes = served_boxes(TRAIN_BATCH, device)[..., :spec.feature_width].contiguous()
        with np.load(BENCH_CACHE) as blob:
            labels = torch.from_numpy(blob["labels"][:TRAIN_BATCH, :FRAMES].astype(np.float32))
        labels = labels.to(device)
        mask = torch.zeros(labels.shape, dtype=torch.bool, device=device)
        weights = torch.ones(TRAIN_BATCH, device=device)
        step = make_train_step(spec, make_optimizer(model.parameters(), 1e-3),
                               torch.Generator(device).manual_seed(MODELS_SEED))
        model.train()

        def train():
            step(model, boxes, labels, mask, weights)

        step_ms = time_ms(train, iters=steps)
        train_busy, train_top = profile_top(train, calls=2)
        model.eval()
        served = served_boxes(BATCH, device)[..., :spec.feature_width].contiguous()
        predict = make_predict_step(spec, device=device)
        torch.cuda.reset_peak_memory_stats()
        infer_ms = time_ms(lambda: predict(model, served), iters=steps // 2)
        infer_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        infer_busy, infer_top = profile_top(lambda: predict(model, served), calls=1)
        log("models_step_profile", model=name, train_batch=TRAIN_BATCH, infer_batch=BATCH,
            frames=FRAMES, train_step_ms=step_ms,
            train_samples_per_s=TRAIN_BATCH / (step_ms / 1e3), train_busy_share=train_busy,
            train_top_ms=json.dumps(train_top), infer_ms=infer_ms,
            infer_frames_per_s=BATCH * FRAMES / (infer_ms / 1e3), infer_busy_share=infer_busy,
            infer_top_ms=json.dumps(infer_top), infer_peak_gib=infer_peak, card=repr(smi))
        del model, step
        torch.cuda.empty_cache()


class CudnnOPNet(torch.nn.Module):
    """Yardstick only, never used by the port: the same function from
    library calls, two cuDNN LSTMs with the softmax selection between, in
    float32 or (`dtype=torch.bfloat16`) on bf16 weights and boxes."""

    def __init__(self, w1_ih, w1_hh, w_att, w2_ih, w2_hh, w_head, dtype=torch.float32):
        super().__init__()
        self.lstm1 = torch.nn.LSTM(w1_ih.shape[0], w1_hh.shape[0], bias=False, batch_first=True)
        self.lstm2 = torch.nn.LSTM(w2_ih.shape[0], w2_hh.shape[0], bias=False, batch_first=True)
        with torch.no_grad():
            self.lstm1.weight_ih_l0.copy_(w1_ih.t())
            self.lstm1.weight_hh_l0.copy_(w1_hh.t())
            self.lstm2.weight_ih_l0.copy_(w2_ih.t())
            self.lstm2.weight_hh_l0.copy_(w2_hh.t())
        self.to(dtype)
        self.w_att, self.w_head, self.dtype = w_att.to(dtype), w_head.to(dtype), dtype

    def forward(self, boxes):
        boxes = boxes.to(self.dtype)
        b, t, o, f = boxes.shape
        h1, _ = self.lstm1(boxes.reshape(b, t, o * f))
        logits = h1 @ self.w_att
        selected = torch.einsum("btof,bto->btf", boxes, torch.softmax(logits, dim=-1))
        h2, _ = self.lstm2(selected)
        return h2 @ self.w_head, logits.transpose(1, 2)


def phase_times(weights, device, launches, max_abs_err, compute_dtype=torch.float32):
    """K1 (or its bf16 operand mode) at B=512, T=300 beside its bound, its
    plain version and cuDNN's LSTMs composing the same function in the same
    dtype (`CudnnOPNet`), in turns: plain, kernel, library, kernel, plain;
    the bf16 mode times float32 K1 in the same turns, after each kernel
    turn. Then the kernel and the library at the CLI's batch (B=16), in
    turns kernel, library, kernel. The bound (scripts/kernel_bounds.py)
    counts the operands' bytes; the products take float32 carries, which
    the bf16 tensor cores cannot take without rounding them, so the bf16
    mode stays at the fp32 peak."""
    from objectpermanence_tpu_torch.ops.opnet_fused import (
        opnet_forward_reference, opnet_fused_forward,
    )
    sys.path.insert(0, str(REPO / "scripts"))
    import kernel_bounds as kb
    bf16 = compute_dtype == torch.bfloat16
    boxes = served_boxes(BATCH, device)
    library = CudnnOPNet(*weights, dtype=compute_dtype).to(device)

    def kernel():
        return opnet_fused_forward(boxes, *weights, compute_dtype=compute_dtype)

    def plain():
        return opnet_forward_reference(boxes, *weights, compute_dtype=compute_dtype)

    def f32():
        return opnet_fused_forward(boxes, *weights)

    with torch.inference_mode():
        lib_y, _ = library(boxes)
        library_err = (lib_y.float() - kernel()[0]).abs().max().item()
        plain_a = time_ms(plain, iters=3, warmup=1)
        kernel_a = time_ms(kernel, iters=20)
        f32_runs = [time_ms(f32, iters=20)] if bf16 else []
        library_ms = time_ms(lambda: library(boxes), iters=10)
        kernel_b = time_ms(kernel, iters=20)
        f32_runs += [time_ms(f32, iters=20)] if bf16 else []
        plain_b = time_ms(plain, iters=3, warmup=1)
        small = served_boxes(cli_batch(), device)
        small_runs = [time_ms(lambda: opnet_fused_forward(small, *weights,
                                                          compute_dtype=compute_dtype), iters=20)]
        library_ms_b16 = time_ms(lambda: library(small), iters=20)
        small_runs.append(time_ms(lambda: opnet_fused_forward(small, *weights,
                                                              compute_dtype=compute_dtype),
                                  iters=20))
    kernel_ms, plain_ms = (kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2

    batch, frames, objects, feat = boxes.shape
    _, flops, bytes_ = kb.opnet_fused(batch, frames, objects, feat, weights[1].shape[0],
                                      weights[4].shape[0], itemsize=2 if bf16 else 4)
    t_ops, t_bytes = flops / kb.PEAK_FLOPS, bytes_ / kb.PEAK_BYTES
    bound_ms, bound_by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
    fields = {"f32_kernel_ms": sum(f32_runs) / 2, "f32_kernel_ms_runs": f32_runs} if bf16 else {}
    log("times", kernel="K1_bf16" if bf16 else "K1", batch=batch, frames=frames,
        kernel_ms=kernel_ms, kernel_ms_runs=[kernel_a, kernel_b], **fields, plain_ms=plain_ms,
        plain_ms_runs=[plain_a, plain_b], library_ms=library_ms,
        library_max_abs_err_y=library_err, frames_per_s=batch * frames / (kernel_ms / 1e3),
        kernel_ms_b16=sum(small_runs) / 2, kernel_ms_b16_runs=small_runs,
        library_ms_b16=library_ms_b16,
        gflop=flops / 1e9, mbytes=bytes_ / 1e6, bound_ms=bound_ms, bound_by=bound_by,
        bound_peak="fp32 67 TFLOP/s")
    return {"name": "opnet_fused_forward (bf16)" if bf16 else "opnet_fused_forward",
            "route": "cuda", "source": "objectpermanence_tpu_torch/csrc/opnet_fused.cu",
            "replaces": "objectpermanence_tpu/ops/pallas_scan.py:485",
            "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def cudnn_lstm(w_ih, w_hh, device):
    """Yardstick only: cuDNN's nn.LSTM(bias=False) with the layer's weights."""
    cudnn = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], bias=False, batch_first=True).to(device)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(w_ih.t())
        cudnn.weight_hh_l0.copy_(w_hh.t())
    return cudnn


def time_in_turns(kernel, plain, library, bound):
    """kernel, plain and library in turns plain, kernel, library, kernel,
    library, plain, beside the bound: a row of the kernels line."""
    plain_a = time_ms(plain, iters=2, warmup=1)
    kernel_a = time_ms(kernel, iters=20)
    library_a = time_ms(library, iters=20)
    kernel_b = time_ms(kernel, iters=20)
    library_b = time_ms(library, iters=20)
    plain_b = time_ms(plain, iters=2, warmup=1)
    return {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
            "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
            "library_ms": (library_a + library_b) / 2, "library_ms_runs": [library_a, library_b],
            "bound_ms": bound[0], "bound_by": bound[1]}


def time_lstm_layer(layer, weights, device):
    """K2, K3, K4, their plain versions and cuDNN's nn.LSTM(bias=False) at
    the training batch, and K4 at the eval batches (`EVAL_BATCHES`), each in
    turns (`time_in_turns`). K2 and K4's yardstick is cuDNN's forward without
    a graph; K3's is cuDNN's backward alone, `torch.autograd.grad` through one
    kept forward graph (it also computes dx and dW_ih). K3's row adds
    `layer_ms`, K3 with `_LSTMScanFused.backward`'s two einsums for dW_ih and
    dx, the like-for-like figure. Returns the rows by tag, K4's at an eval
    batch as `K4@<batch>`."""
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
    cudnn = cudnn_lstm(w_ih, w_hh, device)
    x_leaf = x.detach().clone().requires_grad_(True)
    graph_out, _ = cudnn(x_leaf)  # one forward, its graph kept for every backward
    leaves = [x_leaf, cudnn.weight_ih_l0, cudnn.weight_hh_l0]

    def cudnn_forward():
        with torch.no_grad():
            cudnn(x)

    def cudnn_backward():
        torch.autograd.grad(graph_out, leaves, dout, retain_graph=True)

    def k3_layer():
        dxproj, _ = lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh)
        torch.einsum("btd,tbh->dh", x, dxproj)
        torch.einsum("tbh,dh->btd", dxproj, w_ih)

    calls = {
        "K2": (lambda: lstm_scan_forward(xproj, w_hh),
               lambda: lstm_scan_forward_reference(xproj, w_hh), cudnn_forward),
        "K3": (lambda: lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh),
               lambda: lstm_scan_backward_reference(xproj, h_prev, c_prev, cs, dh_out, w_hh),
               cudnn_backward),
        "K4": (lambda: lstm_scan_hs(xproj, w_hh),
               lambda: lstm_scan_forward_reference(xproj, w_hh), cudnn_forward),
    }
    bounds = lstm_bounds(TRAIN_BATCH, FRAMES, w_hh.shape[0])
    rows = {}
    for tag, (kernel, plain, library) in calls.items():
        rows[tag] = time_in_turns(kernel, plain, library, bounds[tag])
        if tag == "K3":
            rows[tag]["layer_ms"] = time_ms(k3_layer, iters=20)
        log("times", kernel=tag, layer=layer, batch=TRAIN_BATCH, frames=FRAMES,
            hidden=w_hh.shape[0], **rows[tag])
    for batch in EVAL_BATCHES:
        x, w_ih, w_hh, _ = lstm_case(layer, batch, weights, device)
        xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
        cudnn = cudnn_lstm(w_ih, w_hh, device)

        def cudnn_eval(cudnn=cudnn, x=x):
            with torch.no_grad():
                cudnn(x)

        row = time_in_turns(lambda: lstm_scan_hs(xproj, w_hh),
                            lambda: lstm_scan_forward_reference(xproj, w_hh), cudnn_eval,
                            lstm_bounds(batch, FRAMES, w_hh.shape[0])["K4"])
        rows[f"K4@{batch}"] = row
        log("times", kernel="K4", layer=layer, batch=batch, frames=FRAMES,
            hidden=w_hh.shape[0], **row)
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
    kernels = device_kernel_ms(prof)
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
    """The kernels line's rows for K2-K4 at H=512 (video_lstm): K2 and K3 at
    the training batch, K4 at the eval batch the train path runs (64); the
    H=256 layer (att_lstm), K4 at the other batches, are timed and logged
    beside them."""
    time_lstm_layer("att_lstm", weights, device)
    rows = time_lstm_layer("video_lstm", weights, device)
    rows["K4"] = rows[f"K4@{EVAL_BATCHES[0]}"]
    return [{"name": name, "route": "cuda",
             "source": "objectpermanence_tpu_torch/csrc/lstm_scan.cu", "replaces": site,
             "launches": launches[tag], "max_abs_err": errors[tag], "ms": rows[tag]["ms"],
             "plain_ms": rows[tag]["plain_ms"], "bound_ms": rows[tag]["bound_ms"],
             "bound_by": rows[tag]["bound_by"], "library_ms": rows[tag]["library_ms"]}
            for tag, (name, site) in LSTM_KERNELS.items()]

def detector_setup(device):
    """A full-width detector at the shipped preprocess config, from the
    port's seeded init (the repository holds no detector weights)."""
    from objectpermanence_tpu_torch.config import preprocess_config_from
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    _, overrides = preprocess_config_from(json.loads(PREPROCESS_CONFIG.read_text()))
    return CaterDetector(DetectorConfig(**overrides), device=device)


def fixture_video(path, seed=DETECTOR_SEED):
    """Stands in for `read_video_frames` (no video file or codec needed):
    the 300 frames of fixture video `CATER_fixture_<v>`, its `make_scene`
    scene drawn by `draw_frames`."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    v = int(Path(path).stem.rsplit("_", 1)[1])
    return draw_frames(make_scene(seed * 1000 + v), seed=v)


EDGE_ROIS = [[10.2, 20.7, 10.6, 21.1], [-30.0, 200.0, 25.0, 260.0], [300.0, -50.0, 420.0, 10.0],
             [-5.0, -5.0, 595.0, 600.0], [0.0, 0.0, 0.0, 0.0], [319.5, 255.5, 320.0, 256.0]]


def detector_rois(detector, frames, edge_rois=EDGE_ROIS):
    """P2..P5 and the proposals the detector makes of `frames`, with edge
    cases written over image 0's first rois (at the native geometry:
    sub-pixel, across and beyond the image edge, 600 px, and an all-zero
    padding box)."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        forward_features, preprocess_images, propose,
    )
    from objectpermanence_tpu_torch.models.detector.roi_heads import assign_levels
    with torch.inference_mode():
        images = torch.from_numpy(frames).to(detector.device)
        pyramid = forward_features(detector.model, preprocess_images(images, detector.config))
        proposals, _ = propose(detector.model, pyramid, detector.config, detector.anchors)
    edge = torch.tensor(edge_rois, device=proposals.device)
    rois = proposals.clone()
    rois[0, :len(edge)] = edge
    return [p.detach() for p in pyramid[:4]], rois, assign_levels(rois)


def roi_err(got, want):
    err = (got - want).abs().max().item()
    return err, ROI_RTOL * max(1.0, want.abs().max().item())


def roi_pixels_read(feats, rois, levels, window=None):
    """The (image, level, pixel) taps that the rois `(B, N)` reach with a
    nonzero weight from a sample inside their level (inside their window,
    with the windowed RoIAlign's `window`): the least a RoIAlign forward
    must read, all C channels of each, for scripts/kernel_bounds.py."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align import _geometry
    shapes = [tuple(f.shape[-2:]) for f in feats]
    scales = 1.0 / torch.tensor(ROI_STRIDES, dtype=torch.float32, device=rois.device)
    table = sum(h * w for h, w in shapes)
    taps = []
    for b in range(rois.shape[0]):
        rows, weights, inside = _geometry(shapes, rois[b], levels[b], scales, 7, 2, window)
        taps += [b * table + row[(weight != 0) & inside] for row, weight in zip(rows, weights)]
    return int(torch.unique(torch.cat(taps)).numel())


def roi_bound(feats, rois, levels, images, window=None):
    """bound_ms, what bounds it and the MB moved for a RoIAlign forward of
    `images` images from scripts/kernel_bounds.py, with the pixels this run's
    rois reach; and the bound if the whole pyramid were read."""
    sys.path.insert(0, str(REPO / "scripts"))
    import kernel_bounds as kb
    shapes = [tuple(f.shape[-2:]) for f in feats]
    common = dict(images=images, channels=feats[0].shape[1], itemsize=feats[0].element_size())
    pixels = roi_pixels_read(feats, rois[:images], levels[:images], window)
    _, flops, bytes_ = kb.roi_align(shapes, rois.shape[1], pixels_read=pixels, **common)
    _, _, whole = kb.roi_align(shapes, rois.shape[1], **common)
    t_ops, t_bytes = flops / kb.PEAK_FLOPS, bytes_ / kb.PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mbytes": bytes_ / 1e6, "gflop": flops / 1e9, "pixels_read": pixels,
            "pyramid_pixels": images * sum(h * w for h, w in shapes),
            "whole_pyramid_bound_ms": max(t_ops, whole / kb.PEAK_BYTES) * 1e3}


def phase_roi_align_vs_plain(detector):
    """K7 against its plain version at the detector's shapes (B=30 frames,
    N=300 proposals, C=256, the native pyramid as the backbone leaves it) and ragged (B=7, N=123); K5 and K6 at B=1."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_reference, roi_align_single, roi_align_tiled,
    )
    frames = fixture_video("CATER_fixture_000000")[:CHUNK]
    feats, rois, levels = detector_rois(detector, frames)
    errors = {}
    cases = [("K7", CHUNK, rois.shape[1]), ("K7", 7, 123)]
    for tag, batch, n in cases:
        args = ([f[:batch] for f in feats], rois[:batch, :n].contiguous(),
                levels[:batch, :n].contiguous(), ROI_STRIDES)
        got = roi_align_batched(*args)
        torch.cuda.synchronize()
        want = roi_align_batched_reference(*args)
        err, limit = roi_err(got, want)
        log("roi_align_vs_plain", kernel=tag, batch=batch, rois=n, channels=feats[0].shape[1],
            max_abs_err=err, limit=limit, max_abs_ref=want.abs().max().item(),
            levels_used=sorted(set(args[2].flatten().tolist())))
        assert torch.isfinite(got).all() and err <= limit, f"K7 disagrees at B={batch}, N={n}"
        errors[tag] = max(errors.get(tag, 0.0), err)
    one = ([f[0] for f in feats], rois[0].contiguous(), levels[0].contiguous(), ROI_STRIDES)
    want = multilevel_roi_align(*one)
    for tag, fn in (("K5", roi_align_single), ("K6", roi_align_tiled)):
        got = fn(*one)
        torch.cuda.synchronize()
        err, limit = roi_err(got, want)
        log("roi_align_vs_plain", kernel=tag, batch=1, rois=one[1].shape[0], max_abs_err=err,
            limit=limit)
        assert err <= limit, f"{tag} disagrees with plain"
        errors[tag] = err
    return errors, (feats, rois, levels)


def read_pickles(results):
    import pickle
    out = {}
    for path in sorted(Path(results).glob("*.pkl")):
        with open(path, "rb") as f:
            out[path.stem] = pickle.load(f)
    return out


def phase_preprocess_path(device):
    """`python -m objectpermanence_tpu_torch preprocess` at the shipped config
    on fixture videos, with the launch counts read around it; one video again
    with the plain RoIAlign swapped in, as the comparison; then the pickles
    through OPNet `inference` from the flagship weights. The fixture frames
    stand in for the decoder only while preprocess runs."""
    from unittest import mock

    import objectpermanence_tpu_torch.models.detector.detector as det_module
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.infer import preprocess
    from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_batched_reference

    work = WORK_DIR / "preprocess_path"
    shutil.rmtree(work, ignore_errors=True)
    _, labels_dir, _ = write_fixture_dataset(work / "data", num_videos=DETECTOR_VIDEOS,
                                             seed=DETECTOR_SEED)
    names = sorted(p.name[:-len("_bb.json")] for p in labels_dir.glob("*_bb.json"))
    videos = work / "videos"
    videos.mkdir()
    for name in names:
        (videos / f"{name}.avi").touch()
    config = {**json.loads(PREPROCESS_CONFIG.read_text()), "videos_dir": str(videos),
              "device": "cuda"}
    (work / "preprocess.json").write_text(json.dumps(config))
    results = work / "results"

    with mock.patch.object(preprocess, "read_video_frames", fixture_video):
        read = reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["preprocess", "--results_dir", str(results),
                       "--config", str(work / "preprocess.json")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read()
    assert rc == 0, f"preprocess CLI exit {rc}"
    data = read_pickles(results)
    assert sorted(data) == names, f"videos written: {sorted(data)} of {names}"
    chunks = -(-FRAMES // config["batch_size"])
    assert launches["K7"] == chunks * len(names), f"K7 launches {launches}"
    assert all(launches[k] == 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K8", "K9")), \
        launches
    kept = 0
    for name, video in data.items():
        assert set(video) == {"bb", "labels"} and len(video["bb"]) == len(video["labels"]) == FRAMES
        for bb, labels in zip(video["bb"], video["labels"]):
            assert bb.dtype == np.float32 and labels.dtype == np.int64
            assert bb.shape == (len(labels), 4) and np.isfinite(bb).all()
            kept += len(bb)
    assert kept > 0, "the detector kept no detection"

    # the same first video with the plain RoIAlign in the kernel's place
    (work / "sample.txt").write_text(f"{names[0]}\n")
    with mock.patch.object(preprocess, "read_video_frames", fixture_video), \
            mock.patch.object(det_module, "roi_align_batched", roi_align_batched_reference):
        preprocess.preprocess_main(str(work / "plain"),
                                   {**config, "sample_file": str(work / "sample.txt")})
    plain = read_pickles(work / "plain")[names[0]]
    ours = data[names[0]]
    flipped, box_diff = 0, 0.0
    for bb, labels, pbb, plabels in zip(ours["bb"], ours["labels"], plain["bb"], plain["labels"]):
        if len(labels) != len(plabels) or not np.array_equal(labels, plabels):
            flipped += 1
        elif len(bb):
            box_diff = max(box_diff, float(np.abs(bb - pbb).max()))
    log("preprocess_path", videos=len(names), frames=FRAMES, batch_size=config["batch_size"],
        seconds=f"{seconds:.3f}", frames_per_s=len(names) * FRAMES / seconds,
        launches=json.dumps(launches), kept_detections=kept,
        kept_per_frame=kept / (len(names) * FRAMES), plain_roi_flipped_frames=flipped,
        plain_roi_max_box_diff_px=box_diff)
    assert flipped <= FRAME_FLIP_SHARE * FRAMES, f"{flipped} frames differ from plain RoIAlign"
    assert box_diff <= BOX_PX, f"boxes {box_diff} px from plain RoIAlign"

    # the two-stage path: the pickles through OPNet inference (K1)
    shipped_inf = json.loads((REPO / "configs" / "inference_config.json").read_text())
    tree = work / "checkpoints" / "opnet"
    tree.mkdir(parents=True)
    shutil.copy(FLAGSHIP_NPZ, tree / "19-08-26_0.514.npz")
    inference_config = {**shipped_inf, "sample_dir": str(results), "labels_dir": str(labels_dir),
                        "model_path": str(tree), "videos_dir": None, "device": "cuda",
                        "cache_dir": str(work / "cache")}
    (work / "inference.json").write_text(json.dumps(inference_config))
    read = reset_launches()
    rc = cli_main(["inference", "--model_type", "opnet", "--results_dir", str(work / "bb"),
                   "--inference_config", str(work / "inference.json"),
                   "--model_config", str(REPO / "configs" / "opnet_model_config.json")])
    torch.cuda.synchronize()
    two_stage = read()
    files = sorted((work / "bb").glob("*_bb.json"))
    log("two_stage_inference", videos=len(files), launches=json.dumps(two_stage))
    assert rc == 0 and len(files) == len(names), f"two-stage inference: rc {rc}, {len(files)} files"
    assert two_stage["K1"] > 0 and two_stage["K7"] == 0, f"two-stage launches {two_stage}"
    boxes = np.stack([np.array(json.loads(f.read_text())) for f in files])
    assert boxes.shape == (len(names), FRAMES, 4) and boxes.dtype.kind == "i"
    return launches


def profile_chunk(detector, frames, chunks=5, profile_chunks=3):
    """Where one chunk of the detector spends its time: the four stages by
    CUDA events around each, the whole call by the host clock (frames up,
    detections down), then the device's busy share and top 8 kernels over a
    torch.profiler window of whole calls."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        batched_roi_align, forward_features, preprocess_images, propose,
    )
    from objectpermanence_tpu_torch.models.detector.roi_heads import postprocess_detections
    cfg, model = detector.config, detector.model
    images = torch.from_numpy(frames).to(detector.device)

    def staged():
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        with torch.inference_mode():
            events[0].record()
            pyramid = forward_features(model, preprocess_images(images, cfg))
            events[1].record()
            proposals, scores = propose(model, pyramid, cfg, detector.anchors)
            events[2].record()
            pooled = batched_roi_align(pyramid[:4], proposals, cfg)
            events[3].record()
            logits, deltas = model.roi_heads(pooled)
            postprocess_detections(logits, deltas, proposals, scores, cfg.padded_hw,
                                   cfg.score_thresh, cfg.nms_thresh, cfg.detections_per_img)
            events[4].record()
        torch.cuda.synchronize()
        return [events[i].elapsed_time(events[i + 1]) for i in range(4)]

    for _ in range(2):
        staged()
    runs = np.array([staged() for _ in range(chunks)])
    stage_ms = dict(zip(("backbone_fpn", "rpn_proposals", "roi_align", "box_head_postprocess"),
                        runs.mean(0).tolist()))
    detector(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        detector(frames)
    chunk_ms = (time.perf_counter() - t0) / chunks * 1e3

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(profile_chunks):
            detector(frames)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernel_ms(prof)
    busy_ms = sum(kernels.values())
    assert busy_ms > 0, "the profiler saw no device time"
    per_chunk = {name[:60]: ms / profile_chunks
                 for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    return {"frames": len(frames), "stage_ms": json.dumps(stage_ms),
            "stages_sum_ms": sum(stage_ms.values()), "chunk_ms": chunk_ms,
            "frames_per_s": len(frames) / (chunk_ms / 1e3), "window_ms": window_ms,
            "device_busy_share": busy_ms / window_ms, "per_chunk_ms": json.dumps(per_chunk)}


def phase_detect_profile(detector):
    """A 30-frame chunk at the shipped preprocess config (`profile_chunk`),
    then the pyramid's layout: NCHW (the detector's: cuDNN's native fp32
    layout) against channels_last (cuDNN transposes around its fp32
    convolutions), backbone+FPN and K7 together, in turns; K7 reads either
    in place."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        batched_roi_align, forward_features, preprocess_images, propose,
    )
    cfg, model = detector.config, detector.model
    frames = fixture_video("CATER_fixture_000001")[:CHUNK]
    fields = profile_chunk(detector, frames)
    images = torch.from_numpy(frames).to(detector.device)
    with torch.inference_mode():
        proposals, _ = propose(model, forward_features(model, preprocess_images(images, cfg)),
                               cfg, detector.anchors)

    def backbone_and_roi(memory_format):
        with torch.inference_mode():
            x = preprocess_images(images, cfg).contiguous(memory_format=memory_format)
            batched_roi_align(model.backbone(x)[:4], proposals, cfg)

    layouts = {"channels_last": torch.channels_last, "nchw": torch.contiguous_format}
    layout_runs = {name: [] for name in layouts}
    for name in ("channels_last", "nchw", "nchw", "channels_last"):
        layout_runs[name].append(time_ms(lambda: backbone_and_roi(layouts[name]), iters=5))
    log("detect_profile", **fields, backbone_fpn_k7_ms_by_layout=json.dumps(layout_runs))


def det800_detector(device, compute_dtype, **overrides):
    """The 800 px recipe's detector (DET800) at full width, seeded init."""
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    return CaterDetector(DetectorConfig(**{**DET800, "compute_dtype": compute_dtype,
                                           **overrides}), device=device)


def det800_frames(count=DET800_BATCH):
    """The first `count` frames of the 800 px path's fixture video."""
    return fixture_video(f"CATER_fixture_{0:06d}", seed=DET800_SEED)[:count]


def phase_roi_align_windowed_vs_plain(det_bf16):
    """K9 and K7 (each in float32 and bfloat16) against their plain
    versions on the inputs of one 800 px bf16 chunk (B=8 frames, N=300
    proposals, C=256, P2-P5 of 200 x 272 to 25 x 34; the f32 cases read the
    same pyramid as float32: `detector_800px_run steptime`'s exact row runs
    K7 f32 at 800 px), with EDGE_ROIS_800 over image 0's first rois, and
    ragged (B=3, N=57). Limit 1e-4 x max(1, max |ref|). The count of
    out-of-contract rois K9 adds on the device equals the plain mask's, and
    is at least OUT_OF_CONTRACT_MIN."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_reference, roi_align_windowed,
        roi_align_windowed_reference,
    )
    feats16, rois, levels = detector_rois(det_bf16, det800_frames(), EDGE_ROIS_800)
    assert all(f.dtype == torch.bfloat16 for f in feats16), [f.dtype for f in feats16]
    feats32 = [f.float() for f in feats16]
    cases = {"K9_f32": (roi_align_windowed, roi_align_windowed_reference, feats32),
             "K9_bf16": (roi_align_windowed, roi_align_windowed_reference, feats16),
             "K7_bf16_800": (roi_align_batched, roi_align_batched_reference, feats16),
             "K7_f32_800": (roi_align_batched, roi_align_batched_reference, feats32)}
    shapes = [(h, w, s) for (h, w), s in zip([tuple(f.shape[-2:]) for f in feats16],
                                             ROI_STRIDES)]
    errors = {}
    for tag, (kernel, plain, feats) in cases.items():
        for batch, n in ((DET800_BATCH, rois.shape[1]), (3, 57)):
            args = ([f[:batch] for f in feats], rois[:batch, :n].contiguous(),
                    levels[:batch, :n].contiguous(), ROI_STRIDES)
            window_lib.reset_contract_stats()
            got = kernel(*args)
            torch.cuda.synchronize()
            stats = window_lib.contract_stats()
            want = plain(*args)
            err, limit = roi_err(got, want)
            fields = {}
            if tag.startswith("K9"):
                mask = window_lib.windowed_out_of_contract_mask(
                    args[1], args[2], shapes, channels=feats[0].shape[1],
                    itemsize=feats[0].element_size())
                fields = {"contract_stats": json.dumps(stats),
                          "plain_out_of_contract": int(mask.sum())}
                assert stats == {"rois": mask.numel(), "out_of_contract": int(mask.sum())}, fields
                assert stats["out_of_contract"] >= OUT_OF_CONTRACT_MIN, fields
            log("roi_align_windowed_vs_plain", kernel=tag, batch=batch, rois=n,
                channels=feats[0].shape[1], max_abs_err=err, limit=limit,
                max_abs_ref=want.abs().max().item(),
                levels_used=sorted(set(args[2].flatten().tolist())), **fields)
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.isfinite(got).all() and err <= limit, f"{tag} disagrees at B={batch}, N={n}"
            errors[tag] = max(errors.get(tag, 0.0), err)
    window_lib.reset_contract_stats()
    return errors, (feats32, feats16, rois, levels)


def native_bf16_detector(device):
    """The shipped native-geometry config (configs/preprocess_config.json)
    in bf16: its pyramid passes the 8 MiB test, so "auto" runs K7's bf16
    mode."""
    from objectpermanence_tpu_torch.config import preprocess_config_from
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    _, shipped = preprocess_config_from(json.loads(PREPROCESS_CONFIG.read_text()))
    return CaterDetector(DetectorConfig(**shipped, compute_dtype="bfloat16"), device=device)


def phase_roi_align_bf16_vs_plain(device):
    """K7's bfloat16 mode against its plain version where the main path
    launches it (`preprocess_800_path`'s native_bf16 chunk): on that chunk's
    pyramid and proposals (B=8 frames, N=300, C=256, P2-P5 of 64 x 80 to
    8 x 10) with EDGE_ROIS over image 0, and ragged (B=3, N=57). Limit
    1e-4 x max(1, max |ref|)."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched, roi_align_batched_reference,
    )
    feats, rois, levels = detector_rois(native_bf16_detector(device), det800_frames())
    assert all(f.dtype == torch.bfloat16 for f in feats), [f.dtype for f in feats]
    worst = 0.0
    for batch, n in ((DET800_BATCH, rois.shape[1]), (3, 57)):
        args = ([f[:batch] for f in feats], rois[:batch, :n].contiguous(),
                levels[:batch, :n].contiguous(), ROI_STRIDES)
        got = roi_align_batched(*args)
        torch.cuda.synchronize()
        want = roi_align_batched_reference(*args)
        err, limit = roi_err(got, want)
        log("roi_align_bf16_vs_plain", kernel="K7_bf16", batch=batch, rois=n,
            shapes=[tuple(f.shape[-2:]) for f in feats], max_abs_err=err, limit=limit,
            max_abs_ref=want.abs().max().item(),
            levels_used=sorted(set(args[2].flatten().tolist())))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert torch.isfinite(got).all() and err <= limit, f"K7 bf16 disagrees at B={batch}, N={n}"
        worst = max(worst, err)
    return worst, (feats, rois, levels)


def phase_roi_align_bf16_grad_native_vs_plain(inputs):
    """K8 with bf16 dF on the native-geometry bf16 pyramid
    (`detector_transfer_demo --bf16` trains there; the 800 px shape is
    `phase_roi_align_bf16_grad_vs_plain`'s): `phase_roi_align_bf16_vs_plain`'s
    inputs (B=8, N=300, C=256, P2-P5 of 64 x 80 to 8 x 10, EDGE_ROIS over
    image 0) with a seeded normal dOut, and ragged (B=3, N=57), against the
    plain backward rounded to bf16: within one bf16 ulp of max |ref| per
    level, as there; its float32 accumulators within 1e-4 x max(1, max |ref|)."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference,
    )
    feats, rois, levels = inputs
    shapes = [tuple(f.shape[-2:]) for f in feats]
    gen = torch.Generator().manual_seed(9)
    dout = torch.randn((*rois.shape[:2], feats[0].shape[1], 7, 7),
                       generator=gen).to(rois.device)
    worst = 0.0
    for batch, n in ((rois.shape[0], rois.shape[1]), (3, 57)):
        args = (dout[:batch, :n].contiguous(), rois[:batch, :n].contiguous(),
                levels[:batch, :n].contiguous(), shapes, ROI_STRIDES)
        accumulators = roi_align_batched_backward(*args)
        rounded = roi_align_batched_backward(*args, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        want = roi_align_batched_backward_reference(*args)
        errs, limits = zip(*[roi_err(g, w) for g, w in zip(accumulators, want)])
        ulps = [bf16_ulp(max(w.abs().max().item(), 1e-30)) for w in want]
        assert all(g.dtype == torch.bfloat16 and torch.isfinite(g).all() for g in rounded)
        bf16_errs = [(g.float() - w.to(torch.bfloat16).float()).abs().max().item()
                     for g, w in zip(rounded, want)]
        log("roi_align_bf16_grad_native_vs_plain", kernel="K8_bf16", batch=batch, rois=n,
            shapes=shapes, accumulators_max_abs_err_per_level=list(errs),
            accumulators_limit_per_level=list(limits), bf16_max_abs_err_per_level=bf16_errs,
            bf16_limit_per_level=ulps, levels_used=sorted(set(args[2].flatten().tolist())))
        assert all(e <= lim for e, lim in zip(errs, limits)), f"K8 disagrees at B={batch}, N={n}"
        assert all(e <= u for e, u in zip(bf16_errs, ulps)), (batch, n, bf16_errs, ulps)
        worst = max(worst, max(bf16_errs))
    return worst


def phase_preprocess_800_path(device):
    """`python -m objectpermanence_tpu_torch preprocess` at the 800 px bf16
    recipe (no geometry in the config: the 800 px defaults) on one 300-frame
    fixture video, with the launch counts read around it: K9 once per chunk
    of 8, nothing else. The same video again, and every valid detection of
    its first chunk, with the plain windowed RoIAlign in K9's place. Then
    one chunk each of the fp32 twin and of
    `CaterDetector(DetectorConfig())` (frozen BN, RPN 1000/1000, "auto"):
    K9 once, K7 never; and one chunk of the shipped native-geometry config
    in bf16: K7's bf16 mode once. The fixture frames stand in for the
    decoder only while preprocess runs."""
    from unittest import mock

    import objectpermanence_tpu_torch.models.detector.detector as det_module
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.infer import preprocess
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.ops.roi_align_kernel import roi_align_windowed_reference

    work = WORK_DIR / "preprocess_800_path"
    shutil.rmtree(work, ignore_errors=True)
    videos = work / "videos"
    videos.mkdir(parents=True)
    name = f"CATER_fixture_{0:06d}"
    (videos / f"{name}.avi").touch()
    config = {**DET800, "compute_dtype": "bfloat16", "batch_size": DET800_BATCH,
              "videos_dir": str(videos), "device": "cuda"}
    (work / "preprocess.json").write_text(json.dumps(config))
    decoder = mock.patch.object(preprocess, "read_video_frames",
                                lambda path: fixture_video(path, seed=DET800_SEED))

    with decoder:
        read = reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["preprocess", "--results_dir", str(work / "results"),
                       "--config", str(work / "preprocess.json")])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read()
    assert rc == 0, f"preprocess CLI exit {rc}"
    chunks = -(-FRAMES // DET800_BATCH)
    assert launches["K9"] == chunks, f"K9 launches {launches}"
    assert all(v == 0 for k, v in launches.items() if k != "K9"), launches
    ours = read_pickles(work / "results")[name]
    assert len(ours["bb"]) == len(ours["labels"]) == FRAMES
    kept = sum(len(bb) for bb in ours["bb"])
    assert all(np.isfinite(bb).all() and bb.dtype == np.float32 for bb in ours["bb"])

    # every valid detection of one chunk (seeded weights keep few above 0.8)
    det_bf16 = det800_detector(device, "bfloat16")
    frames = det800_frames()
    ours_chunk = det_bf16(frames)
    with decoder, mock.patch.object(det_module, "roi_align_windowed",
                                    roi_align_windowed_reference):
        preprocess.preprocess_main(str(work / "plain"), config)
        plain_chunk = det_bf16(frames)
    valid, plain_valid = ours_chunk[3], plain_chunk[3]
    assert valid.sum() > 0 and np.array_equal(valid, plain_valid), "valid detections differ"
    assert np.array_equal(ours_chunk[1][valid], plain_chunk[1][valid]), "labels differ"
    chunk_box_diff = float(np.abs(ours_chunk[0][valid] - plain_chunk[0][valid]).max())
    chunk_score_diff = float(np.abs(ours_chunk[2][valid] - plain_chunk[2][valid]).max())
    assert chunk_box_diff <= BOX_PX and chunk_score_diff <= 1e-5, (chunk_box_diff, chunk_score_diff)
    plain = read_pickles(work / "plain")[name]
    flipped, box_diff = 0, 0.0
    for bb, labels, pbb, plabels in zip(ours["bb"], ours["labels"], plain["bb"], plain["labels"]):
        if len(labels) != len(plabels) or not np.array_equal(labels, plabels):
            flipped += 1
        elif len(bb):
            box_diff = max(box_diff, float(np.abs(bb - pbb).max()))
    log("preprocess_800_path", videos=1, frames=FRAMES, batch_size=DET800_BATCH,
        seconds=f"{seconds:.3f}", frames_per_s=FRAMES / seconds, launches=json.dumps(launches),
        kept_detections=kept, kept_per_frame=kept / FRAMES, plain_roi_flipped_frames=flipped,
        plain_roi_max_box_diff_px=box_diff, chunk_valid_detections=int(valid.sum()),
        chunk_plain_max_box_diff_px=chunk_box_diff, chunk_plain_max_score_diff=chunk_score_diff)
    assert flipped <= FRAME_FLIP_SHARE * FRAMES, f"{flipped} frames differ from plain K9"
    assert box_diff <= BOX_PX, f"boxes {box_diff} px from plain K9"

    chunk_launches = {}
    for label, detector in (
            ("fp32_windowed", det800_detector(device, "float32")),
            ("default_config", CaterDetector(DetectorConfig(), device=device)),
            ("native_bf16", native_bf16_detector(device))):
        read = reset_launches()
        boxes, _, scores, valid = detector(frames)
        torch.cuda.synchronize()
        counts = read()
        chunk_launches[label] = counts
        assert boxes.shape == (DET800_BATCH, detector.config.detections_per_img, 4)
        assert np.isfinite(boxes[valid]).all() and np.isfinite(scores[valid]).all()
        want = "K7" if label == "native_bf16" else "K9"
        assert counts[want] == 1 and sum(counts.values()) == 1, (label, counts)
    log("preprocess_800_chunks", launches=json.dumps(chunk_launches))
    return {"K9_bf16": launches["K9"],
            "K9_f32": chunk_launches["fp32_windowed"]["K9"] + chunk_launches["default_config"]["K9"],
            "K7_bf16": chunk_launches["native_bf16"]["K7"]}


def phase_detect_800_profile(det_bf16, det_fp32):
    """One chunk of 8 frames at the 800 px recipe, in bf16 and in fp32
    (`profile_chunk`): stages, chunk time, busy share, top kernels."""
    frames = det800_frames()
    for label, detector in (("bf16", det_bf16), ("fp32", det_fp32)):
        log("detect_800_profile", compute_dtype=label, **profile_chunk(detector, frames))


ROI_KERNELS = {
    "K5": ("roi_align_single", "objectpermanence_tpu/ops/pallas_roi_align.py:290"),
    "K6": ("roi_align_tiled", "objectpermanence_tpu/ops/pallas_roi_align.py:468"),
    "K7": ("roi_align_batched", "objectpermanence_tpu/ops/pallas_roi_align.py:679"),
}


def phase_roi_times(inputs, launches, errors):
    """K7 at the detector's B=30, N=300 and K5/K6 at B=1, N=300, each beside
    its bound (scripts/kernel_bounds.py with the pixels the rois reach) and
    its plain version, in turns: plain, kernel, kernel, plain. `ms` is the wrapper's
    time on the NCHW levels the detector gives it, which the kernel reads in
    place; `channels_last_ms`, logged beside it with the launch plan, the
    same call on the levels in channels_last. No single PyTorch call
    computes RoIAlign (torchvision, which has one, is not installed), so
    library_ms is null."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops.roi_align import multilevel_roi_align
    feats, rois, levels = inputs
    last = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    channels = feats[0].shape[1]
    plan = json.dumps(rk.launch_plan(channels, 7, 2, feats[0].element_size()))

    def args(tag, levels_in):
        if tag == "K7":
            return (levels_in, rois, levels, ROI_STRIDES), rois.shape[0]
        return ([f[0] for f in levels_in], rois[0].contiguous(), levels[0].contiguous(),
                ROI_STRIDES), 1

    kernels = {"K5": rk.roi_align_single, "K6": rk.roi_align_tiled, "K7": rk.roi_align_batched}
    rows = []
    for tag in ("K5", "K6", "K7"):
        (main_args, images), (last_args, _) = args(tag, feats), args(tag, last)
        kernel = kernels[tag]
        plain = rk.roi_align_batched_reference if tag == "K7" else multilevel_roi_align
        with torch.inference_mode():
            plain_a = time_ms(lambda: plain(*main_args), iters=3, warmup=1)
            kernel_a = time_ms(lambda: kernel(*main_args), iters=20)
            last_ms = time_ms(lambda: kernel(*last_args), iters=20)
            kernel_b = time_ms(lambda: kernel(*main_args), iters=20)
            plain_b = time_ms(lambda: plain(*main_args), iters=3, warmup=1)
        row = {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
               "channels_last_ms": last_ms, "plan": plan,
               "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
               **roi_bound(feats, rois, levels, images)}
        log("times", kernel=tag, images=images, rois=rois.shape[1], channels=channels, **row)
        name, site = ROI_KERNELS[tag]
        rows.append({"name": name, "route": "cuda",
                     "source": "objectpermanence_tpu_torch/csrc/roi_align.cu", "replaces": site,
                     "launches": launches[tag], "max_abs_err": errors[tag], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None})
    return rows


def detection_sets(work):
    """The detector training path's data: 48 train and 16 dev fixture frames
    (`write_detection_fixture`: 2 frames from each of 24 + 8 scenes, their
    visible objects as ground truth), served from memory in place of
    `load_image`, as the card's machine has no PIL."""
    from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
    from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
    sets = []
    for split, scenes, seed in (("train", DET_TRAIN_SCENES, 31), ("dev", DET_DEV_SCENES, 32)):
        images_dir, csv_path, frames = write_detection_fixture(work / split, scenes, 2, seed=seed)
        data = DetectionDataset(images_dir, csv_path)
        data.load_image = frames.__getitem__
        sets.append(data)
    return sets


def dettrain_detector(device):
    """The dettrain recipe's detector at full width, from the port's seeded init."""
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    return CaterDetector(DetectorConfig(**DETTRAIN), device=device)


def train_batch(data, device, size=DET_BATCH):
    """The first shuffled batch of `size` frames and its ground truth, on the card."""
    batch = next(data.batches(size, shuffle=True, seed=0))
    return (torch.from_numpy(batch["images"]).to(device),
            torch.from_numpy(batch["gt_boxes"]).to(device),
            torch.from_numpy(batch["gt_labels"]).to(device).long(),
            torch.from_numpy(batch["gt_valid"]).to(device))


def phase_roi_align_grad_vs_plain(det, train_set):
    """K8 against its plain version at the training shape: the dettrain
    detector's pyramid of 8 fixture frames, its 300 proposals + the 20
    ground-truth rows (zero where invalid) per frame, edge rois over frame
    0's first ones, a seeded normal dOut; and ragged (B=3, N=57). Each level
    within 1e-4 x max(1, max |ref|), and two K8 calls on the same input
    bitwise equal (each sum has one owner, which takes the rois in order)."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        forward_features, preprocess_images, propose,
    )
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference,
    )
    cfg = det.config
    images, gt_boxes, _, _ = train_batch(train_set, det.device)
    with torch.no_grad():
        pyramid = forward_features(det.model, preprocess_images(images, cfg))
        proposals, _ = propose(det.model, pyramid, cfg, det.anchors)
    rois = torch.cat([proposals, gt_boxes * cfg.scale], dim=1)
    edge = torch.tensor([[10.2, 20.7, 10.6, 21.1], [-30.0, 200.0, 25.0, 260.0],
                         [300.0, -50.0, 420.0, 10.0], [-5.0, -5.0, 595.0, 600.0],
                         [0.0, 0.0, 0.0, 0.0], [319.5, 255.5, 320.0, 256.0]], device=rois.device)
    rois[0, :len(edge)] = edge
    levels = assign_levels(rois)
    shapes = [tuple(p.shape[-2:]) for p in pyramid[:4]]
    channels = pyramid[0].shape[1]
    gen = torch.Generator().manual_seed(8)
    dout = torch.randn((DET_BATCH, DET_ROIS, channels, 7, 7), generator=gen).to(rois.device)
    worst = 0.0
    for batch, n in ((DET_BATCH, DET_ROIS), (3, 57)):
        args = (dout[:batch, :n].contiguous(), rois[:batch, :n].contiguous(),
                levels[:batch, :n].contiguous(), shapes, ROI_STRIDES)
        got = roi_align_batched_backward(*args)
        again = roi_align_batched_backward(*args)
        torch.cuda.synchronize()
        want = roi_align_batched_backward_reference(*args)
        errs, limits, reruns = [], [], []
        for g, a, w in zip(got, again, want):
            assert torch.isfinite(g).all(), "non-finite K8 output"
            err, limit = roi_err(g, w)
            errs.append(err)
            limits.append(limit)
            reruns.append((g - a).abs().max().item())
        log("roi_align_grad_vs_plain", kernel="K8", batch=batch, rois=n, channels=channels,
            max_abs_err_per_level=errs, limit_per_level=limits,
            max_abs_ref_per_level=[w.abs().max().item() for w in want],
            run_to_run_max_abs_diff_per_level=reruns,
            levels_used=sorted(set(args[2].flatten().tolist())))
        assert all(e <= lim for e, lim in zip(errs, limits)), f"K8 disagrees at B={batch}, N={n}"
        assert all(r == 0.0 for r in reruns), f"K8 differs from run to run: {reruns}"
        worst = max(worst, max(errs))
    return worst, (dout, rois, levels, shapes, [p.detach() for p in pyramid[:4]])


def train800_recipe(compute_dtype="bfloat16", **overrides):
    return {**DET800, "compute_dtype": compute_dtype, **overrides}


def phase_roi_align_bf16_grad_vs_plain(device, train_set):
    """K8 with bf16 dF at the 800 px training shape (the train800 bf16
    detector's pyramid of 4 fixture frames, its 300 proposals + the 20
    ground-truth rows, EDGE_ROIS_800 over frame 0's first ones, a seeded
    normal dOut; and ragged, B=3, N=57), against the plain backward. Per
    level, K8's float32 accumulators (its float32 mode on the same input)
    within 1e-4 x max(1, max |ref|); the bf16 dF of both trainable Functions
    (`roi_align_trainable`: K7 + K8; `roi_align_windowed_trainable`: K9 +
    K8) within one bf16 ulp of max |ref| of the plain bf16 dF: K8 sums in
    another order than the plain scatter, which moves the float32 sums' last
    bits, which can move a rounding. Two calls of each mode bitwise equal."""
    from objectpermanence_tpu_torch.models.detector.detector import (
        forward_features, preprocess_images, propose,
    )
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES, assign_levels
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.ops.roi_align_kernel import (
        roi_align_batched_backward, roi_align_batched_backward_reference, roi_align_trainable,
        roi_align_windowed_trainable,
    )
    cfg, model, anchors = detector_training_setup(device, recipe=train800_recipe())
    images, gt_boxes, _, _ = train_batch(train_set, device, TRAIN800_BATCH)
    with torch.no_grad():
        pyramid = forward_features(model, preprocess_images(images, cfg))
        proposals, _ = propose(model, pyramid, cfg, anchors)
    rois = torch.cat([proposals, gt_boxes * cfg.scale], dim=1)
    rois[0, :len(EDGE_ROIS_800)] = torch.tensor(EDGE_ROIS_800, device=rois.device)
    levels = assign_levels(rois)
    feats = [p.detach() for p in pyramid[:4]]
    assert all(f.dtype == torch.bfloat16 for f in feats), [f.dtype for f in feats]
    shapes = [tuple(f.shape[-2:]) for f in feats]
    gen = torch.Generator().manual_seed(8)
    dout = torch.randn((TRAIN800_BATCH, rois.shape[1], feats[0].shape[1], 7, 7),
                       generator=gen).to(device)
    worst = 0.0
    for batch, n in ((TRAIN800_BATCH, rois.shape[1]), (3, 57)):
        args = (dout[:batch, :n].contiguous(), rois[:batch, :n].contiguous(),
                levels[:batch, :n].contiguous(), shapes, ROI_STRIDES)
        accumulators = roi_align_batched_backward(*args)
        again = roi_align_batched_backward(*args)
        rounded = [roi_align_batched_backward(*args, dtype=torch.bfloat16) for _ in range(2)]
        torch.cuda.synchronize()
        reruns = [max((a - b).abs().max().item(), (c.float() - d.float()).abs().max().item())
                  for a, b, c, d in zip(accumulators, again, *rounded)]
        want = roi_align_batched_backward_reference(*args)
        errs, limits = zip(*[roi_err(g, w) for g, w in zip(accumulators, want)])
        ulps = [bf16_ulp(max(w.abs().max().item(), 1e-30)) for w in want]
        fields = {}
        for label, fn in (("exact", roi_align_trainable), ("windowed", roi_align_windowed_trainable)):
            leaves = [f[:batch].detach().clone().requires_grad_(True) for f in feats]
            fn(leaves, args[1], args[2], ROI_STRIDES).backward(args[0])
            torch.cuda.synchronize()
            assert all(leaf.grad.dtype == torch.bfloat16 for leaf in leaves)
            assert all(torch.isfinite(leaf.grad).all() for leaf in leaves), "non-finite K8 bf16 dF"
            bf16_errs = [(leaf.grad.float() - w.to(torch.bfloat16).float()).abs().max().item()
                         for leaf, w in zip(leaves, want)]
            fields[f"{label}_bf16_max_abs_err_per_level"] = bf16_errs
            assert all(e <= u for e, u in zip(bf16_errs, ulps)), (label, bf16_errs, ulps)
            worst = max(worst, max(bf16_errs))
        log("roi_align_bf16_grad_vs_plain", kernel="K8_bf16", batch=batch, rois=n,
            shapes=shapes, accumulators_max_abs_err_per_level=list(errs),
            accumulators_limit_per_level=list(limits), bf16_limit_per_level=ulps, **fields,
            run_to_run_max_abs_diff_per_level=reruns,
            levels_used=sorted(set(args[2].flatten().tolist())))
        assert all(e <= lim for e, lim in zip(errs, limits)), f"K8 disagrees at B={batch}, N={n}"
        assert all(r == 0.0 for r in reruns), f"K8 differs from run to run: {reruns}"
    window_lib.reset_contract_stats()
    return worst, (dout, rois, levels, shapes)


def phase_detector_train_800_path(train_set, dev_set):
    """`train_detector` at the train800 recipe in bf16 (full width, windowed,
    batch 4): 2 epochs with evaluation, then `resume=True` to epoch 3, each
    with the launch counts read around it (K9 and K8 once per train step, K9
    once per evaluation batch, nothing else); float32 masters in the
    checkpoints; then `evaluate_detector` over the dev frames from the best
    checkpoint. The out-of-contract rates of training (its evaluations
    included, as JAX's report counts them) and of that evaluation. Then a
    few steps of the fp32 twin (K9 + K8) and of bf16 with "auto" (the exact
    pair, K7 + K8)."""
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.models.detector.training import (
        make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    from objectpermanence_tpu_torch.train.detector_loop import (
        evaluate_detector, train_detector, warmup_schedule,
    )
    from objectpermanence_tpu_torch.utils.checkpoint import load_params
    work = WORK_DIR / "detector_train_800_path"
    shutil.rmtree(work, ignore_errors=True)
    cfg = DetectorConfig(**train800_recipe())
    common = dict(batch_size=TRAIN800_BATCH, learning_rate=DET_LR, checkpoint_dir=str(work),
                  print_step=4, seed=0, device="cuda")
    steps = -(-len(train_set) // TRAIN800_BATCH)
    eval_chunks = -(-len(dev_set) // 8)  # evaluate_detector's batches of 8
    others = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")

    window_lib.reset_contract_stats()
    read = reset_launches()
    t0 = time.perf_counter()
    first = train_detector(train_set, dev_set, cfg, num_epochs=TRAIN800_EPOCHS, **common)
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    first_launches = read()
    assert [h["epoch"] for h in first["history"]] == list(range(1, TRAIN800_EPOCHS + 1))
    assert first_launches["K8"] == TRAIN800_EPOCHS * steps, first_launches
    assert first_launches["K9"] == TRAIN800_EPOCHS * (steps + eval_chunks), first_launches
    assert all(first_launches[k] == 0 for k in others), first_launches

    read = reset_launches()
    t0 = time.perf_counter()
    resumed = train_detector(train_set, dev_set, cfg, num_epochs=TRAIN800_EPOCHS + 1,
                             resume=True, **common)
    torch.cuda.synchronize()
    resume_seconds = time.perf_counter() - t0
    resume_launches = read()
    train_contract = window_lib.contract_stats()
    assert [h["epoch"] for h in resumed["history"]] == [TRAIN800_EPOCHS + 1]
    assert resume_launches["K8"] == steps and resume_launches["K9"] == steps + eval_chunks, \
        resume_launches
    assert all(resume_launches[k] == 0 for k in others), resume_launches
    history = first["history"] + resumed["history"]
    losses = [loss for h in history for loss in h["train_losses"]]
    assert len(losses) == (TRAIN800_EPOCHS + 1) * steps and np.all(np.isfinite(losses)), losses

    best = max(work.glob("best_*.npz"), key=lambda p: float(p.stem.split("_", 1)[1]))
    for path in (best, work / "final.npz"):
        assert all(v.dtype == torch.float32 for v in load_params(path).values()), path
    window_lib.reset_contract_stats()
    read = reset_launches()
    metrics = evaluate_detector(CaterDetector.load(str(best), cfg, device="cuda"), dev_set)
    torch.cuda.synchronize()
    eval_launches = read()
    eval_contract = window_lib.contract_stats()
    window_lib.reset_contract_stats()
    assert eval_launches["K9"] == eval_chunks and sum(eval_launches.values()) == eval_chunks, \
        eval_launches

    def rate(c):
        return c["out_of_contract"] / c["rois"] if c["rois"] else None

    log("detector_train_800_path", recipe="train800_bf16", train_frames=len(train_set),
        dev_frames=len(dev_set), batch=TRAIN800_BATCH, epochs=f"{TRAIN800_EPOCHS}+1",
        steps_per_epoch=steps, seconds=f"{first_seconds:.3f}+{resume_seconds:.3f}",
        launches=json.dumps(first_launches), resume_launches=json.dumps(resume_launches),
        loss_per_step=json.dumps([round(x, 5) for x in losses]),
        map_per_epoch=json.dumps([h["mAP"] for h in history]), best=best.name,
        best_eval=json.dumps(metrics), eval_launches=json.dumps(eval_launches),
        train_contract=json.dumps(train_contract), train_out_of_contract_rate=rate(train_contract),
        eval_contract=json.dumps(eval_contract), eval_out_of_contract_rate=rate(eval_contract))

    inputs = train_batch(train_set, "cuda", TRAIN800_BATCH)
    for label, recipe, forward in (("fp32_windowed", train800_recipe("float32"), "K9"),
                                   ("bf16_auto", train800_recipe(roi_backend="auto"), "K7")):
        twin_cfg, model, anchors = detector_training_setup("cuda", recipe=recipe)
        optimizer = torch.optim.SGD([t for _, t in trainable_tensors(model)], lr=DET_LR,
                                    momentum=0.9, weight_decay=5e-4, dampening=0.0)
        step = make_detector_train_step(twin_cfg, anchors, optimizer, warmup_schedule(DET_LR, 5))
        gen = torch.Generator(device="cuda").manual_seed(0)
        read = reset_launches()
        twin_losses = [float(step(model, *inputs, generator=gen)["loss"])
                       for _ in range(TRAIN800_TWIN_STEPS)]
        counts = read()
        log("detector_train_800_twin", recipe=label, steps=TRAIN800_TWIN_STEPS,
            losses=json.dumps(twin_losses), launches=json.dumps(counts))
        assert np.all(np.isfinite(twin_losses)), (label, twin_losses)
        assert counts[forward] == counts["K8"] == TRAIN800_TWIN_STEPS, (label, counts)
        assert sum(counts.values()) == 2 * TRAIN800_TWIN_STEPS, (label, counts)
        del model, optimizer, step
    return {k: first_launches[k] + resume_launches[k] for k in first_launches}


def phase_detector_train_800_step_swap(device, train_set):
    """One 800 px bf16 train step at B=4 (train800, windowed, a constant lr
    of 5e-3) twice from the same weights and draws: through K9/K8, and with
    the plain windowed forward and plain backward in their place. Loss parts
    within 1e-5 relative; each clipped gradient within 1e-2 x max(1, max
    |plain's|) and each parameter after the update within lr times that,
    plus two float32 ulps of the parameter (SWAP_BF16_RTOL)."""
    from objectpermanence_tpu_torch.models.detector.training import (
        Draws, make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    inputs = train_batch(train_set, device, TRAIN800_BATCH)
    runs = {}
    for swap in (False, True):
        cfg, model, anchors = detector_training_setup(device, recipe=train800_recipe())
        named = trainable_tensors(model)
        optimizer = torch.optim.SGD([t for _, t in named], lr=DET_LR, momentum=0.9,
                                    weight_decay=5e-4, dampening=0.0)
        step = make_detector_train_step(cfg, anchors, optimizer, lambda count: DET_LR)
        draws = Draws.sample(TRAIN800_BATCH, sum(a.shape[0] for a in anchors),
                             cfg.rpn_post_nms_top_n + inputs[1].shape[1], device,
                             torch.Generator(device=device).manual_seed(5))
        read = reset_launches()
        kernels = rk.roi_align_windowed, rk.roi_align_batched_backward
        if swap:  # the windowed Function's forward and backward, plain
            rk.roi_align_windowed = rk.roi_align_windowed_reference
            rk.roi_align_batched_backward = rk.roi_align_batched_backward_reference
        try:
            parts = step(model, *inputs, draws=draws)
        finally:
            rk.roi_align_windowed, rk.roi_align_batched_backward = kernels
        torch.cuda.synchronize()
        runs[swap] = ({k: float(v) for k, v in parts.items()}, {n: t.grad.clone() for n, t in named},
                      {n: t.detach().clone() for n, t in named}, read())
        del model, optimizer, step
    window_lib.reset_contract_stats()
    (parts, grads, params, launches), (plain_parts, plain_grads, plain_params,
                                       plain_launches) = runs[False], runs[True]
    assert launches["K9"] == 1 and launches["K8"] == 1 and sum(launches.values()) == 2, launches
    assert sum(plain_launches.values()) == 0, plain_launches
    loss_rel = {k: abs(parts[k] - plain_parts[k]) / abs(plain_parts[k]) for k in parts}
    grad_ratio = {n: (grads[n] - g).abs().max().item()
                  / (SWAP_BF16_RTOL * max(1.0, g.abs().max().item()))
                  for n, g in plain_grads.items()}

    def param_limit(n):
        largest = plain_params[n].abs().max().item()
        ulps = 2 * 2.0 ** (np.floor(np.log2(largest)) - 23) if largest > 0 else 0.0
        return DET_LR * SWAP_BF16_RTOL * max(1.0, plain_grads[n].abs().max().item()) + ulps

    param_ratio = {n: (params[n] - p).abs().max().item() / max(param_limit(n), 1e-30)
                   for n, p in plain_params.items()}
    log("detector_train_800_step_swap", batch=TRAIN800_BATCH, loss_parts=json.dumps(parts),
        loss_rel_diff=json.dumps(loss_rel), tensors=len(grad_ratio),
        worst_grad_err_over_limit=json.dumps(sorted(grad_ratio.items(), key=lambda kv: -kv[1])[:4]),
        worst_param_err_over_limit=json.dumps(
            sorted(param_ratio.items(), key=lambda kv: -kv[1])[:4]))
    assert all(v <= LOSS_RTOL for v in loss_rel.values()), f"loss parts differ: {loss_rel}"
    assert all(r <= 1.0 for r in grad_ratio.values()), "gradients differ"
    assert all(r <= 1.0 for r in param_ratio.values()), "parameters differ"


def phase_detector_train_path(train_set, dev_set):
    """`train_detector` at the dettrain recipe's full width: 2 epochs with
    evaluation, then `resume=True` to epoch 3, each with the launch counts
    read around it; then `CaterDetector.load(best)` over one 30-frame chunk."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
    from objectpermanence_tpu_torch.train.detector_loop import train_detector
    from objectpermanence_tpu_torch.utils.checkpoint import load_params
    work = WORK_DIR / "detector_train_path"
    shutil.rmtree(work, ignore_errors=True)
    cfg = DetectorConfig(**DETTRAIN)
    common = dict(batch_size=DET_BATCH, learning_rate=DET_LR, checkpoint_dir=str(work),
                  print_step=2, seed=0, device="cuda")
    steps = -(-len(train_set) // DET_BATCH)
    eval_chunks = -(-len(dev_set) // 8)  # evaluate_detector's batches of 8
    others = ("K1", "K2", "K3", "K4", "K5", "K6", "K9")

    read = reset_launches()
    t0 = time.perf_counter()
    first = train_detector(train_set, dev_set, cfg, num_epochs=DET_EPOCHS, **common)
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    first_launches = read()
    assert [h["epoch"] for h in first["history"]] == list(range(1, DET_EPOCHS + 1))
    assert first_launches["K8"] == DET_EPOCHS * steps, f"K8 launches {first_launches}"
    assert first_launches["K7"] == DET_EPOCHS * (steps + eval_chunks), first_launches
    assert all(first_launches[k] == 0 for k in others), first_launches
    first_final = load_params(work / "final.npz")

    read = reset_launches()
    t0 = time.perf_counter()
    resumed = train_detector(train_set, dev_set, cfg, num_epochs=DET_EPOCHS + 1, resume=True,
                             **common)
    torch.cuda.synchronize()
    resume_seconds = time.perf_counter() - t0
    resume_launches = read()
    assert [h["epoch"] for h in resumed["history"]] == [DET_EPOCHS + 1], "resume ran other epochs"
    assert sorted(p.name for p in (work / "resume").iterdir()) == [
        f"epoch_{DET_EPOCHS + 1:04d}"], "older resume states were kept"
    assert resume_launches["K8"] == steps and resume_launches["K7"] == steps + eval_chunks, \
        resume_launches
    assert all(resume_launches[k] == 0 for k in others), resume_launches
    final = {k: v.detach().cpu() for k, v in resumed["params"].items()}
    moved = sum(not torch.equal(final[k], first_final[k]) for k in final)
    assert moved > 0.9 * len(final), f"the resumed run moved {moved} of {len(final)} tensors"
    history = first["history"] + resumed["history"]
    losses = [loss for h in history for loss in h["train_losses"]]
    assert len(losses) == (DET_EPOCHS + 1) * steps and np.all(np.isfinite(losses)), losses

    best = max(work.glob("best_*.npz"), key=lambda p: float(p.stem.split("_", 1)[1]))
    detector = CaterDetector.load(str(best), cfg, device="cuda")
    frames = draw_frames(make_scene(DETECTOR_SEED * 1000 + 7, num_frames=CHUNK), seed=7)
    read = reset_launches()
    boxes, labels, scores, valid = detector.detect_video(frames, batch_size=CHUNK)
    torch.cuda.synchronize()
    detect_launches = read()
    assert detect_launches["K7"] == 1 and sum(detect_launches.values()) == 1, detect_launches
    assert boxes.shape == (CHUNK, cfg.detections_per_img, 4) and np.isfinite(boxes[valid]).all()
    log("detector_train_path", train_frames=len(train_set), dev_frames=len(dev_set),
        batch=DET_BATCH, epochs=f"{DET_EPOCHS}+1", steps_per_epoch=steps,
        seconds=f"{first_seconds:.3f}+{resume_seconds:.3f}",
        launches=json.dumps(first_launches), resume_launches=json.dumps(resume_launches),
        loss_per_step=json.dumps([round(x, 5) for x in losses]),
        map_per_epoch=json.dumps([h["mAP"] for h in history]), best=best.name,
        moved_tensors=f"{moved}/{len(final)}", detect_launches=json.dumps(detect_launches),
        detections_kept=int(valid.sum()))
    return {k: first_launches[k] + resume_launches[k] for k in first_launches}


def detector_training_setup(device, seed=0, recipe=DETTRAIN):
    from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
    from objectpermanence_tpu_torch.models.detector.detector import (
        Detector, DetectorConfig, init_detector,
    )
    cfg = DetectorConfig(**recipe)
    model = init_detector(Detector(cfg), seed).to(device)
    anchors = [torch.from_numpy(a).to(device) for a in anchor_lib.pyramid_anchors(
        cfg.feature_shapes(), cfg.strides, cfg.anchor_sizes)]
    return cfg, model, anchors


def phase_detector_train_step_swap(device, train_set):
    """One full-width train step at B=8 twice from the same weights and
    draws: through K7/K8, and with the plain RoIAlign forward and backward
    in their place. Loss parts within 1e-5 relative, every gradient within
    1e-4 x max(1, max |plain's|)."""
    from objectpermanence_tpu_torch.models.detector.training import (
        Draws, detection_loss, trainable_tensors,
    )
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    inputs = train_batch(train_set, device)
    runs = {}
    for swap in (False, True):
        cfg, model, anchors = detector_training_setup(device)
        named = trainable_tensors(model)
        draws = Draws.sample(DET_BATCH, sum(a.shape[0] for a in anchors), DET_ROIS, device,
                             torch.Generator(device=device).manual_seed(5))
        read = reset_launches()
        kernels = rk.roi_align_batched, rk.roi_align_batched_backward
        if swap:  # the autograd Function's forward and backward, plain
            rk.roi_align_batched = rk.roi_align_batched_reference
            rk.roi_align_batched_backward = rk.roi_align_batched_backward_reference
        try:
            loss, parts = detection_loss(model, *inputs, cfg, anchors, draws)
            loss.backward()
        finally:
            rk.roi_align_batched, rk.roi_align_batched_backward = kernels
        torch.cuda.synchronize()
        runs[swap] = ({k: float(v.detach()) for k, v in parts.items()},
                      {n: t.grad for n, t in named}, read())
    (parts, grads, launches), (plain_parts, plain_grads, plain_launches) = runs[False], runs[True]
    assert launches["K7"] == 1 and launches["K8"] == 1, launches
    assert plain_launches["K7"] == 0 and plain_launches["K8"] == 0, plain_launches
    loss_rel = {k: abs(parts[k] - plain_parts[k]) / abs(plain_parts[k]) for k in parts}
    ratios = {n: (grads[n] - g).abs().max().item() / (GRAD_RTOL * max(1.0, g.abs().max().item()))
              for n, g in plain_grads.items()}
    worst = sorted(ratios.items(), key=lambda kv: -kv[1])[:4]
    log("detector_train_step_swap", batch=DET_BATCH, rois=DET_ROIS,
        loss_parts=json.dumps(parts),
        loss_rel_diff=json.dumps(loss_rel), grad_tensors=len(ratios),
        worst_grad_err_over_limit=json.dumps(worst))
    assert all(v <= LOSS_RTOL for v in loss_rel.values()), f"loss parts differ: {loss_rel}"
    assert all(r <= 1.0 for r in ratios.values()), f"gradients differ: {worst}"


STEP_STAGES = ("backbone_fpn", "rpn_proposals", "roi_align", "heads_losses", "backward",
               "optimizer")


def phase_detector_train_step_profile(device, train_set, recipe=DETTRAIN, batch=DET_BATCH,
                                      label="native_fp32", steps=5, profile_steps=3):
    """Where a full-width detector train step spends its time (`recipe` at
    `batch` frames; the dettrain recipe at B=8 by default): each
    stage by CUDA events recorded as the step issues it (the RPN's NMS
    rounds and the sampler wait on the host), the whole step, then a
    torch.profiler window with the device's busy share and K8's device time.
    The backward's split: K8's two kernels (binning, tiles) from the
    profiler, the rest of the backward. Returns the step's mean ms."""
    from objectpermanence_tpu_torch.models.detector.training import (
        make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.train.detector_loop import warmup_schedule
    cfg, model, anchors = detector_training_setup(device, recipe=recipe)
    optimizer = torch.optim.SGD([t for _, t in trainable_tensors(model)], lr=DET_LR,
                                momentum=0.9, weight_decay=5e-4, dampening=0.0)
    step = make_detector_train_step(cfg, anchors, optimizer, warmup_schedule(DET_LR, 5))
    inputs = train_batch(train_set, device, batch)
    gen = torch.Generator(device=device).manual_seed(0)

    def staged():
        start = torch.cuda.Event(enable_timing=True)
        marks = []

        def mark(name):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append((name, event))

        start.record()
        step(model, *inputs, generator=gen, on_stage=mark)
        torch.cuda.synchronize()
        times, prev = {}, start
        for name, event in marks:
            times[name] = prev.elapsed_time(event)
            prev = event
        return times

    for _ in range(2):
        staged()
    runs = [staged() for _ in range(steps)]
    stage_ms = {name: float(np.mean([r[name] for r in runs])) for name in STEP_STAGES}
    step_ms = time_ms(lambda: step(model, *inputs, generator=gen), iters=steps, warmup=1)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            step(model, *inputs, generator=gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernel_ms(prof)
    busy_ms = sum(kernels.values())
    assert busy_ms > 0, "the profiler saw no device time"
    k8_bin_ms = sum(ms for name, ms in kernels.items()
                    if "roi_align_backward_bin_kernel" in name) / profile_steps
    k8_tiles_ms = sum(ms for name, ms in kernels.items()
                      if "roi_align_backward_kernel" in name) / profile_steps
    k8_ms = k8_bin_ms + k8_tiles_ms
    assert k8_bin_ms > 0 and k8_tiles_ms > 0, "the profiler saw no K8 in the train step"
    per_step = {name[:60]: ms / profile_steps
                for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]}
    log("detector_train_step_profile", recipe=label, batch=batch, step_ms=step_ms,
        stage_ms=json.dumps(stage_ms), stages_sum_ms=sum(stage_ms.values()),
        backward_split_ms=json.dumps({"k8_bins": k8_bin_ms, "k8_tiles": k8_tiles_ms,
                                      "rest": stage_ms["backward"] - k8_ms}),
        frames_per_s=batch / (step_ms / 1e3), window_ms=window_ms,
        device_busy_share=busy_ms / window_ms, k8_device_ms=k8_ms,
        k8_share_of_device_time=k8_ms * profile_steps / busy_ms,
        per_step_ms=json.dumps(per_step))
    return step_ms


def k8_layout(rois, levels, shapes, channels, dtype, pooled=7, sampling=2):
    """K8's plan at this shape and how its binning fell: the binning
    kernel's device time (torch.profiler, mean of 10 calls: the wrapper
    alone is host-bound), the tiles of an image, those no roi reaches, the
    longest roi list of any tile, and the dOut re-read factor (each roi's
    dOut is read once for every tile it reaches: the lists' total over the
    rois)."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    args = (rois, levels, shapes, ROI_STRIDES, pooled, sampling, dtype)
    counts = rk.roi_align_backward_bins(*args)["counts"].cpu()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            rk.roi_align_backward_bins(*args)
        torch.cuda.synchronize()
    bins_ms = sum(ms for name, ms in device_kernel_ms(prof).items()
                  if "roi_align_backward_bin_kernel" in name) / 10
    assert bins_ms > 0, "the profiler saw no binning kernel"
    plan = rk.backward_launch_plan(channels, pooled, sampling, dtype.itemsize)
    return {"bins_ms": bins_ms, "plan": json.dumps(plan),
            "tiles": counts.shape[1], "empty_tile_share": float((counts == 0).float().mean()),
            "busiest_tile_rois": int(counts.max()),
            "dout_reread_factor": float(counts.sum()) / rois.shape[0] / rois.shape[1]}


def phase_k8_times(inputs, launches, max_abs_err):
    """K8 at the training shape (B=8, N=320, the dettrain pyramid) beside
    its bound and its plain version, in turns: plain, kernel, kernel, plain.
    `ms` is the wrapper's time (the binning, then the tile kernel, writing
    NCHW dF once); K8's plan, the binning alone and how the rois fell into
    tiles (`k8_layout`) are logged beside it, and K7 at the same shape. No
    PyTorch call computes RoIAlign's backward (torchvision is not
    installed), so library_ms is null."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    sys.path.insert(0, str(REPO / "scripts"))
    import kernel_bounds as kb
    dout, rois, levels, shapes, feats = inputs
    args = (dout, rois, levels, shapes, ROI_STRIDES)
    plain_a = time_ms(lambda: rk.roi_align_batched_backward_reference(*args), iters=2, warmup=1)
    kernel_a = time_ms(lambda: rk.roi_align_batched_backward(*args), iters=20)
    kernel_b = time_ms(lambda: rk.roi_align_batched_backward(*args), iters=20)
    plain_b = time_ms(lambda: rk.roi_align_batched_backward_reference(*args), iters=2, warmup=1)
    channels = dout.shape[2]
    _, flops, bytes_ = kb.roi_align(shapes, rois.shape[1], images=rois.shape[0], channels=channels)
    t_ops, t_bytes = flops / kb.PEAK_FLOPS, bytes_ / kb.PEAK_BYTES
    row = {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
           "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log("times", kernel="K8", images=rois.shape[0], rois=rois.shape[1], channels=channels,
        mbytes=bytes_ / 1e6, gflop=flops / 1e9, **row,
        **k8_layout(rois, levels, shapes, channels, torch.float32))
    with torch.inference_mode():
        k7_ms = time_ms(lambda: rk.roi_align_batched(feats, rois, levels, ROI_STRIDES), iters=20)
    log("times", kernel="K7", shape="training", images=rois.shape[0], rois=rois.shape[1],
        ms=k7_ms, bound_ms=row["bound_ms"])
    return {"name": "roi_align_batched_backward", "route": "cuda",
            "source": "objectpermanence_tpu_torch/csrc/roi_align.cu",
            "replaces": "objectpermanence_tpu/ops/pallas_roi_align.py:858",
            "launches": launches, "max_abs_err": max_abs_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None}


def phase_k8_bf16_times(inputs, launches, max_abs_err):
    """K8's bf16 mode at the 800 px training shape (B=4, N=320, P2-P5 of
    200 x 272 to 25 x 34) beside its bound (scripts/kernel_bounds.py: the
    float32 dOut read, the bf16 dF written) and its plain version, in turns:
    plain, kernel, float32 kernel, kernel, float32 kernel, plain, with K8's
    plan and binning at this shape (`k8_layout`). No PyTorch call computes
    RoIAlign's backward, so library_ms is null."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    sys.path.insert(0, str(REPO / "scripts"))
    import kernel_bounds as kb
    dout, rois, levels, shapes = inputs
    args = (dout, rois, levels, shapes, ROI_STRIDES)
    bf16 = torch.bfloat16
    plain_a = time_ms(lambda: rk.roi_align_batched_backward_reference(*args, dtype=bf16),
                      iters=2, warmup=1)
    kernel_a = time_ms(lambda: rk.roi_align_batched_backward(*args, dtype=bf16), iters=20)
    f32_a = time_ms(lambda: rk.roi_align_batched_backward(*args), iters=20)
    kernel_b = time_ms(lambda: rk.roi_align_batched_backward(*args, dtype=bf16), iters=20)
    f32_b = time_ms(lambda: rk.roi_align_batched_backward(*args), iters=20)
    plain_b = time_ms(lambda: rk.roi_align_batched_backward_reference(*args, dtype=bf16),
                      iters=2, warmup=1)
    channels = dout.shape[2]
    _, flops, bytes_ = kb.roi_align(shapes, rois.shape[1], images=rois.shape[0],
                                    channels=channels, itemsize=2)
    t_ops, t_bytes = flops / kb.PEAK_FLOPS, bytes_ / kb.PEAK_BYTES
    row = {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
           "f32_ms": (f32_a + f32_b) / 2, "f32_ms_runs": [f32_a, f32_b],
           "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
    log("times", kernel="K8_bf16", images=rois.shape[0], rois=rois.shape[1], channels=channels,
        shapes=shapes, mbytes=bytes_ / 1e6, gflop=flops / 1e9, **row,
        **k8_layout(rois, levels, shapes, channels, bf16))
    return {"name": "roi_align_batched_backward (bf16)", "route": "cuda",
            "source": "objectpermanence_tpu_torch/csrc/roi_align.cu",
            "replaces": "objectpermanence_tpu/ops/pallas_roi_align.py:858",
            "launches": launches, "max_abs_err": max_abs_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None}


WINDOWED_KERNELS = {
    "K9_f32": ("roi_align_windowed (f32)", "objectpermanence_tpu/ops/pallas_roi_align.py:1052"),
    "K9_bf16": ("roi_align_windowed (bf16)", "objectpermanence_tpu/ops/pallas_roi_align.py:1052"),
    "K7_bf16": ("roi_align_batched (bf16)", "objectpermanence_tpu/ops/pallas_roi_align.py:679"),
}


def phase_windowed_times(inputs, native_bf16_inputs, launches, errors):
    """K9 in float32 and bfloat16 at the 800 px chunk (B=8, N=300, C=256,
    P2-P5 of 200 x 272 to 25 x 34) and K7's bfloat16 mode where the main
    path runs it (B=8, N=300, the native pyramid), each beside its bound
    (scripts/kernel_bounds.py with the features' element size and the pixels
    the rois reach: for K9, inside their windows) and its plain version, in
    turns: plain, kernel, kernel, plain. `ms` is the wrapper's time on the
    NCHW levels the detector gives it, which the kernel reads in place;
    `channels_last_ms`, logged beside it with the launch plan, the same call
    on the levels in channels_last. K7's bf16 mode on the 800 px chunk is
    logged beside K9. K7 bf16's
    max_abs_err is the larger of its two comparisons. No PyTorch call
    computes RoIAlign, so library_ms is null."""
    from objectpermanence_tpu_torch.models.detector.roi_heads import ROI_STRIDES
    from objectpermanence_tpu_torch.ops import roi_align_kernel as rk
    from objectpermanence_tpu_torch.ops import roi_align_window as window_lib
    feats32, feats16, rois, levels = inputs
    cases = {"K9_f32": (rk.roi_align_windowed, rk.roi_align_windowed_reference,
                        (feats32, rois, levels)),
             "K9_bf16": (rk.roi_align_windowed, rk.roi_align_windowed_reference,
                         (feats16, rois, levels)),
             "K7_bf16": (rk.roi_align_batched, rk.roi_align_batched_reference,
                         native_bf16_inputs)}
    errors = {**errors, "K7_bf16": max(errors["K7_bf16"], errors["K7_bf16_800"])}
    rows = []
    for tag, (kernel, plain, (feats, tag_rois, tag_levels)) in cases.items():
        args = (feats, tag_rois, tag_levels, ROI_STRIDES)
        last_args = ([f.contiguous(memory_format=torch.channels_last) for f in feats],
                     *args[1:])
        with torch.inference_mode():
            plain_a = time_ms(lambda: plain(*args), iters=3, warmup=1)
            kernel_a = time_ms(lambda: kernel(*args), iters=20)
            last_ms = time_ms(lambda: kernel(*last_args), iters=20)
            kernel_b = time_ms(lambda: kernel(*args), iters=20)
            plain_b = time_ms(lambda: plain(*args), iters=3, warmup=1)
        window = None
        if tag.startswith("K9"):
            window = window_lib.Window.of([tuple(f.shape[-2:]) for f in feats], feats[0].shape[1],
                                          feats[0].element_size())
        row = {"ms": (kernel_a + kernel_b) / 2, "ms_runs": [kernel_a, kernel_b],
               "channels_last_ms": last_ms,
               "plan": json.dumps(rk.launch_plan(feats[0].shape[1], 7, 2,
                                                 feats[0].element_size())),
               "plain_ms": (plain_a + plain_b) / 2, "plain_ms_runs": [plain_a, plain_b],
               **roi_bound(feats, tag_rois, tag_levels, tag_rois.shape[0], window)}
        log("times", kernel=tag, images=tag_rois.shape[0], rois=tag_rois.shape[1],
            channels=feats[0].shape[1], shapes=[tuple(f.shape[-2:]) for f in feats], **row)
        name, site = WINDOWED_KERNELS[tag]
        rows.append({"name": name, "route": "cuda",
                     "source": "objectpermanence_tpu_torch/csrc/roi_align.cu", "replaces": site,
                     "launches": launches[tag], "max_abs_err": errors[tag], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None})
    args = (feats16, rois, levels, ROI_STRIDES)
    with torch.inference_mode():
        k7_800_ms = time_ms(lambda: rk.roi_align_batched(*args), iters=20)
    log("times", kernel="K7_bf16_800", images=rois.shape[0], rois=rois.shape[1], ms=k7_800_ms,
        **roi_bound(feats16, rois, levels, rois.shape[0]))
    window_lib.reset_contract_stats()
    return rows


# SiamRPN (models/siam.py), the detector_tracker model: SiamRPNvot at its full
# width (3-96-256-384-384-256, exemplar 127, search 271 and 287), weights from
# `siam_train_init(seed)` with each batch norm's running statistics calibrated on
# fixture crops (`calibrate_batch_norm`: the init's mean 0, var 1 saturate every
# score); the tracker path over TRACKER_VIDEOS fixture videos of 300 frames, its
# training on SIAM_PAIRS pairs cut from fixture frames (SIAM_HOLDOUT held out),
# batch 32, 2 epochs, from 30 epochs of 4,000 rendered pairs
SIAM_SEED, TRACKER_SEED, TRACKER_VIDEOS = 61, 62, 3
SIAM_BATCH, SIAM_PAIRS, SIAM_HOLDOUT, SIAM_EPOCHS = 32, 96, 32, 2
SIAM_RTOL = 1e-4     # SiamRPN's forward on the card vs the CPU: 1e-4 x max(1, max |CPU's|)
# a batch-32 train step's gradients against the CPU's float64 gradient, each tensor's
# distance over max(1, max |g|): float32 itself is up to 1e-2 from it (batch-statistics
# BN over features with large means cancels), so the card's float32 gradient must be
# no farther than twice the CPU's float32 gradient is
SIAM_GRAD_FACTOR = 2.0
# the tracker replayed on the CPU's trajectory: each hidden frame's update on the card
# within 0.1 px of the CPU's, or, where the two pick different anchors, the CPU's
# penalized scores of the two within TIE_PSCORE (5x the scores' measured card-CPU gap)
STATE_PX, TIE_PSCORE = 0.1, 1e-4


def siam_seeded(device):
    """The calibrated seeded SiamRPN on `device`, and fixture frames (RGB)."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.models import siam
    from objectpermanence_tpu_torch.train import siam_loop
    frames = draw_frames(make_scene(SIAM_SEED, num_frames=16), seed=SIAM_SEED)
    z = np.stack([siam.get_subwindow(f, (160, 120), 100, 127, f.mean((0, 1)))
                  for f in frames[::2]])
    x = np.stack([siam.get_subwindow(f, (160, 120), 200, 271, f.mean((0, 1)))
                  for f in frames[::2]])
    model = siam_loop.siam_train_init(torch.Generator().manual_seed(SIAM_SEED))
    siam_loop.calibrate_batch_norm(model, torch.from_numpy(z).permute(0, 3, 1, 2).float(),
                                   torch.from_numpy(x).permute(0, 3, 1, 2).float())
    return model.to(device).eval(), frames


def siam_crop(frame, size, side):
    from objectpermanence_tpu_torch.models import siam
    crop = siam.get_subwindow(frame, (150.0, 110.0), side, size, frame.mean((0, 1)))
    return torch.from_numpy(np.ascontiguousarray(crop.transpose(2, 0, 1)[None])).float()


def siam_pairs(count, seed=SIAM_SEED):
    """(z, x, gt) uint8 pairs that `_crop_pair` cuts from fixture frames: a
    visible object at t and again at t + dt (dt <= 20) of a drawn scene."""
    from objectpermanence_tpu_torch.data.fixtures import draw_frames, make_scene
    from objectpermanence_tpu_torch.train import siam_loop
    rng = np.random.RandomState(seed)
    zs, xs, gts = [], [], []
    scene_id = 0
    while len(gts) < count:
        scene = make_scene(seed * 1000 + scene_id, num_frames=60)
        frames = draw_frames(scene, seed=scene_id)
        scene_id += 1
        for _ in range(8):
            k = rng.randint(scene["boxes"].shape[1])
            seen = np.flatnonzero(scene["visible"][:, k])
            t = int(rng.choice(seen[:-1]))
            later = seen[(seen > t) & (seen <= t + 20)]
            if len(later) == 0:
                continue
            t2 = int(rng.choice(later))
            xywh = [np.concatenate([b[:2], b[2:] - b[:2]]) for b in
                    (scene["boxes"][t, k], scene["boxes"][t2, k])]
            z, x, gt = siam_loop._crop_pair([frames[t], frames[t2]], *xywh, rng)
            zs.append(z)
            xs.append(x)
            gts.append(gt)
    return np.stack(zs[:count]), np.stack(xs[:count]), np.stack(gts[:count])


def phase_siam_vs_plain(device):
    """The full-width SiamRPN on the card against the same module on the CPU
    on the same crops: `temple`'s kernels, `track_forward`'s delta and score
    at the 271 and 287 px searches, then one training forward and backward of
    `siam_pair_loss` at batch 32 with the masks fixed (drawn once on the
    host): the gradients against the CPU's float64 ones, the card's float32
    no farther from them than SIAM_GRAD_FACTOR times the CPU's float32
    gradients are. Library convs
    (cuDNN, as XLA's convs in JAX): no kernel of the port runs, and the
    counts stay 0."""
    import copy
    from objectpermanence_tpu_torch.train import siam_loop
    card, frames = siam_seeded(device)
    cpu = copy.deepcopy(card).cpu()
    z = siam_crop(frames[3], 127, 90)
    errors = {}
    read = reset_launches()
    with torch.inference_mode():
        want_k, got_k = cpu.temple(z), card.temple(z.to(device))
        for name, want, got in zip(("r1_kernel", "cls1_kernel"), want_k, got_k):
            errors[name] = (max_err(got.cpu(), want), SIAM_RTOL * max(1.0, want.abs().max().item()))
        for size, side in ((271, 190), (287, 200)):
            x = siam_crop(frames[5], size, side)
            want = cpu.track_forward(want_k, x)
            got = card.track_forward(got_k, x.to(device))
            for name, w, g in zip(("delta", "score"), want, got):
                errors[f"{name}_{size}"] = (max_err(g.cpu(), w),
                                            SIAM_RTOL * max(1.0, w.abs().max().item()))
    z, x, gt = (torch.from_numpy(a) for a in siam_pairs(SIAM_BATCH))
    z, x = z.permute(0, 3, 1, 2).float(), x.permute(0, 3, 1, 2).float()
    _, xyxy = siam_loop.anchor_arrays()
    draws = torch.from_numpy(np.random.RandomState(SIAM_SEED).uniform(
        0, 1, (2, SIAM_BATCH, xyxy.shape[0])).astype(np.float32))
    masks = siam_loop.siam_pair_masks(gt, xyxy, draws[0], draws[1])
    grads, losses = {}, {}
    for tag, dev, dtype in (("exact", "cpu", torch.float64), ("cpu", "cpu", torch.float32),
                            ("card", device, torch.float32)):
        model = copy.deepcopy(cpu).to(dev, dtype).train()
        delta, score, _ = siam_loop.pair_forward_train(model, z.to(dev, dtype), x.to(dev, dtype))
        cxcywh, _ = siam_loop.anchor_arrays(dev)
        cls_l, reg_l = siam_loop.siam_pair_loss(delta, score, gt.to(dev, dtype), cxcywh.to(dtype),
                                                *(m.to(dev) for m in masks))
        loss = cls_l.mean() + reg_l.mean()
        loss.backward()
        losses[tag] = loss.item()
        grads[tag] = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    counts = read()

    def grad_errors(tag):
        return {n: max_err(g, grads["exact"][n]) / max(1.0, grads["exact"][n].abs().max().item())
                for n, g in grads[tag].items()}

    card_rel, cpu_rel = grad_errors("card"), grad_errors("cpu")
    errors["grads"] = (max(card_rel.values()), SIAM_GRAD_FACTOR * max(cpu_rel.values()))
    worst = max(errors.items(), key=lambda kv: kv[1][0] / kv[1][1])
    log("siam_vs_plain", batch=SIAM_BATCH, loss_card=losses["card"], loss_cpu=losses["cpu"],
        loss_exact=losses["exact"],
        temple_err=max(errors["r1_kernel"][0], errors["cls1_kernel"][0]),
        delta_err_271=errors["delta_271"][0], score_err_271=errors["score_271"][0],
        delta_err_287=errors["delta_287"][0], score_err_287=errors["score_287"][0],
        card_grad_rel_err=max(card_rel.values()), cpu_fp32_grad_rel_err=max(cpu_rel.values()),
        card_worst_tensor=max(card_rel, key=card_rel.get),
        cpu_worst_tensor=max(cpu_rel, key=cpu_rel.get),
        worst=f"{worst[0]}:{worst[1][0]:.3e}/{worst[1][1]:.3e}", launches=json.dumps(counts))
    for name, (err, limit) in errors.items():
        assert err <= limit, f"SiamRPN {name} on the card off the CPU's: {err} > {limit}"
    assert sum(counts.values()) == 0, f"SiamRPN launched the port's kernels: {counts}"


class ReplayTracker:
    """Stands in for a `SiamRPNTracker` inside `ObjectDetectWithSiamTracker`:
    the CPU tracker's states drive the trajectory, and on every frame the
    card's network also runs from the same state (with its own exemplar
    kernels, from the same crop), so each decision is compared on the same
    input, where a free run would carry one near-tie's other pick into
    every later frame."""

    def __init__(self, cpu, card):
        self.cpu, self.card, self.cfg = cpu, card, cpu.cfg
        self.frames = self.ties = 0
        self.max_px, self.bad = 0.0, []

    def init(self, im, pos, sz):
        state = self.cpu.init(im, pos, sz)
        self.card_kernels = self.card.init(im, pos, sz).kernels
        return state

    def track(self, state, im):
        from dataclasses import replace
        from objectpermanence_tpu_torch.models.siam import penalized_scores
        want_out = self.cpu.forward(state, im)
        got_out = self.card.forward(replace(state, kernels=self.card_kernels), im)
        want, got = self.cpu.update(state, *want_out), self.cpu.update(state, *got_out)
        self.frames += 1
        pscores = [penalized_scores(d, s, state.anchors, state.window, state.sz * scale,
                                    self.cfg["penalty_k"], self.cfg["window_influence"])[2]
                   for d, s, scale in (want_out, got_out)]
        best_cpu, best_card = (int(np.argmax(p)) for p in pscores)
        if best_cpu == best_card:
            px = max(np.abs(got.pos - want.pos).max(), np.abs(got.sz - want.sz).max())
            self.max_px = max(self.max_px, float(px))
            if px > STATE_PX:
                self.bad.append((self.frames, "px", float(px)))
        else:
            gap = float(pscores[0][best_cpu] - pscores[0][best_card])
            self.ties += 1
            if gap > TIE_PSCORE:
                self.bad.append((self.frames, "pick", gap))
        return want


def read_boxes(results):
    return {p.name: np.array(json.loads(p.read_text()))
            for p in sorted(Path(results).glob("*_bb.json"))}


def phase_trackers_path(device):
    """`inference --model_type detector_heuristic` and `detector_tracker`
    through the CLI on TRACKER_VIDEOS fixture videos of 300 frames (frames
    from `fixture_video` swapped in for cv2's decode, no debug writer), each
    with the launch counts read around it; then both again with `"device":
    "cpu"`: the heuristic's boxes equal. The tracker's free runs are
    compared and logged; its decisions are held on the same inputs by a
    replay (`ReplayTracker`), since a near-tie between two anchors, picked
    the other way once, moves every later frame of a free run. The tracker
    counts the frames that ran the net and times each one's host crop and
    the rest (the network on the card, the copy back, the host update)."""
    import copy
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.data.fixtures import write_fixture_dataset
    from objectpermanence_tpu_torch.infer import trackers
    from objectpermanence_tpu_torch.models import siam
    from objectpermanence_tpu_torch.utils.checkpoint import save_params

    work = WORK_DIR / "trackers_path"
    shutil.rmtree(work, ignore_errors=True)
    pred, labels, _ = write_fixture_dataset(work / "data", num_videos=TRACKER_VIDEOS,
                                            seed=TRACKER_SEED)
    videos = work / "videos"
    videos.mkdir()
    for p in sorted(pred.glob("*.pkl")):
        (videos / f"{p.stem}.avi").touch()
    model, _ = siam_seeded(device)
    save_params(work / "siam.npz", model.state_dict())
    trackers.read_video_bgr = lambda path: np.ascontiguousarray(
        fixture_video(path, seed=TRACKER_SEED)[..., ::-1])
    trackers.open_debug_writer = lambda path, width, height: None

    timing = {"frames": 0, "crop_s": 0.0, "track_s": 0.0}
    track, search = siam.SiamRPNTracker.track, siam.SiamRPNTracker.search

    def timed_search(self, state, im):
        t0 = time.perf_counter()
        out = search(self, state, im)
        timing["crop_s"] += time.perf_counter() - t0
        return out

    def timed_track(self, state, im):
        t0 = time.perf_counter()
        out = track(self, state, im)
        timing["track_s"] += time.perf_counter() - t0
        timing["frames"] += 1
        return out

    results = {}
    for model_type in ("detector_heuristic", "detector_tracker"):
        for dev in ("cuda", "cpu"):
            config = {"sample_dir": str(pred), "labels_dir": str(labels),
                      "videos_dir": str(videos), "model_path": str(work / "siam.npz")}
            if dev == "cpu":
                config["device"] = "cpu"
            (work / "inference.json").write_text(json.dumps(config))
            out = work / f"{model_type}_{dev}"
            timing.update(frames=0, crop_s=0.0, track_s=0.0)
            siam.SiamRPNTracker.track, siam.SiamRPNTracker.search = timed_track, timed_search
            read = reset_launches()
            t0 = time.perf_counter()
            try:
                rc = cli_main(["inference", "--model_type", model_type, "--results_dir",
                               str(out), "--inference_config", str(work / "inference.json")])
                torch.cuda.synchronize()
            finally:
                siam.SiamRPNTracker.track, siam.SiamRPNTracker.search = track, search
            seconds = time.perf_counter() - t0
            counts = read()
            assert rc == 0, f"{model_type} CLI exit {rc}"
            results[model_type, dev] = read_boxes(out)
            net_frames = timing["frames"]
            log("trackers_path", model=model_type, device=dev, videos=TRACKER_VIDEOS,
                frames=FRAMES, seconds=f"{seconds:.3f}", net_frames=net_frames,
                ms_per_net_frame=1e3 * timing["track_s"] / max(net_frames, 1),
                crop_ms_per_net_frame=1e3 * timing["crop_s"] / max(net_frames, 1),
                rest_ms_per_net_frame=1e3 * (timing["track_s"] - timing["crop_s"])
                / max(net_frames, 1), launches=json.dumps(counts))
            assert sum(counts.values()) == 0, f"{model_type} launched the port's kernels: {counts}"
            assert len(results[model_type, dev]) == TRACKER_VIDEOS
            if model_type == "detector_tracker":
                assert net_frames >= 100 * TRACKER_VIDEOS, f"the net ran on {net_frames} frames"
            else:
                assert net_frames == 0
    heuristic = results["detector_heuristic", "cuda"]
    assert all(np.array_equal(heuristic[k], v)
               for k, v in results["detector_heuristic", "cpu"].items())

    # the card's decisions against the CPU's on the same inputs: the CPU's run
    # again, in process, with the card's network beside it on every frame
    import pickle
    from objectpermanence_tpu_torch.models.siam import ObjectDetectWithSiamTracker
    replay = ReplayTracker(siam.SiamRPNTracker(copy.deepcopy(model).cpu(), device="cpu"),
                           siam.SiamRPNTracker(model, device=device))
    for p in sorted(pred.glob("*.pkl")):
        with open(p, "rb") as f:
            dets = pickle.load(f)
        frames = trackers.read_video_bgr(videos / f"{p.stem}.avi")
        trackers.track_video(ObjectDetectWithSiamTracker(replay), dets, FRAMES,
                             lambda t, _frames=frames: _frames[t])
    card = np.stack(list(results["detector_tracker", "cuda"].values()))
    cpu = np.stack(list(results["detector_tracker", "cpu"].values()))
    diff = np.abs(card - cpu)
    differ = (diff > 0).any(axis=2)
    first = [int(np.argmax(row)) if row.any() else -1 for row in differ]
    log("trackers_path_vs_cpu", replay_frames=replay.frames, replay_max_px=replay.max_px,
        replay_other_picks=replay.ties, replay_failures=json.dumps(replay.bad[:5]),
        free_run_px_max_diff=int(diff.max()), free_run_px_diff_share=float((diff > 0).mean()),
        free_run_frames_differ=int(differ.sum()), free_run_first_differ=json.dumps(first),
        distinct_boxes=len(np.unique(card.reshape(-1, 4), axis=0)))
    assert card.shape == (TRACKER_VIDEOS, FRAMES, 4)
    assert replay.frames >= 100 * TRACKER_VIDEOS and not replay.bad, \
        f"detector_tracker's decisions on the card disagree with the CPU's: {replay.bad[:5]}"


def phase_siam_train_path(device):
    """`siam_train_main` at batch 32 on SIAM_PAIRS pairs that `_crop_pair`
    cuts from fixture frames (the card's machine cannot decode video),
    SIAM_HOLDOUT held out, 2 epochs, with the launch counts read around it;
    then `build_siam_reasoner` from its checkpoint directory tracks one
    fixture video through the CLI."""
    from objectpermanence_tpu_torch.__main__ import main as cli_main
    from objectpermanence_tpu_torch.train.siam_loop import siam_train_main
    work = WORK_DIR / "siam_train_path"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    z, x, gt = siam_pairs(SIAM_PAIRS)
    np.savez(work / "pairs.npz", z=z, x=x, gt=gt)
    read = reset_launches()
    t0 = time.perf_counter()
    result = siam_train_main(work / "pairs.npz", work / "ckpt", num_epochs=SIAM_EPOCHS,
                             batch_size=SIAM_BATCH, holdout=SIAM_HOLDOUT, print_step=1,
                             device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read()
    history = result["history"]
    log("siam_train_path", pairs=SIAM_PAIRS, holdout=SIAM_HOLDOUT, batch=SIAM_BATCH,
        epochs=SIAM_EPOCHS, seconds=f"{seconds:.3f}", launches=json.dumps(counts),
        **{f"epoch{h['epoch']}_{k}": h[k] for h in history for k in ("mean_iou", "center_hit")})
    assert [h["epoch"] for h in history] == list(range(1, SIAM_EPOCHS + 1))
    assert all(np.isfinite(h["mean_iou"]) for h in history)
    assert Path(result["checkpoint"]) == work / "ckpt" / "final.npz"
    assert sum(counts.values()) == 0, f"SiamRPN training launched the port's kernels: {counts}"

    data = WORK_DIR / "trackers_path"
    name = sorted((data / "data" / "od_perception").glob("*.pkl"))[0].stem
    (work / "sample.txt").write_text(f"{name}\n")
    (work / "inference.json").write_text(json.dumps({
        "sample_dir": str(data / "data" / "od_perception"), "videos_dir": str(data / "videos"),
        "sample_file": str(work / "sample.txt"), "model_path": str(work / "ckpt")}))
    rc = cli_main(["inference", "--model_type", "detector_tracker", "--results_dir",
                   str(work / "tracked"), "--inference_config", str(work / "inference.json")])
    boxes = read_boxes(work / "tracked")
    assert rc == 0 and list(boxes) == [f"{name}_bb.json"], (rc, list(boxes))
    assert boxes[f"{name}_bb.json"].shape == (FRAMES, 4)
    log("siam_train_path_tracked", video=name, distinct_boxes=len(np.unique(
        boxes[f"{name}_bb.json"], axis=0)))


def phase_siam_step_profile(device, smi, steps=10):
    """A SiamRPN train step at batch 32 (127 and 271 crops, forward to the
    SGD update and the BN EMA) and `track_forward` at batch 1 (one hidden
    frame's network), each the mean of `steps` calls by CUDA events, then a
    torch.profiler window of each with the device's busy share and its
    leading kernels."""
    from objectpermanence_tpu_torch.train import siam_loop
    model, frames = siam_seeded(device)
    z, x, gt = (torch.from_numpy(a).to(device) for a in siam_pairs(SIAM_BATCH))
    z, x = z.permute(0, 3, 1, 2).float().contiguous(), x.permute(0, 3, 1, 2).float().contiguous()
    step = siam_loop.make_siam_train_step(
        siam_loop.make_siam_optimizer(model),
        siam_loop.warmup_cosine_schedule(0.0, 5e-3, 10, 100, 5e-5))
    generator = torch.Generator(device).manual_seed(SIAM_SEED)
    model.train()
    train_ms = time_ms(lambda: step(model, z, x, gt, generator), iters=steps)
    train_busy, train_top = profile_top(lambda: step(model, z, x, gt, generator), calls=3)
    model.eval()
    with torch.inference_mode():
        kernels = model.temple(siam_crop(frames[2], 127, 90).to(device))
        search = siam_crop(frames[4], 271, 190).to(device)
        track_ms = time_ms(lambda: model.track_forward(kernels, search), iters=steps * 5)
        track_busy, track_top = profile_top(lambda: model.track_forward(kernels, search),
                                            calls=5)
    log("siam_step_profile", train_batch=SIAM_BATCH, train_step_ms=train_ms,
        train_pairs_per_s=SIAM_BATCH / (train_ms / 1e3), train_busy_share=train_busy,
        train_top_ms=json.dumps(train_top), track_forward_ms=track_ms,
        track_busy_share=track_busy, track_top_ms=json.dumps(track_top), card=repr(smi))


# the data-parallel paths: 64 simulated 300-frame videos (48 train, 16 dev; the
# simulator's scenes through perfect perception), ingested both ways, then the
# shipped OPNet trained an epoch on them under a world-1 NCCL process group and
# without one, an FSDP2 step and the dettrain detector's step under DDP
SIM_TRAIN, SIM_DEV, SIM_SEED = 48, 16, 7
DP_RTOL = 1e-6       # DDP at world 1 against no process group: losses, mIoU, params
ADAM_ATOL, GRAD_FLOOR = 1e-5, 1e-7   # an Adam step's params where |g| >= 1e-7
DP_STEPS = 10        # steps timed per variant
DET_DP_NOISE = 10    # DDP's detector step against the plain one: times plain vs plain


def host_cpu():
    """The host's CPU as lscpu names it: vendor, model name, family/model, CPUs."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    return ", ".join(f"{key} {fields[key].strip()}" for key in
                     ("Vendor ID", "Model name", "CPU family", "Model", "CPU(s)") if key in fields)


def phase_native_ingest():
    """Build the native ingest library from the checkout, simulate the
    videos with the port's simulator and perfect perception, and ingest each
    split natively and in Python: arrays equal (np.array_equal), both host
    times, the pad + oracle part alone too. Returns the splits' paths."""
    import pickle

    from objectpermanence_tpu_torch.data import ingest
    from objectpermanence_tpu_torch.datagen.perfect_perception import PerfectPerceptionGenerator
    from objectpermanence_tpu_torch.datagen.scene_labels import write_annotation_files
    from objectpermanence_tpu_torch.datagen.simulator import simulate_dataset
    from objectpermanence_tpu_torch.native import build as native_build
    from objectpermanence_tpu_torch.vocab import IS_CONE

    work = WORK_DIR / "native_ingest"
    shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    library = native_build.build()
    build_s = time.perf_counter() - t0
    splits, sim_s, perception_s = {}, 0.0, 0.0
    for split, count, seed in (("train", SIM_TRAIN, SIM_SEED), ("dev", SIM_DEV, SIM_SEED + 1)):
        t0 = time.perf_counter()
        scenes, labels = simulate_dataset(work / split, num_videos=count, seed=seed,
                                          num_frames=FRAMES)
        sim_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        written = PerfectPerceptionGenerator(scenes, labels, work / split / "perception").generate()
        perception_s += time.perf_counter() - t0
        assert len(written) == count, f"{len(written)} perception pickles of {count}"
        annotations = write_annotation_files(scenes, work / split / "annotations")
        splits[split] = (work / split / "perception", labels, annotations["containment"])
    times = {"native": 0.0, "python": 0.0}
    core = {"native": 0.0, "python": 0.0}
    for split, paths in splits.items():
        got = {}
        for way in times:
            t0 = time.perf_counter()
            got[way] = ingest.ingest_directory(*paths[:2], 6, paths[2], native=way == "native")
            times[way] += time.perf_counter() - t0
        for key in ("boxes", "index_to_track", "labels", "containment_mask"):
            assert np.array_equal(getattr(got["native"], key), getattr(got["python"], key)), \
                f"native and Python ingest differ in {split} {key}"
        assert got["native"].boxes.shape == (len(got["native"]), FRAMES, 15, 6)
        assert (got["native"].index_to_track != 0).any(), "no containment carrier"
        preds = [pickle.loads(p.read_bytes()) for p in sorted(paths[0].glob("*.pkl"))]
        for way, (pad, oracle) in {
                "native": (lambda b, l: native_build.native_pad_video(b, l, 6, IS_CONE),
                           native_build.native_containment_oracle),
                "python": (lambda b, l: ingest.pad_video_detections(b, l, 6),
                           ingest.containment_oracle)}.items():
            t0 = time.perf_counter()
            for pred in preds:
                oracle(pad(pred["bb"], pred["labels"]), 6)
            core[way] += time.perf_counter() - t0
    videos = SIM_TRAIN + SIM_DEV
    log("native_ingest", host_cpu=repr(host_cpu()), cpus=len(os.sched_getaffinity(0)),
        library=library.relative_to(REPO), build_s=f"{build_s:.3f}", videos=videos,
        frames=FRAMES, simulate_s=f"{sim_s:.3f}", perfect_perception_s=f"{perception_s:.3f}",
        ingest_native_s=f"{times['native']:.4f}", ingest_python_s=f"{times['python']:.4f}",
        ingest_speedup=f"{times['python'] / times['native']:.2f}",
        pad_oracle_native_ms_per_video=f"{core['native'] * 1e3 / videos:.4f}",
        pad_oracle_python_ms_per_video=f"{core['python'] * 1e3 / videos:.4f}",
        pad_oracle_speedup=f"{core['python'] / core['native']:.2f}", arrays_equal=True)
    return splits


def world_one_nccl():
    """A real NCCL process group of one rank, started in this process (no
    port: a HashStore), and its (data, model) mesh."""
    import torch.distributed as dist
    from objectpermanence_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    return make_mesh()


def rel_diff(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def opnet_step_setup(device):
    """The shipped OPNet from the training seed, and its Adam."""
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.train.loop import make_optimizer
    model_config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    spec = get_model_spec("opnet")
    model = spec.build(model_config, torch.Generator().manual_seed(0)).to(device).train()
    return spec, model, make_optimizer(model.parameters(), 1e-3)


def phase_dp_train_path(splits, device, det_train_set):
    """`training_main(mesh=make_mesh())` of the shipped OPNet for one epoch
    of the simulated videos under a world-1 NCCL group (DDP), then the same
    epoch with no process group: losses, dev mIoU and params within 1e-6
    relative (bitwise where they are); K2/K3/K4 launch in the DDP run. Then,
    in the group, one FSDP2 step against the plain step (Adam's 1e-5 where
    |g| >= 1e-7) and the dettrain detector's step under DDP against the
    single-device step (loss parts within LOSS_RTOL), each timed against its
    plain twin. Returns the launches of the paths, by kernel."""
    import torch.distributed as dist
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.train.loop import training_main

    work = WORK_DIR / "dp_train_path"
    shutil.rmtree(work, ignore_errors=True)
    train, dev = (ingest_directory(*splits[s][:2], 6, splits[s][2]) for s in ("train", "dev"))
    shipped = json.loads((REPO / "configs" / "training_config.json").read_text())
    model_config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    runs, launches = {}, {}
    mesh = world_one_nccl()
    try:
        for tag in ("ddp", "plain"):
            config = {**shipped, "num_epochs": 1, "print_step": 1000,
                      "checkpoints_path": str(work / tag)}
            if tag == "plain":
                dist.destroy_process_group()
                mesh = None
            read = reset_launches()
            t0 = time.perf_counter()
            result = training_main(get_model_spec("opnet"), train, dev, config, model_config,
                                   mesh=mesh, device=device)
            torch.cuda.synchronize()
            runs[tag] = (result, time.perf_counter() - t0, read())
            if tag == "ddp":
                launches = runs[tag][2]
                step_times = phase_dp_step_times(train, device, mesh)
                fsdp_launches = phase_fsdp_step(train, device, mesh)
                detector_launches = phase_detector_dp_step(device, mesh, det_train_set)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (ddp, ddp_s, ddp_launches), (plain, plain_s, _) = runs["ddp"], runs["plain"]
    assert ddp_launches["K2"] > 0 and ddp_launches["K3"] > 0 and ddp_launches["K4"] > 0, \
        f"the DDP run skipped the LSTM kernels: {ddp_launches}"
    assert ddp_launches["K1"] == 0, ddp_launches
    diffs = {}
    for split in ("train", "dev"):
        for key in ("loss", "mean_iou", "containment_mean_iou"):
            a, b = ddp.history[0][split][key], plain.history[0][split][key]
            diffs[f"{split}_{key}"] = 0.0 if a == b else rel_diff(a, b)
    plain_state = plain.model.state_dict()
    param_diffs = {k: rel_diff(v, plain_state[k]) for k, v in ddp.model.state_dict().items()}
    bitwise = all(torch.equal(v, plain_state[k]) for k, v in ddp.model.state_dict().items())
    log("dp_train_path", train_videos=len(train), dev_videos=len(dev), frames=FRAMES,
        batch_size=shipped["batch_size"], epochs=1, ddp_seconds=f"{ddp_s:.3f}",
        plain_seconds=f"{plain_s:.3f}", launches=json.dumps(ddp_launches),
        metric_rel_diffs=json.dumps(diffs), params_bitwise_equal=bitwise,
        max_param_rel_diff=max(param_diffs.values()),
        train_loss=ddp.history[0]["train"]["loss"], dev_miou=ddp.history[0]["dev"]["mean_iou"],
        **step_times)
    assert all(v <= DP_RTOL for v in diffs.values()), f"DDP's metrics differ: {diffs}"
    assert all(v <= DP_RTOL for v in param_diffs.values()), \
        f"DDP's params differ: {sorted(param_diffs.items(), key=lambda kv: -kv[1])[:3]}"
    total = {k: ddp_launches[k] + fsdp_launches[k] + detector_launches[k] for k in ddp_launches}
    return total


def phase_dp_step_times(train, device, mesh):
    """The shipped OPNet's train step at the shipped batch on the train
    split's first videos: under DDP (world 1) and plain, ms by CUDA events."""
    from objectpermanence_tpu_torch.parallel.data_parallel import DataParallel, layers_entry
    from objectpermanence_tpu_torch.train.loop import make_train_step
    batch = TRAIN_BATCH
    inputs = [torch.from_numpy(a[:batch]).to(device) for a in (train.boxes, train.labels)]
    mask = torch.from_numpy(train.containment_mask[:batch]).to(device)
    tracks = torch.from_numpy(train.index_to_track[:batch].astype(np.int64)).to(device)
    weights = torch.ones(batch, device=device)
    out = {}
    for tag in ("ddp", "plain"):
        spec, model, optimizer = opnet_step_setup(device)
        stepped = DataParallel(model, mesh, layers_entry) if tag == "ddp" else model
        step = make_train_step(spec, optimizer, mesh=mesh if tag == "ddp" else None)
        out[f"{tag}_step_ms"] = time_ms(
            lambda: step(stepped, *inputs, mask, weights, tracks, weight_total=batch),
            iters=DP_STEPS)
    return out


def phase_fsdp_step(train, device, mesh):
    """One FSDP2 step (world 1: every large leaf a DTensor over the one
    rank) of the shipped OPNet against the plain step from the same
    weights: params within Adam's 1e-5 where |g| >= 1e-7; both timed."""
    from torch.distributed.tensor import DTensor

    from objectpermanence_tpu_torch.parallel.fsdp import (
        fsdp_param_shardings, make_fsdp_train_step, param_groups, shard_model,
    )
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    batch = TRAIN_BATCH
    boxes, labels = (torch.from_numpy(a[:batch]).to(device) for a in (train.boxes, train.labels))
    mask = torch.from_numpy(train.containment_mask[:batch]).float().to(device)
    spec, plain, plain_opt = opnet_step_setup(device)
    make_train_step(spec, plain_opt)(plain, boxes, labels, mask)
    grads = {n: p.grad.detach().clone() for n, p in plain.named_parameters()}
    _, model, _ = opnet_step_setup(device)
    shardings = fsdp_param_shardings(model, mesh)
    sharded = shard_model(model, mesh)
    optimizer = make_optimizer(param_groups(sharded), 1e-3)
    step = make_fsdp_train_step(spec, optimizer, mesh)
    read = reset_launches()
    metrics = step(sharded, boxes, labels, mask)
    torch.cuda.synchronize()
    launches = read()
    worst = 0.0
    for name, param in model.named_parameters():
        full = param.full_tensor() if isinstance(param, DTensor) else param
        ok = grads[name].abs() >= GRAD_FLOOR
        diff = (full.detach() - dict(plain.named_parameters())[name].detach()).abs()[ok]
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    placed = sum(isinstance(p, DTensor) for p in model.parameters())
    plain_step = make_train_step(spec, plain_opt)
    fsdp_ms, plain_ms = [], []   # alternating windows: the spread of each
    for _ in range(3):
        fsdp_ms.append(time_ms(lambda: step(sharded, boxes, labels, mask), iters=DP_STEPS))
        plain_ms.append(time_ms(lambda: plain_step(plain, boxes, labels, mask), iters=DP_STEPS))
    log("fsdp_step", batch=batch, sharded_leaves=placed,
        replicated_leaves=sum(d is None for d in shardings.values()),
        launches=json.dumps(launches), loss=float(metrics["loss"]),
        max_param_abs_diff_conditioned=worst, fsdp_step_ms=fsdp_ms, plain_step_ms=plain_ms)
    assert launches["K2"] > 0 and launches["K3"] > 0, f"the FSDP step skipped K2/K3: {launches}"
    assert worst <= ADAM_ATOL, f"the FSDP step's params differ by {worst}"
    return launches


def phase_detector_dp_step(device, mesh, train_set):
    """The native-geometry dettrain detector's train step at B=8 under DDP
    (world 1) against the single-device step, same weights and draws: loss
    parts within LOSS_RTOL; the gradients DDP reduced (after the clipping)
    and the updated params within DET_DP_NOISE times what two single-device
    steps on the same inputs differ by (cuDNN's backward need not repeat
    bitwise), and never more than DP_RTOL apart where those two agree;
    K7/K8 launched; both steps timed."""
    from objectpermanence_tpu_torch.models.detector.training import (
        Draws, data_parallel_detector, make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.train.detector_loop import warmup_schedule
    inputs = train_batch(train_set, device)
    runs = {}
    for tag in ("ddp", "plain", "plain_again"):
        cfg, model, anchors = detector_training_setup(device)
        tensors = trainable_tensors(model)
        optimizer = torch.optim.SGD([t for _, t in tensors], lr=DET_LR,
                                    momentum=0.9, weight_decay=5e-4, dampening=0.0)
        step = make_detector_train_step(cfg, anchors, optimizer, warmup_schedule(DET_LR, 5))
        stepped = data_parallel_detector(model, cfg, anchors, mesh) if tag == "ddp" else model
        draws = Draws.sample(DET_BATCH, sum(a.shape[0] for a in anchors), DET_ROIS, device,
                             torch.Generator(device=device).manual_seed(5))
        read = reset_launches()
        parts = step(stepped, *inputs, draws=draws)
        torch.cuda.synchronize()
        launches = read()
        grads = {name: t.grad.detach().clone() for name, t in tensors}
        state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        ms = None
        if tag != "plain_again":
            gen = torch.Generator(device=device).manual_seed(6)
            ms = time_ms(lambda: step(stepped, *inputs, generator=gen), iters=DP_STEPS // 2)
        runs[tag] = ({k: float(v) for k, v in parts.items()}, grads, state, launches, ms)
    (parts, grads, state, launches, ms) = runs["ddp"]
    (plain_parts, plain_grads, plain_state, _, plain_ms) = runs["plain"]
    _, again_grads, again_state, _, _ = runs["plain_again"]
    loss_rel = {k: abs(parts[k] - plain_parts[k]) / abs(plain_parts[k]) for k in parts}
    diffs = {}
    for what, ours, ref, again in (("grad", grads, plain_grads, again_grads),
                                   ("param", state, plain_state, again_state)):
        diffs[f"{what}_rel_diff"] = max(rel_diff(v, ref[k]) for k, v in ours.items())
        diffs[f"{what}_noise"] = max(rel_diff(again[k], ref[k]) for k in ref)
        diffs[f"{what}_bound"] = max(DET_DP_NOISE * diffs[f"{what}_noise"], DP_RTOL)
    log("detector_dp_step", batch=DET_BATCH, loss_parts=json.dumps(parts),
        loss_rel_diff=json.dumps(loss_rel), **diffs,
        launches=json.dumps(launches), ddp_step_ms=ms, plain_step_ms=plain_ms)
    assert launches["K7"] > 0 and launches["K8"] > 0, f"the DDP step skipped K7/K8: {launches}"
    assert all(v <= LOSS_RTOL for v in loss_rel.values()), f"loss parts differ: {loss_rel}"
    for what in ("grad", "param"):
        assert diffs[f"{what}_rel_diff"] <= diffs[f"{what}_bound"], \
            f"DDP's {what}s differ from the single-device step's: {diffs}"
    return launches


# the model-parallel meshes (tensor, sequence, pipeline and expert parallel) and
# the dry run, each at world 1 over NCCL on the one card (their numerics across
# ranks are held against JAX on the CPU at world 2 and 4), at the shipped OPNet's
# full width and T=300: the TP step at the train batch of 16, the SP forward at
# the train path's eval batch of 64 and the shipped transformer_lstm at 16, the
# pipeline as one stage composing OPNet's four stage functions over 4
# microbatches of 4 videos, the expert-parallel head on the video LSTM's hidden
# (512) with 4 experts x 128, as opnet_moe ships it
SP_BATCH = 64
PP_MICROBATCHES = 4
MP_STEPS = 10        # calls timed per variant
# at width 1 the gathers, slices and all-reduces are copies and the products
# keep their shapes: the TP, SP and PP forwards equal the plain ones bitwise or
# within MP_ATOL (outputs of order 1)
MP_ATOL = 1e-6
# the expert-parallel head runs each expert's product alone where the dense head
# runs all experts in one einsum (sums in another order): within EP_RTOL x
# max(1, max |dense's|), forward and gradients
EP_RTOL = 1e-5


def opnet_train_batch(device, batch=TRAIN_BATCH):
    """The served boxes, their labels and an empty containment mask, tiled to
    `batch` videos."""
    with np.load(BENCH_CACHE) as blob:
        labels = blob["labels"][:, :FRAMES].astype(np.float32)
    labels = np.tile(labels, (-(-batch // labels.shape[0]), 1, 1))[:batch]
    return (served_boxes(batch, device), torch.from_numpy(labels).to(device),
            torch.zeros(batch, FRAMES, 4, dtype=torch.bool, device=device))


def step_record(model):
    """(grads, params) of a model after a step, whole (DTensors gathered)."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()
    grads = {n: whole(p.grad) for n, p in model.named_parameters()}
    params = {n: whole(p) for n, p in model.named_parameters()}
    return grads, params


def held_within_noise(tag, ours, plain, again):
    """Relative diffs of a mesh's step against the plain step, beside what
    two plain steps differ by; each within DET_DP_NOISE x that noise
    (floor DP_RTOL), as `detector_dp_step` holds DDP."""
    diffs = {}
    for i, what in enumerate(("grad", "param")):
        diffs[f"{what}_rel_diff"] = max(rel_diff(v, plain[i][k]) for k, v in ours[i].items())
        diffs[f"{what}_noise"] = max(rel_diff(again[i][k], plain[i][k]) for k in plain[i])
        diffs[f"{what}_bound"] = max(DET_DP_NOISE * diffs[f"{what}_noise"], DP_RTOL)
        assert diffs[f"{what}_rel_diff"] <= diffs[f"{what}_bound"], \
            f"{tag}: the {what}s differ from the plain step's: {diffs}"
    return diffs


def phase_tp_step(device, mesh, smi):
    """One train step of the shipped OPNet sharded over the (1, 1) mesh's
    `model` dim (`shard_params(strict=True)`, `make_train_step` with the
    mesh) against two plain steps from the same seeded weights: loss,
    gradients and params within the plain steps' noise; the weights and
    Adam's moments keep their shards; K2 and K3 launched; both steps timed."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from objectpermanence_tpu_torch.parallel.sharding import shard_params
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    boxes, labels, mask = opnet_train_batch(device)
    runs = {}
    for tag in ("tp", "plain", "plain_again"):
        spec, model, optimizer = opnet_step_setup(device)
        if tag == "tp":
            model = shard_params(model, mesh, strict=True)
            optimizer = make_optimizer(model.parameters(), 1e-3)
        step = make_train_step(spec, optimizer, mesh=mesh if tag == "tp" else None)
        read = reset_launches()
        loss = float(step(model, boxes, labels, mask)["loss"])
        torch.cuda.synchronize()
        launches = read()
        record = step_record(model)
        if tag == "tp":
            w_hh = dict(model.named_parameters())["video_lstm.w_hh"]
            for tensor in (w_hh, optimizer.state[w_hh]["exp_avg"]):
                assert isinstance(tensor, DTensor) and tuple(tensor.placements) == (
                    Replicate(), Shard(1)), f"tp sharding lost: {tensor.placements}"
        ms = None
        if tag != "plain_again":
            ms = time_ms(lambda: step(model, boxes, labels, mask), iters=MP_STEPS)
        runs[tag] = (loss, record, launches, ms)
    (loss, record, launches, tp_ms), (plain_loss, plain, _, plain_ms) = runs["tp"], runs["plain"]
    diffs = held_within_noise("tp_step", record, plain, runs["plain_again"][1])
    log("tp_step", batch=TRAIN_BATCH, frames=FRAMES, mesh="(data 1, model 1)", loss=loss,
        loss_rel_diff=0.0 if loss == plain_loss else rel_diff(loss, plain_loss), **diffs,
        launches=json.dumps(launches), tp_step_ms=tp_ms, plain_step_ms=plain_ms, card=repr(smi))
    assert launches["K2"] > 0 and launches["K3"] > 0, f"the TP step skipped K2/K3: {launches}"
    assert launches["K1"] == 0, launches
    assert abs(loss - plain_loss) <= DP_RTOL * abs(plain_loss), (loss, plain_loss)
    return launches


def phase_sp_forward(device, mesh, smi):
    """The sequence-parallel OPNet forward (flagship weights, B=64) and
    transformer_lstm forward (shipped width, seeded, B=16) on the (1, 1)
    mesh against the plain `forward_layers` (K4): within MP_ATOL; K4
    launched once a recurrence; then the SP IoU of the forward's boxes
    against the eval step's formula, and its self-IoU 1. Both forwards timed
    against the plain ones."""
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes, iou_xyxy
    from objectpermanence_tpu_torch.parallel.sequence import (
        make_sequence_parallel_iou, make_sequence_parallel_opnet_forward,
        make_sequence_parallel_transformer_forward,
    )
    from objectpermanence_tpu_torch.utils.checkpoint import load_params
    model_config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    opnet = get_model_spec("opnet").build(model_config)
    opnet.load_state_dict(load_params(FLAGSHIP_NPZ))
    opnet = opnet.to(device).eval()
    _, _, transformer = model_setup("transformer_lstm", device)
    boxes, labels, mask = opnet_train_batch(device, SP_BATCH)
    boxes5 = served_boxes(TRAIN_BATCH, device)[..., :5].contiguous()
    cases = {"opnet": (make_sequence_parallel_opnet_forward(mesh), opnet, boxes, 2),
             "transformer_lstm": (make_sequence_parallel_transformer_forward(mesh), transformer,
                                  boxes5, lstm_layers(transformer))}
    out, launches = {}, {}
    for name, (forward, model, inputs, recurrences) in cases.items():
        read = reset_launches()
        got = forward(model, inputs)
        torch.cuda.synchronize()
        launches[name] = read()
        with torch.no_grad():
            want = model.forward_layers(inputs)
        got, want = (g if isinstance(g, tuple) else (g,) for g in (got, want))
        err = max(max_err(a, b) for a, b in zip(got, want))
        assert launches[name]["K4"] == recurrences and sum(launches[name].values()) == \
            recurrences, f"sp {name}: {launches[name]}"
        assert err <= MP_ATOL, f"sp {name} forward differs from the plain one by {err}"
        sp_ms = time_ms(lambda: forward(model, inputs), iters=MP_STEPS)
        with torch.no_grad():
            plain_ms = time_ms(lambda: model.forward_layers(inputs), iters=MP_STEPS)
        out[name] = dict(max_abs_diff=err, sp_ms=sp_ms, plain_ms=plain_ms)
        if name == "opnet":
            y = got[0]
    sp_iou = make_sequence_parallel_iou(mesh)
    mean_iou, masked_sum, masked_frames = sp_iou(y, labels, mask)
    iou = iou_xyxy(denormalize_boxes(y).float(), denormalize_boxes(labels).float())
    # a sum over the frames, then / T, against the eval step's mean: within 1e-6
    iou_diff = max_err(mean_iou, iou.mean(dim=1))
    assert iou_diff <= 1e-6 and not masked_sum.any() and not masked_frames.any(), \
        f"sp IoU differs from the eval step's by {iou_diff}"
    self_iou = sp_iou(labels.clamp(0, 1).sort(dim=-1).values, labels.clamp(0, 1).sort(
        dim=-1).values, mask)[0]
    assert torch.allclose(self_iou, torch.ones_like(self_iou)), "sp self-IoU != 1"
    log("sp_forward", opnet_batch=SP_BATCH, transformer_batch=TRAIN_BATCH, frames=FRAMES,
        mesh="(data 1, model 1)", results=json.dumps(out), launches=json.dumps(launches),
        mean_iou=float(mean_iou.mean()), iou_max_abs_diff=iou_diff, card=repr(smi))
    return {tag: sum(l[tag] for l in launches.values()) for tag in launches["opnet"]}


def pp_whole_stage(config):
    """OPNet's four stage functions composed into one stage (a pipe of one
    rank), and the parameter names of its stage tree."""
    from objectpermanence_tpu_torch.parallel.pipeline import (
        opnet_pipeline_stages, opnet_stage_trees,
    )
    fns, _ = opnet_pipeline_stages(config, 4)

    def whole(local, transit, x_mb):
        for i, fn in enumerate(fns):
            transit = fn(local[f"s{i}"], transit, x_mb)
        return transit

    names = ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w", "video_lstm.w_ih",
             "video_lstm.w_hh", "box_head.w")
    trees = opnet_stage_trees({n: n for n in names}, 4)
    stage_names = {f"s{i}.{k}.{leaf}": name for i, tree in enumerate(trees)
                   for k, sub in tree.items() for leaf, name in sub.items()}

    def stage_tree(model):
        state = dict(model.named_parameters())
        return {f"s{i}": {k: {leaf: state[name] for leaf, name in sub.items()}
                          for k, sub in tree.items()} for i, tree in enumerate(trees)}

    return whole, stage_names, stage_tree


def phase_pp(device, mesh, smi):
    """The GPipe engine at one pipe rank: one stage composing OPNet's four
    stage functions, 4 microbatches of 4 videos, the shipped OPNet from the
    training seed. Its forward (K4 per microbatch and recurrence) against
    the plain `forward_layers` on the same microbatches, within MP_ATOL;
    one train step (K2/K3 per microbatch and recurrence) against the plain
    step over the same microbatches, within the noise of two such steps;
    the plain step at the whole batch beside it (GRAD_RTOL: K2/K3 at B=16
    against B=4 sum in another order). Each timed against the plain one at
    the whole batch."""
    from objectpermanence_tpu_torch.parallel.pipeline import (
        make_gpipe_forward, make_gpipe_train_step, stack_stage_param_list,
    )
    from objectpermanence_tpu_torch.train.losses import total_loss
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step
    model_config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    whole, stage_names, stage_tree = pp_whole_stage(model_config)
    boxes, labels, mask = opnet_train_batch(device)
    spec, model, _ = opnet_step_setup(device)
    local = stack_stage_param_list([stage_tree(model)], mesh)
    forward = make_gpipe_forward(mesh, [whole], transit_dim=4, out_dim=4,
                                 num_microbatches=PP_MICROBATCHES)
    read = reset_launches()
    y = forward(local, boxes)
    torch.cuda.synchronize()
    fwd_launches = read()
    with torch.no_grad():
        want = torch.cat([model.forward_layers(mb)[0] for mb in boxes.chunk(PP_MICROBATCHES)])
        whole_batch = model.forward_layers(boxes)[0]
    fwd_err, fwd_whole_err = max_err(y, want), max_err(y, whole_batch)
    assert fwd_err <= MP_ATOL, f"the pp forward differs from the plain one by {fwd_err}"
    assert fwd_whole_err <= ATOL, f"the pp forward differs from the whole batch's: {fwd_whole_err}"
    assert fwd_launches["K4"] == 2 * PP_MICROBATCHES and sum(fwd_launches.values()) == \
        fwd_launches["K4"], f"pp forward: {fwd_launches}"
    pp_fwd_ms = time_ms(lambda: forward(local, boxes), iters=MP_STEPS)
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: model.forward_layers(boxes), iters=MP_STEPS)

    optimizer = make_optimizer(local.parameters(), 1e-3)
    step = make_gpipe_train_step(mesh, [whole], optimizer, transit_dim=4, out_dim=4,
                                 num_microbatches=PP_MICROBATCHES)
    read = reset_launches()
    metrics = step(local, boxes, labels, mask)
    torch.cuda.synchronize()
    step_launches = read()
    grads, params = step_record(local)
    ours = ({stage_names[k]: v for k, v in grads.items()},
            {stage_names[k]: v for k, v in params.items()})
    pp_step_ms = time_ms(lambda: step(local, boxes, labels, mask), iters=MP_STEPS)

    def microbatched_step():
        _, twin, twin_opt = opnet_step_setup(device)
        twin_opt.zero_grad(set_to_none=True)
        y = torch.cat([twin.forward_layers(mb)[0] for mb in boxes.chunk(PP_MICROBATCHES)])
        loss = total_loss(y, labels, mask, False)[0]
        loss.backward()
        twin_opt.step()
        return step_record(twin), float(loss.detach())

    plain, plain_loss = microbatched_step()
    again, _ = microbatched_step()
    diffs = held_within_noise("pp_step", ours, plain, again)
    _, full, full_opt = opnet_step_setup(device)
    full_step = make_train_step(spec, full_opt)
    full_step(full, boxes, labels, mask)
    full_grads, _ = step_record(full)
    whole_grad_rel = max(rel_diff(v, full_grads[k]) for k, v in ours[0].items())
    assert whole_grad_rel <= GRAD_RTOL, f"pp grads vs the whole batch's: {whole_grad_rel}"
    plain_step_ms = time_ms(lambda: full_step(full, boxes, labels, mask), iters=MP_STEPS)
    log("pp", batch=TRAIN_BATCH, microbatches=PP_MICROBATCHES, frames=FRAMES,
        mesh="(data 1, pipe 1)", fwd_max_abs_diff=fwd_err, fwd_whole_batch_diff=fwd_whole_err,
        loss=float(metrics["loss"]), plain_loss=plain_loss, **diffs,
        grad_rel_diff_whole_batch=whole_grad_rel, fwd_launches=json.dumps(fwd_launches),
        step_launches=json.dumps(step_launches), pp_fwd_ms=pp_fwd_ms, plain_fwd_ms=plain_fwd_ms,
        pp_step_ms=pp_step_ms, plain_step_ms=plain_step_ms, card=repr(smi))
    assert step_launches["K2"] == 2 * PP_MICROBATCHES and step_launches["K3"] == \
        2 * PP_MICROBATCHES, f"pp step: {step_launches}"
    return {tag: fwd_launches[tag] + step_launches[tag] for tag in fwd_launches}


def phase_ep(device, mesh, smi):
    """The expert-parallel MoE head (4 experts x 128 on the video hidden of
    512, seeded) on the (1, 1) (data, expert) mesh, on the flagship OPNet's
    video LSTM hidden of the train batch, against the dense `MoEHead`:
    forward and the gradients of mean(y^2) within EP_RTOL x max(1, max
    |dense's|); the experts held as one shard; no kernel of the port
    launched (library products). Both timed, forward and backward."""
    from objectpermanence_tpu_torch.models.moe import MoEHead
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.parallel.expert import (
        make_expert_parallel_moe_head, shard_expert_params,
    )
    from objectpermanence_tpu_torch.utils.checkpoint import load_params
    model_config = json.loads((REPO / "configs" / "opnet_model_config.json").read_text())
    opnet = get_model_spec("opnet").build(model_config)
    opnet.load_state_dict(load_params(FLAGSHIP_NPZ))
    opnet = opnet.to(device).eval()
    with torch.no_grad():
        h = opnet.video_lstm(opnet.who_to_attend(served_boxes(TRAIN_BATCH, device))[0])
    hidden = model_config["videos_hidden_dim"]
    dense = MoEHead(hidden, 4, num_experts=4, expert_hidden=128,
                    generator=torch.Generator().manual_seed(MODELS_SEED)).to(device)
    sharded = shard_expert_params(dense, mesh)
    head = make_expert_parallel_moe_head(mesh)
    read = reset_launches()
    y = head(sharded, h)
    (y ** 2).mean().backward()
    torch.cuda.synchronize()
    launches = read()
    want = dense(h)
    (want ** 2).mean().backward()

    def err(a, b):
        return max_err(a, b) / max(1.0, float(b.abs().max()))
    errors = {"forward": err(y.detach(), want.detach())}
    errors.update({f"grad_{k}": err(p.grad.to_local(), getattr(dense, k).grad)
                   for k, p in sharded.items()})
    assert all(v <= EP_RTOL for v in errors.values()), f"ep head differs: {errors}"
    assert sharded["w1"].to_local().shape[0] == 4, "ep experts not held whole at width 1"
    assert sum(launches.values()) == 0, f"the ep head launched a kernel: {launches}"

    def ep_pass():
        (head(sharded, h) ** 2).mean().backward()

    def dense_pass():
        (dense(h) ** 2).mean().backward()

    log("ep_head", batch=TRAIN_BATCH, frames=FRAMES, hidden=hidden, experts=4,
        expert_hidden=128, mesh="(data 1, expert 1)", rel_errors=json.dumps(errors),
        launches=json.dumps(launches), ep_fwd_bwd_ms=time_ms(ep_pass, iters=MP_STEPS),
        dense_fwd_bwd_ms=time_ms(dense_pass, iters=MP_STEPS), card=repr(smi))
    return launches


def phase_dryrun(device, smi):
    """`dryrun_multichip(1, device="cuda")` inside the world-1 NCCL group:
    the dp+tp step (K2/K3), the SP IoU and forward (K4) and the FSDP step at
    the flagship width; its closing line in JAX's form."""
    from objectpermanence_tpu_torch.parallel.dryrun import dryrun_multichip
    read = reset_launches()
    t0 = time.perf_counter()
    line = dryrun_multichip(1, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read()
    log("dryrun", line=repr(line), seconds=f"{seconds:.3f}", launches=json.dumps(launches),
        card=repr(smi))
    assert line.startswith("dryrun_multichip(1): mesh={'data': 1, 'model': 1} loss=") and \
        line.endswith("dp+tp+sp(iou+opnet-fwd)+fsdp ok"), line
    assert launches["K2"] > 0 and launches["K3"] > 0 and launches["K4"] > 0, launches
    assert launches["K1"] == 0, launches
    return launches


def phase_model_parallel(device, smi):
    """The model-parallel phases and the dry run in one world-1 NCCL process
    group; returns their launches, by kernel."""
    import torch.distributed as dist
    from objectpermanence_tpu_torch.parallel.mesh import make_expert_mesh, make_pipe_mesh
    mesh = world_one_nccl()
    try:
        parts = [phase_tp_step(device, mesh, smi), phase_sp_forward(device, mesh, smi),
                 phase_pp(device, make_pipe_mesh(n_data=1, n_pipe=1), smi),
                 phase_ep(device, make_expert_mesh(n_data=1, n_expert=1), smi),
                 phase_dryrun(device, smi)]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return {tag: sum(part[tag] for part in parts) for tag in parts[0]}


# the experiment drivers (objectpermanence_tpu_torch/experiments/) at a small scale:
# simulated splits of 300-frame scenes with 8 objects, the shipped OPNet 256/512
# (and baseline_lstm, opnet_moe at their shipped widths), the reference recipe
# cut from 160 epochs to 2 (the sweep's to 1); the unbiased split's uniform planner
EXP_SPLITS = {"train": 32, "dev": 8, "test": 8}
EXP_EPOCHS, EXP_SWEEP_EPOCHS, EXP_UNBIASED_VIDEOS = 2, 1, 8
EXP_SWEEP = ("opnet", "baseline_lstm", "opnet_moe")
EXP_UNBSUB = {"train": 16, "dev": 4}
SWEEP_KEYS = {"model", "best_dev_miou", "test_overall_iou", "test_contained_iou",
              "test_visible_iou", "test_map_0.5", "train_seconds"}
UNBIASED_KEYS = {"model", "overall_iou", "contained_iou", "contained_ratio", "visible_iou",
                 "map_0.5"}


def phase_experiments(device):
    """The six reasoning-side experiment drivers through their main()s, as
    `python -m objectpermanence_tpu_torch.experiments.<name>` runs them, with
    every launch count read around each: `containment_run` datagen (host),
    train (K2/K3, K4 in eval) and analyze (K1 only; its predictions held
    within a pixel of the plain forward on the trained weights);
    `variant_sweep` over opnet, baseline_lstm and opnet_moe (training K2/K3/K4,
    opnet's inference K1, the others' K4); `cater_grid_run` for opnet (K1
    only) and for the other two (K4 only; transformer_lstm, never trained
    here, is skipped); `make_unbsub` over the root (host); `unbiased_eval` of
    the sweep's opnet on a uniform-planner split (K1 only); `moe_balance` of
    the sweep's opnet_moe (K4 only: no gradient). Checks each written file's
    shape; returns the launches by kernel, summed over the drivers."""
    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.experiments import (
        cater_grid_run, containment_run, make_unbsub, moe_balance, unbiased_eval, variant_sweep,
    )
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference
    from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint, load_params

    work = WORK_DIR / "experiments"
    shutil.rmtree(work, ignore_errors=True)
    root, unbsub, unbiased = work / "sim", work / "unbsub", work / "unbiased"
    seconds, counts = {}, {}
    phase_start = time.perf_counter()

    def drive(stage, main, argv):
        read = reset_launches()
        t0 = time.perf_counter()
        main([str(a) for a in argv])
        torch.cuda.synchronize()
        seconds[stage] = round(time.perf_counter() - t0, 3)
        counts[stage] = read()
        return counts[stage]

    def only(launches, *tags):
        """Launches of `tags` and of no other kernel."""
        return all(launches[t] > 0 for t in tags) and \
            sum(launches.values()) == sum(launches[t] for t in tags)

    got = drive("datagen", containment_run.main, [
        "datagen", "--root", root, "--train-videos", EXP_SPLITS["train"],
        "--dev-videos", EXP_SPLITS["dev"], "--test-videos", EXP_SPLITS["test"],
        "--frames", FRAMES, "--objects", 8])
    assert sum(got.values()) == 0, f"datagen launched kernels: {got}"
    for split, videos in EXP_SPLITS.items():
        assert len(list((root / split / "od_perception").glob("*.pkl"))) == videos, split

    got = drive("train", containment_run.main, ["train", "--root", root, "--epochs", EXP_EPOCHS])
    assert only(got, "K2", "K3", "K4"), f"training: {got}"
    epochs = [json.loads(line) for line in (root / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in epochs] == list(range(1, EXP_EPOCHS + 1)), epochs
    assert all(np.isfinite(e[s]["loss"]) for e in epochs for s in ("train", "dev")), epochs

    got = drive("analyze", containment_run.main, ["analyze", "--root", root])
    assert only(got, "K1"), f"analyze: {got}"
    lines = (root / "analysis.csv").read_text().splitlines()
    header = lines[0].split(",")
    rows = [dict(zip(header, line.split(","))) for line in lines[1:]]
    assert len(rows) == EXP_SPLITS["test"], f"{len(rows)} rows"
    for column in ("overall_iou", "overall_map_0.5", "overall_map_0.9", "contained_mean_iou",
                   "full_occlusion_mean_iou", "visibility_gt_0_mean_map_0.9"):
        assert column in header, f"no {column} column"
    assert all(0.0 <= float(r["overall_iou"]) <= 1.0 for r in rows), "IoU out of [0, 1]"
    # analyze's predictions against the plain forward on the trained weights
    test = root / "test"
    dataset = ingest_directory(test / "od_perception", test / "labels", 6)
    predicted = np.stack([np.array(json.loads((root / "results" / f"{n}_bb.json").read_text()))
                          for n in dataset.names])
    state = load_params(best_params_checkpoint(root / "checkpoints" / "opnet"))
    trained = [state[k].to(device) for k in ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w",
                                             "video_lstm.w_ih", "video_lstm.w_hh",
                                             "box_head.w")]
    want_y, _ = opnet_forward_reference(torch.from_numpy(dataset.boxes).to(device), *trained)
    px_max, px_share = pixel_diff(torch.from_numpy(predicted), denormalize_boxes(want_y).cpu())
    assert predicted.shape == (EXP_SPLITS["test"], FRAMES, 4)
    assert px_max <= PX_MAX and px_share <= PX_SHARE, "analyze disagrees with plain"

    got = drive("variant_sweep", variant_sweep.main, [
        "--root", root, "--epochs", EXP_SWEEP_EPOCHS, "--models", *EXP_SWEEP])
    assert only(got, "K1", "K2", "K3", "K4"), f"variant_sweep: {got}"
    sweep_rows = json.loads((root / "sweep" / "results.json").read_text())
    assert [r["model"] for r in sweep_rows] == list(EXP_SWEEP), sweep_rows
    for r in sweep_rows:
        assert set(r) == SWEEP_KEYS, r
        assert all(0.0 <= r[k] <= 1.0 for k in SWEEP_KEYS - {"model", "train_seconds"}), r

    got = drive("cater_grid_run_opnet", cater_grid_run.main,
                ["--root", root, "--models", "opnet"])
    assert only(got, "K1"), f"cater_grid_run opnet: {got}"
    got = drive("cater_grid_run_others", cater_grid_run.main,
                ["--root", root, "--models", "baseline_lstm", "opnet_moe", "transformer_lstm"])
    assert only(got, "K4"), f"cater_grid_run baseline_lstm, opnet_moe: {got}"
    grid_rows = json.loads((root / "cater" / "grid_results.json").read_text())
    assert [r["model"] for r in grid_rows] == list(EXP_SWEEP), grid_rows
    for r in grid_rows:
        assert set(r) == {"model", "videos", "grid_top1_acc", "grid_l1_dist"}, r
        assert r["videos"] == EXP_SPLITS["test"] and 0.0 <= r["grid_top1_acc"] <= 1.0, r
        assert 0.0 <= r["grid_l1_dist"] <= 10.0, r

    got = drive("make_unbsub", make_unbsub.main, [
        "--src", root, "--out", unbsub, "--train", EXP_UNBSUB["train"],
        "--dev", EXP_UNBSUB["dev"]])
    assert sum(got.values()) == 0, f"make_unbsub launched kernels: {got}"
    for split, videos in EXP_UNBSUB.items():
        for kind, pattern in (("scenes", "*.json"), ("labels", "*_bb.json")):
            links = sorted((unbsub / split / kind).glob(pattern))
            assert len(links) == videos and all(p.is_symlink() for p in links), (split, kind)
            assert all(p.resolve().parent == (root / split / kind).resolve() for p in links)
        assert (unbsub / split / "od_perception").is_symlink()
        assert (unbsub / split / "annotations" / "containment_annotations.txt").is_file()
    assert (unbsub / "test").resolve() == (root / "test").resolve()

    got = drive("unbiased_eval", unbiased_eval.main, [
        "--root", unbiased, "--videos", EXP_UNBIASED_VIDEOS, "--frames", FRAMES,
        "--checkpoints-root", root, "--models", "opnet"])
    assert only(got, "K1"), f"unbiased_eval: {got}"
    unbiased_rows = json.loads((unbiased / "results.json").read_text())
    assert len(unbiased_rows) == 1 and set(unbiased_rows[0]) == UNBIASED_KEYS, unbiased_rows

    got = drive("moe_balance", moe_balance.main, ["--root", root, "--sweep-dir", "sweep"])
    assert only(got, "K4"), f"moe_balance: {got}"
    balance = json.loads((root / "sweep" / "moe_balance.json").read_text())
    assert balance["videos"] == EXP_SPLITS["test"] and len(balance["expert_fraction"]) == 4
    assert abs(sum(balance["expert_fraction"]) - 1.0) <= 1e-3, balance
    assert 0.25 <= balance["mean_gate_prob"] <= 1.0, balance

    total = {tag: sum(c[tag] for c in counts.values()) for tag in counts["train"]}
    log("experiments", seconds=f"{time.perf_counter() - phase_start:.3f}",
        stage_seconds=json.dumps(seconds), launches=json.dumps(total),
        launches_by_stage=json.dumps({s: {k: v for k, v in c.items() if v}
                                      for s, c in counts.items()}),
        train_dev_miou=epochs[-1]["dev"]["mean_iou"], analyze_px_max_diff_vs_plain=px_max,
        analyze_px_diff_share=px_share, sweep=json.dumps(sweep_rows),
        grid=json.dumps(grid_rows), unbiased=json.dumps(unbiased_rows),
        moe_balance=json.dumps(balance))
    return total


# the perception and tracker experiment drivers (objectpermanence_tpu_torch/
# experiments/) on the card at full width and small depth: simulated splits of
# 300-frame scenes (4 objects), rendered; the two-stage detector at the dettrain
# recipe (GroupNorm ResNet-50 FPN 256, 240 x 320, RPN 500/300, batch 8) 1 epoch, its
# `preprocess` over every video, OPNet 256/512 on the real detections 2 epochs; the
# 800 px recipe (800 x 1088 padded, windowed) in steptime (3 steps a row), train800
# in bf16 and native for 1 epoch, contract, and two infer800 configs (one fp32, one
# bf16); the transfer demo at its own sizes (24 + 8 + 4 60-frame videos) for 1 + 1
# epochs, fp32 and bf16; SiamRPN at its shipped width on the two-stage train
# videos' pairs (batch 8, 2 epochs: its schedule warms up over the first epoch),
# then OPE on 2 test videos; tracker_benchmark on 2 fresh 300-frame fixture videos.
# Cut from the JAX runs' 3,200 / 1,600 training videos and 12-16 detector epochs.
PERC_SPLITS = {"train": 6, "dev": 2, "test": 4}
PERC_DET_SAMPLES, PERC_STEPS, PERC_OPNET_EPOCHS = 4, 3, 2
PERC_SIAM = {"pairs": 24, "holdout": 8, "batch": 8, "epochs": 2}
PERC_TRACKER_VIDEOS = 2
DET_REPORT_KEYS = {"best_dev_map", "test", "history", "checkpoint"}
DET800_REPORT_KEYS = {"geometry", "epochs", "batch", "compute_dtype", "best_dev_map", "test",
                      "train_seconds", "train_contract", "eval_contract", "history",
                      "checkpoint"}
MAP_KEYS = {"mAP", "AP50", "AP75"}
OPE_KEYS = {"success_auc", "precision_20px", "mean_iou"}


def phase_perception_experiments(device):
    """The six perception and tracker experiment drivers through their
    main()s, as `python -m objectpermanence_tpu_torch.experiments.<name>`
    runs them, with every launch count read around each stage: the
    `two_stage_run` chain (render on the host; dettrain K7 + K8; preprocess
    K7 only; opnet K2/K3/K4; analyze K1 only, its boxes held within a pixel
    of the plain forward on the trained weights); `detector_800px_run`
    (render on the host; steptime K9 + K7 + K8, the windowed row's K9 and
    the exact rows' K7; train800 in bf16 K9 bf16 + K8 bf16; native K7 + K8;
    contract nothing); `detector_infer800` fp32_windowed (K9) and
    bf16_windowed (K9 bf16); `detector_transfer_demo` (K7 + K8, and with
    `--bf16` K7 bf16 + K8 bf16); `tracker_benchmark` and `siam_run`
    (SiamRPN's library convolutions: nothing). The bf16 launches are the
    wrappers' own count of them, so each stage is held to its dtype too.
    `siam_run train` holds out PERC_SIAM["holdout"] of its few pairs (the
    driver's fixed 256 needs 64 videos' pairs). Checks each written file's
    schema; returns the launches by kernel and dtype."""
    import functools
    import pickle
    from unittest import mock

    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.experiments import (
        containment_run, detector_800px_run, detector_infer800, detector_transfer_demo, siam_run,
        tracker_benchmark, two_stage_run,
    )
    from objectpermanence_tpu_torch.ops.boxes import denormalize_boxes
    from objectpermanence_tpu_torch.ops.opnet_fused import opnet_forward_reference
    from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint, load_params

    work = WORK_DIR / "perception"
    shutil.rmtree(work, ignore_errors=True)
    src, ts, det, transfer = work / "src", work / "twostage", work / "det800", work / "transfer"
    seconds, counts = {}, {}
    phase_start = time.perf_counter()

    def drive(stage, main, argv):
        read = reset_launches(by_dtype=True)
        t0 = time.perf_counter()
        main([str(a) for a in argv])
        torch.cuda.synchronize()
        seconds[stage] = round(time.perf_counter() - t0, 3)
        counts[stage] = read()
        return counts[stage]

    def only(launches, *tags):
        """Launches of `tags` and of no other kernel."""
        return all(launches[t] > 0 for t in tags) and \
            sum(launches.values()) == sum(launches[t] for t in tags)

    def none(stage, launches):
        assert sum(launches.values()) == 0, f"{stage} launched kernels: {launches}"

    def report(path, keys):
        data = json.loads(path.read_text())
        assert keys <= set(data), (path, sorted(data))
        return data

    none("datagen", drive("datagen", containment_run.main, [
        "datagen", "--root", src, "--train-videos", PERC_SPLITS["train"],
        "--dev-videos", PERC_SPLITS["dev"], "--test-videos", PERC_SPLITS["test"],
        "--frames", FRAMES, "--objects", 4]))

    # two_stage_run
    stage = ["--root", ts, "--src", src]
    none("ts_render", drive("ts_render", two_stage_run.main,
                            ["render", *stage, "--det-samples", PERC_DET_SAMPLES]))
    for split, videos in PERC_SPLITS.items():
        assert len(list((ts / split / "videos").glob("*.avi"))) == videos, split
        assert len(list((ts / split / "det_images").glob("*.png"))) == videos * PERC_DET_SAMPLES
    got = drive("ts_dettrain", two_stage_run.main, ["dettrain", *stage, "--det-epochs", 1])
    assert only(got, "K7", "K8"), f"dettrain: {got}"
    dettrain = report(ts / "detector" / "report.json", DET_REPORT_KEYS)
    assert set(dettrain["test"]) == MAP_KEYS and (ts / "detector" / ".done").exists()
    assert len(dettrain["history"]) == 1 and np.isfinite(dettrain["history"][0]["train_loss"])
    got = drive("ts_preprocess", two_stage_run.main, ["preprocess", *stage])
    assert only(got, "K7"), f"preprocess: {got}"
    assert got["K7"] == sum(PERC_SPLITS.values()) * -(-FRAMES // 32), got
    stats = json.loads((ts / "perception_stats.json").read_text())
    for split, videos in PERC_SPLITS.items():
        assert stats[split]["videos"] == videos, stats
        for path in (ts / split / "od_real").glob("*.pkl"):
            with open(path, "rb") as f:
                data = pickle.load(f)
            assert len(data["bb"]) == len(data["labels"]) == FRAMES, path
    got = drive("ts_opnet", two_stage_run.main, ["opnet", *stage, "--epochs", PERC_OPNET_EPOCHS])
    assert only(got, "K2", "K3", "K4"), f"opnet: {got}"
    epochs = [json.loads(line) for line in (ts / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in epochs] == list(range(1, PERC_OPNET_EPOCHS + 1)), epochs
    assert all(np.isfinite(e[s]["loss"]) for e in epochs for s in ("train", "dev")), epochs
    meta = json.loads((ts / "train_meta.json").read_text())
    assert meta["train_videos"] == PERC_SPLITS["train"] and meta["epochs"] == PERC_OPNET_EPOCHS
    got = drive("ts_analyze", two_stage_run.main, ["analyze", *stage])
    assert only(got, "K1"), f"analyze: {got}"
    lines = (ts / "analysis.csv").read_text().splitlines()
    header = lines[0].split(",")
    assert len(lines) == 1 + PERC_SPLITS["test"], lines
    for column in ("overall_iou", "contained_mean_iou", "full_occlusion_mean_iou",
                   "overall_map_0.5"):
        assert column in header, f"no {column} column"
    dataset = ingest_directory(ts / "test" / "od_real", src / "test" / "labels", 6)
    predicted = np.stack([np.array(json.loads((ts / "results" / f"{n}_bb.json").read_text()))
                          for n in dataset.names])
    state = load_params(best_params_checkpoint(ts / "checkpoints" / "opnet"))
    trained = [state[k].to(device) for k in ("att_lstm.w_ih", "att_lstm.w_hh", "att_head.w",
                                             "video_lstm.w_ih", "video_lstm.w_hh",
                                             "box_head.w")]
    want_y, _ = opnet_forward_reference(torch.from_numpy(dataset.boxes).to(device), *trained)
    px_max, px_share = pixel_diff(torch.from_numpy(predicted), denormalize_boxes(want_y).cpu())
    assert predicted.shape == (PERC_SPLITS["test"], FRAMES, 4)
    assert px_max <= PX_MAX and px_share <= PX_SHARE, "analyze disagrees with plain"

    # detector_800px_run
    stage = ["--root", det, "--src", src]
    none("d8_render", drive("d8_render", detector_800px_run.main,
                            ["render", *stage, "--det-samples", PERC_DET_SAMPLES]))
    got = drive("d8_steptime", detector_800px_run.main, ["steptime", *stage, "--steps", PERC_STEPS])
    assert only(got, "K7", "K8", "K9"), f"steptime: {got}"
    # per step: the windowed row K9 + K8, the gather and native rows K7 + K8
    assert got["K9"] == got["K7"] // 2 == got["K8"] // 3 == 3 + PERC_STEPS, got
    steptime = json.loads((det / "steptime.json").read_text())
    assert list(steptime) == ["800px_windowed", "800px_gather", "native_pallas"], steptime
    assert [r["roi_path"] for r in steptime.values()] == ["windowed", "exact", "exact"]
    assert all(r["step_ms"] > 0 for r in steptime.values()), steptime
    got = drive("d8_train800", detector_800px_run.main,
                ["train800", *stage, "--epochs", 1, "--compute-dtype", "bfloat16"])
    assert only(got, "K8_bf16", "K9_bf16"), f"train800: {got}"
    det800 = report(det / "det800" / "report.json", DET800_REPORT_KEYS)
    assert det800["compute_dtype"] == "bfloat16" and set(det800["test"]) == MAP_KEYS
    for key in ("train_contract", "eval_contract"):
        assert det800[key]["rois"] > 0 and det800[key]["rate"] is not None, det800[key]
    got = drive("d8_native", detector_800px_run.main, ["native", *stage, "--epochs", 1])
    assert only(got, "K7", "K8"), f"native: {got}"
    detnative = report(det / "detnative" / "report.json", DET800_REPORT_KEYS)
    assert detnative["train_contract"]["rois"] == 0, detnative["train_contract"]
    none("d8_contract", drive("d8_contract", detector_800px_run.main, ["contract", *stage]))
    recount = json.loads((det / "det800" / "report.json").read_text())
    for key in ("train_contract_cuda", "eval_contract_cuda"):
        assert recount[key]["rois"] > 0 and 0 <= recount[key]["rate"] <= 1, recount[key]

    # detector_infer800, one fp32 and one bf16 config
    infer_counts = {}
    for name, kernel in (("fp32_windowed", "K9"), ("bf16_windowed", "K9_bf16")):
        infer_counts[name] = drive(f"i8_{name}", detector_infer800.main, [
            "--root", det, "--configs", name, "--iters", PERC_STEPS])
        assert only(infer_counts[name], kernel), f"infer800 {name}: {infer_counts[name]}"
    infer800 = json.loads((det / "infer800.json").read_text())
    assert list(infer800) == ["fp32_windowed", "bf16_windowed"], infer800
    for row in infer800.values():
        assert row["fps"] > 0 and set(row["test"]) == MAP_KEYS, row

    # detector_transfer_demo, fp32 then bf16 on the same rendered sets
    got = drive("transfer", detector_transfer_demo.main, [
        "--root", transfer, "--pretrain-epochs", 1, "--finetune-epochs", 1])
    assert only(got, "K7", "K8"), f"transfer: {got}"
    (work / "transfer_bf16").mkdir()
    for tag in ("pretrain", "finetune", "finetune_eval"):
        (work / "transfer_bf16" / tag).symlink_to(transfer / tag)
    got = drive("transfer_bf16", detector_transfer_demo.main, [
        "--root", work / "transfer_bf16", "--pretrain-epochs", 1, "--finetune-epochs", 1,
        "--bf16"])
    assert only(got, "K7_bf16", "K8_bf16"), f"transfer --bf16: {got}"
    for root in (transfer, work / "transfer_bf16"):
        results = json.loads((root / "results.json").read_text())
        assert set(results) == {"from_pretrained", "from_scratch"}, results
        assert all(len(r["history"]) == 1 and 0 <= r["best_map"] <= 1
                   for r in results.values()), results
        assert (root / "pretrained.pth").is_file()

    # tracker_benchmark and siam_run: SiamRPN is library convolutions
    bench = work / "trackbench"
    none("tracker_benchmark", drive("tracker_benchmark", tracker_benchmark.main, [
        "--root", bench, "--videos", PERC_TRACKER_VIDEOS, "--frames", FRAMES]))
    siam = work / "siam"
    argv = ["--root", siam, "--train-src", src / "train", "--train-videos", ts / "train" / "videos",
            "--bench-src", src / "test", "--bench-videos", ts / "test" / "videos",
            "--pairs", PERC_SIAM["pairs"], "--batch", PERC_SIAM["batch"],
            "--epochs", PERC_SIAM["epochs"], "--bench-limit", 2]
    with mock.patch.object(siam_run, "siam_train_main", functools.partial(
            siam_run.siam_train_main, holdout=PERC_SIAM["holdout"])):
        for name in ("data", "train", "bench"):
            none(f"siam_{name}", drive(f"siam_{name}", siam_run.main, [name, *argv]))
    with np.load(siam / "pairs.npz") as pairs:
        assert pairs["z"].shape[1:] == (127, 127, 3), pairs["z"].shape
        assert PERC_SIAM["holdout"] + PERC_SIAM["batch"] <= len(pairs["gt"]) <= PERC_SIAM["pairs"]
    assert (siam / "checkpoint" / "final.npz").is_file()
    ope = {}
    for root in (bench, siam / "ope"):
        rows = json.loads((root / "results.json").read_text())
        assert set(rows) == {"detector_heuristic", "detector_tracker", "siamrpn_raw"}, rows
        for row in rows.values():
            assert OPE_KEYS <= set(row) and all(0 <= row[k] <= 1 for k in OPE_KEYS), row
        ope[root.parent.name if root.name == "ope" else root.name] = rows

    launches = {
        "K1": counts["ts_analyze"]["K1"],
        **{tag: counts["ts_opnet"][tag] for tag in ("K2", "K3", "K4")},
        "K7": sum(counts[s]["K7"] for s in ("ts_dettrain", "ts_preprocess", "d8_steptime",
                                            "d8_native", "transfer")),
        "K8": sum(counts[s]["K8"] for s in ("ts_dettrain", "d8_steptime", "d8_native",
                                            "transfer")),
        "K8_bf16": counts["d8_train800"]["K8_bf16"] + counts["transfer_bf16"]["K8_bf16"],
        "K7_bf16": counts["transfer_bf16"]["K7_bf16"],
        "K9_f32": counts["d8_steptime"]["K9"] + infer_counts["fp32_windowed"]["K9"],
        "K9_bf16": counts["d8_train800"]["K9_bf16"] + infer_counts["bf16_windowed"]["K9_bf16"],
    }
    log("perception_experiments", seconds=f"{time.perf_counter() - phase_start:.3f}",
        stage_seconds=json.dumps(seconds), launches=json.dumps(launches),
        launches_by_stage=json.dumps({s: {k: v for k, v in c.items() if v}
                                      for s, c in counts.items()}),
        dettrain_test=json.dumps(dettrain["test"]), perception=json.dumps(stats),
        opnet_dev_miou=epochs[-1]["dev"]["mean_iou"], analyze_px_max_diff_vs_plain=px_max,
        analyze_px_diff_share=px_share, steptime=json.dumps(steptime),
        det800_test=json.dumps(det800["test"]),
        det800_contract=json.dumps({k: recount[k] for k in (
            "train_contract", "eval_contract", "train_contract_cuda", "eval_contract_cuda")}),
        detnative_test=json.dumps(detnative["test"]),
        infer800=json.dumps({k: {f: v[f] for f in ("fps", "ms_per_batch", "batch", "test")}
                             for k, v in infer800.items()}),
        ope=json.dumps(ope))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import objectpermanence_tpu_torch  # noqa: F401  fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    name, count, smi = phase_device()
    phase_build()
    weights = flagship_weights(device)
    max_abs_err = compare_kernel(BATCH, weights, device)
    compare_kernel(RAGGED_BATCH, weights, device)
    k1_bf16_error = phase_opnet_bf16_vs_plain(weights, device)
    lstm_errors = phase_lstm_vs_plain(weights, device)
    detector = detector_setup(device)
    roi_errors, roi_inputs = phase_roi_align_vs_plain(detector)
    det800_bf16 = det800_detector(device, "bfloat16")
    windowed_errors, windowed_inputs = phase_roi_align_windowed_vs_plain(det800_bf16)
    windowed_errors["K7_bf16"], native_bf16_inputs = phase_roi_align_bf16_vs_plain(device)
    train_set, dev_set = detection_sets(REPO / "build" / "chip_smoke_detection")
    k8_error, k8_inputs = phase_roi_align_grad_vs_plain(dettrain_detector(device), train_set)
    k8_bf16_error, k8_bf16_inputs = phase_roi_align_bf16_grad_vs_plain(device, train_set)
    k8_bf16_error = max(k8_bf16_error, phase_roi_align_bf16_grad_native_vs_plain(
        native_bf16_inputs))
    roi_errors["K7"] = max(roi_errors["K7"], windowed_errors["K7_f32_800"])
    phase_models_vs_plain(device)
    launches = phase_main_path(weights, device)
    phase_analysis_path()
    k1_bf16_launches = phase_main_path_bf16(weights, device)
    train_launches = phase_train_path(device)
    phase_cater_path(device)
    models_launches = phase_models_path(device)
    preprocess_launches = phase_preprocess_path(device)
    detector_train_launches = phase_detector_train_path(train_set, dev_set)
    train800_launches = phase_detector_train_800_path(train_set, dev_set)
    preprocess_800_launches = phase_preprocess_800_path(device)
    phase_detector_train_step_swap(device, train_set)
    phase_detector_train_800_step_swap(device, train_set)
    phase_train_step_profile(device)
    phase_models_step_profile(device, smi)
    phase_bench_torch()
    phase_detect_profile(detector)
    phase_detect_800_profile(det800_bf16, det800_detector(device, "float32"))
    dp_launches = phase_dp_train_path(phase_native_ingest(), device, train_set)
    mp_launches = phase_model_parallel(device, smi)
    exp_launches = phase_experiments(device)
    kernels = [phase_times(weights, device, launches + exp_launches["K1"], max_abs_err),
               phase_times(weights, device, k1_bf16_launches, k1_bf16_error, torch.bfloat16)]
    lstm_launches = {tag: train_launches[tag] + models_launches[tag] + dp_launches[tag]
                     + mp_launches[tag] + exp_launches[tag] for tag in ("K2", "K3", "K4")}
    kernels += phase_lstm_times(weights, device, lstm_launches, lstm_errors)
    roi_launches = {**preprocess_launches, "K7": preprocess_launches["K7"] + dp_launches["K7"]}
    kernels += phase_roi_times(roi_inputs, roi_launches, roi_errors)
    kernels += [phase_k8_times(k8_inputs, detector_train_launches["K8"] + dp_launches["K8"],
                               k8_error),
                phase_k8_bf16_times(k8_bf16_inputs, train800_launches["K8"], k8_bf16_error)]
    kernels += phase_windowed_times(windowed_inputs, native_bf16_inputs, preprocess_800_launches,
                                    windowed_errors)
    step_ms = {"native_fp32": phase_detector_train_step_profile(device, train_set)}
    for dtype in ("bfloat16", "float32"):
        label = f"train800_{dtype}"
        step_ms[label] = phase_detector_train_step_profile(
            device, train_set, recipe=train800_recipe(dtype), batch=TRAIN800_BATCH, label=label)
    log("detector_train_steps", step_ms=json.dumps(step_ms))
    # the perception drivers, after the kernels' timing windows (host-heavy:
    # rendering, decoding), their launches added to the kernels line's
    perception_launches = phase_perception_experiments(device)
    rows = {row["name"]: row for row in kernels}
    row_of = {"K1": "opnet_fused_forward", "K8": "roi_align_batched_backward",
              "K8_bf16": "roi_align_batched_backward (bf16)", "K7": ROI_KERNELS["K7"][0],
              **{tag: name for tag, (name, _) in {**LSTM_KERNELS, **WINDOWED_KERNELS}.items()}}
    for tag, launched in perception_launches.items():
        rows[row_of[tag]]["launches"] += launched
    # the programmed models and SiamRPN, after the kernels' timing windows
    phase_siam_vs_plain(device)
    phase_trackers_path(device)
    phase_siam_train_path(device)
    phase_siam_step_profile(device, smi)
    print(smi, flush=True)  # again, so that the output's end names the card and its limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
