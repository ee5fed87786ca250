"""Rank functions of the port's multi-process tests, and the launcher that
runs them (`spawn`): each rank is a process on the CPU in a gloo process
group, started from a file in the test's tmp directory (no TCP port), with
torch on one thread. The functions import only torch, numpy and the port,
so that a spawned child loads neither JAX nor the tests' conftest.

The inputs are made here from numpy seeds (`step_batches`, `fsdp_batch`),
so the test process and the ranks build the same ones.
"""

import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NARROW = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 16,
          "videos_hidden_dim": 24}
# the models held under DDP, each at a narrow width
MODELS = {"opnet": NARROW, "opnet_no_labels": NARROW, "opnet_att_ce": NARROW,
          "opnet_moe": {**NARROW, "num_experts": 4, "expert_hidden": 8}}
BATCH, FRAMES = 8, 20
# real rows of the three steps' global batches: full, then ragged twice; at
# world 2 the last puts every zero-weight row of rank 1's slice
STEP_REALS = (8, 5, 3)
LR = 1e-3
FSDP_CFG = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 64,
            "videos_hidden_dim": 128}
FSDP_FRAMES = 12


def step_batches():
    """(boxes, labels, mask, tracks, weights, real) of each step: a ragged
    batch repeats its last real row into the padding, which carries weight 0,
    as the loops gather it."""
    out = []
    for step, real in enumerate(STEP_REALS):
        rng = np.random.RandomState(10 + step)
        rows = np.concatenate([np.arange(real), np.full(BATCH - real, real - 1)])
        boxes = rng.rand(BATCH, FRAMES, 15, 6).astype(np.float32)[rows]
        labels = rng.rand(BATCH, FRAMES, 4).astype(np.float32)[rows]
        mask = (rng.rand(BATCH, FRAMES, 4) > 0.5)[rows]
        tracks = rng.randint(0, 15, (BATCH, FRAMES)).astype(np.int32)[rows]
        weights = (np.arange(BATCH) < real).astype(np.float32)
        out.append((boxes, labels, mask, tracks, weights, real))
    return out


def fsdp_batch(seed):
    rng = np.random.RandomState(seed)
    boxes = rng.rand(BATCH, FSDP_FRAMES, 15, 6).astype(np.float32)
    labels = rng.rand(BATCH, FSDP_FRAMES, 4).astype(np.float32)
    mask = (rng.rand(BATCH, FSDP_FRAMES, 4) > 0.3).astype(np.float32)
    return boxes, labels, mask


def _rank_main(rank, fn, world, rendezvous, args):
    torch.set_num_threads(1)  # the policy of `torch_lane.py`, which a rank does not import
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", rank=rank,
                            world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def start(fn, world, tmp_path, *args, timeout=300):
    """Start `fn(rank, *args)` in `world` processes and return `wait()`,
    which fails the test (and kills the ranks) if one raises or they are
    not done within `timeout` seconds of the start. The caller may work in
    between (the JAX side of a comparison)."""
    rendezvous = Path(tmp_path) / f"rendezvous_{fn.__name__}"
    context = mp.start_processes(_rank_main, args=(fn, world, str(rendezvous), args),
                                 nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def wait():
        try:
            while not context.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{fn.__name__} at world {world} took over {timeout} s")
        finally:
            for process in context.processes:
                if process.is_alive():
                    process.kill()

    return wait


def spawn(fn, world, tmp_path, *args, timeout=300):
    """Run `fn(rank, *args)` in `world` processes to their end (`start`)."""
    start(fn, world, tmp_path, *args, timeout=timeout)()


def _t(a):
    return torch.from_numpy(np.array(a))


def run_steps(spec, model, mesh=None):
    """The three steps of `step_batches` (each rank its slice under `mesh`)
    -> (metrics per step, gradients per step)."""
    from objectpermanence_tpu_torch.parallel.data_parallel import DataParallel, layers_entry
    from objectpermanence_tpu_torch.parallel.mesh import batch_sharding
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step

    optimizer = make_optimizer(model.parameters(), LR)
    step = make_train_step(spec, optimizer, mesh=mesh)
    stepped = model if mesh is None else DataParallel(model, mesh, layers_entry)
    rows = slice(None) if mesh is None else batch_sharding(mesh, BATCH)
    metrics, grads = [], []
    for boxes, labels, mask, tracks, weights, real in step_batches():
        got = step(stepped, _t(boxes[rows]), _t(labels[rows]), _t(mask[rows]),
                   _t(weights[rows]), _t(tracks[rows]), weight_total=real)
        metrics.append({k: float(v) for k, v in got.items()})
        grads.append({n: p.grad.detach().clone().numpy() for n, p in model.named_parameters()})
    return metrics, grads


def save_run(path, model, metrics, grads):
    arrays = {f"param/{n}": p.detach().numpy() for n, p in model.state_dict().items()}
    for s, step_grads in enumerate(grads):
        arrays.update({f"grad{s}/{n}": g for n, g in step_grads.items()})
    np.savez(path, **arrays)
    Path(path).with_suffix(".json").write_text(json.dumps(metrics))


def opnet_dp(rank, out_dir, names, train_paths, dev_paths):
    """Per model name, the three steps under DDP from the weights the test
    wrote (`<out_dir>/<name>_init.npz`); then `training_main` of OPNet under
    the mesh on the fixture splits, each rank writing its history."""
    import dataclasses

    from objectpermanence_tpu_torch.data.ingest import ingest_directory
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.parallel.mesh import make_mesh
    from objectpermanence_tpu_torch.train.loop import training_main
    from objectpermanence_tpu_torch.utils.checkpoint import load_params

    out_dir = Path(out_dir)
    mesh = make_mesh()
    for name in names:
        spec = get_model_spec(name, MODELS[name])
        model = spec.build(MODELS[name], torch.Generator().manual_seed(0))
        model.load_state_dict(load_params(out_dir / f"{name}_init.npz"))
        metrics, grads = run_steps(spec, model, mesh)
        if rank == 0:
            save_run(out_dir / f"{name}_world2.npz", model, metrics, grads)

    init = load_params(out_dir / "training_init.npz")

    def build(config, generator):
        model = get_model_spec("opnet").build(config, generator)
        model.load_state_dict(init)
        return model

    spec = dataclasses.replace(get_model_spec("opnet"), build=build)
    (train_pred, train_labels, train_cont), (dev_pred, dev_labels, dev_cont) = train_paths, dev_paths
    train = ingest_directory(train_pred, train_labels, 6, train_cont)
    dev = ingest_directory(dev_pred, dev_labels, 6, dev_cont)
    config = json.loads((out_dir / "training.json").read_text())
    result = training_main(spec, train, dev, config, NARROW, mesh=mesh, device="cpu")
    (out_dir / f"history_rank{rank}.json").write_text(json.dumps(result.history))
    if rank == 0:
        np.savez(out_dir / "training_world2.npz",
                 **{n: p.detach().numpy() for n, p in result.model.state_dict().items()})


def dp_suite(rank, out_dir, names, train_paths, dev_paths):
    opnet_dp(rank, out_dir, names, train_paths, dev_paths)
    fsdp_steps(rank, out_dir)


def fsdp_steps(rank, out_dir):
    """FSDP2 over the data dim: where each parameter lies (this rank's
    shapes), then two steps from `<out_dir>/fsdp_init.npz` on the batches
    of seeds 3 and 4; rank 0 writes the whole parameters after them."""
    from torch.distributed.tensor import DTensor

    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.parallel.fsdp import (
        fsdp_param_shardings, make_fsdp_train_step, param_groups, shard_model,
    )
    from objectpermanence_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from objectpermanence_tpu_torch.train.loop import make_optimizer
    from objectpermanence_tpu_torch.utils.checkpoint import load_params

    out_dir = Path(out_dir)
    mesh = make_mesh()
    spec = get_model_spec("opnet")
    model = spec.build(FSDP_CFG, torch.Generator().manual_seed(0))
    model.load_state_dict(load_params(out_dir / "fsdp_init.npz"))
    shardings = fsdp_param_shardings(model, mesh)
    sharded = shard_model(model, mesh)
    local = {n: list(p.to_local().shape) if isinstance(p, DTensor) else None
             for n, p in model.named_parameters()}
    optimizer = make_optimizer(param_groups(sharded), LR)
    step = make_fsdp_train_step(spec, optimizer, mesh)
    rows = batch_sharding(mesh, BATCH)
    losses = []
    for seed in (3, 4):
        boxes, labels, mask = fsdp_batch(seed)
        metrics = step(sharded, _t(boxes[rows]), _t(labels[rows]), _t(mask[rows]))
        losses.append(float(metrics["loss"]))
    full = {n: (p.full_tensor() if isinstance(p, DTensor) else p).detach().numpy()
            for n, p in model.named_parameters()}
    placed = {n: isinstance(p, DTensor) for n, p in model.named_parameters()}
    (out_dir / f"fsdp_rank{rank}.json").write_text(json.dumps(
        {"shardings": shardings, "local": local, "placed": placed, "losses": losses}))
    if rank == 0:
        np.savez(out_dir / "fsdp_world2.npz", **full)


# the detector: JAX's TINY config of tests/test_detector_dp.py (GroupNorm),
# and its frozen-BN twin, whose batch-norm tensors are trained buffers
DET_TINY = dict(image_hw=(64, 96), min_size=64, max_size=96, backbone_layers=(1, 1, 1, 1),
                backbone_width=8, fpn_channels=16, rpn_pre_nms_top_n=50, rpn_post_nms_top_n=30,
                detections_per_img=10, backbone_norm="group")
DET_NORMS = ("group", "frozen")
DET_BATCH, DET_LR, DET_MOMENTUM, DET_DECAY, DET_WARMUP = 4, 5e-3, 0.9, 5e-4, 2
DET_LOOP = dict(learning_rate=1e-3, warmup_iters=2, print_step=100, seed=0, device="cpu")


def detector_step_batch():
    """A batch of TINY frames with one ground-truth box each."""
    rng = np.random.RandomState(0)
    images = (rng.rand(DET_BATCH, 64, 96, 3) * 255).astype(np.float32)
    gt_boxes = np.zeros((DET_BATCH, 4, 4), np.float32)
    gt_labels = np.zeros((DET_BATCH, 4), np.int64)
    gt_valid = np.zeros((DET_BATCH, 4), bool)
    for i in range(DET_BATCH):
        gt_boxes[i, 0] = [10 + 3 * i, 10, 40 + 3 * i, 40]
        gt_labels[i, 0] = 140
        gt_valid[i, 0] = True
    return images, gt_boxes, gt_labels, gt_valid


def detector_steps(norm, out_dir, mesh=None):
    """Two recipe steps (clip 10, decay, momentum, warmup) from
    `<out_dir>/det_<norm>_init.npz` with JAX's draws for the whole batch
    (`det_<norm>_draws.npz`), each rank its rows -> (loss parts per step,
    the state_dict after)."""
    from objectpermanence_tpu_torch.models.detector import anchors as anchor_lib
    from objectpermanence_tpu_torch.models.detector.detector import Detector, DetectorConfig
    from objectpermanence_tpu_torch.models.detector.training import (
        Draws, data_parallel_detector, make_detector_train_step, trainable_tensors,
    )
    from objectpermanence_tpu_torch.parallel.mesh import batch_sharding
    from objectpermanence_tpu_torch.train.detector_loop import warmup_schedule
    from objectpermanence_tpu_torch.utils.checkpoint import load_params

    out_dir = Path(out_dir)
    cfg = DetectorConfig(**dict(DET_TINY, backbone_norm=norm))
    model = Detector(cfg)
    model.load_state_dict(load_params(out_dir / f"det_{norm}_init.npz"))
    anchors = [torch.from_numpy(a) for a in anchor_lib.pyramid_anchors(
        cfg.feature_shapes(), cfg.strides, cfg.anchor_sizes)]
    optimizer = torch.optim.SGD([t for _, t in trainable_tensors(model)], lr=DET_LR,
                                momentum=DET_MOMENTUM, weight_decay=DET_DECAY, dampening=0.0)
    step = make_detector_train_step(cfg, anchors, optimizer, warmup_schedule(DET_LR, DET_WARMUP))
    rows = slice(None) if mesh is None else batch_sharding(mesh, DET_BATCH)
    stepped = model if mesh is None else data_parallel_detector(model, cfg, anchors, mesh)
    batch = [_t(a[rows]) for a in detector_step_batch()]
    with np.load(out_dir / f"det_{norm}_draws.npz") as blob:
        draws = [Draws(*(_t(blob[f"{s}_{k}"][rows]) for k in Draws._fields))
                 for s in range(len(blob.files) // 4)]
    parts = []
    for d in draws:
        got = step(stepped, *batch, draws=d)
        parts.append({k: float(v) for k, v in got.items()})
    return parts, model.state_dict()


def detector_dp(rank, out_dir, images_dir, csv_path):
    """The DP step of each norm (its loss parts the mean of the ranks'), the
    DP loop (`train_detector(mesh=...)`, 1 epoch at batch 5, rounded to 6)
    and its resume (1 epoch, then `resume=True` to 2)."""
    from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
    from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
    from objectpermanence_tpu_torch.parallel.mesh import make_mesh
    from objectpermanence_tpu_torch.train.detector_loop import train_detector

    out_dir = Path(out_dir)
    mesh = make_mesh()
    for norm in DET_NORMS:
        parts, state = detector_steps(norm, out_dir, mesh)
        local = torch.tensor([[p[k] for k in sorted(p)] for p in parts])
        dist.all_reduce(local)
        (out_dir / f"det_{norm}_rank{rank}.json").write_text(json.dumps(
            {"parts": [dict(zip(sorted(parts[0]), row)) for row in (local / 2).tolist()]}))
        if rank == 0:
            np.savez(out_dir / f"det_{norm}_world2.npz", **{k: v.numpy() for k, v in state.items()})

    dataset = DetectionDataset(images_dir, csv_path)
    cfg = DetectorConfig(**DET_TINY)
    loop = train_detector(dataset, None, cfg, num_epochs=1, batch_size=5,
                          checkpoint_dir=str(out_dir / "loop"), mesh=mesh, **DET_LOOP)
    first = train_detector(dataset, None, cfg, num_epochs=1, batch_size=5,
                           checkpoint_dir=str(out_dir / "resume"), mesh=mesh, **DET_LOOP)
    second = train_detector(dataset, None, cfg, num_epochs=2, batch_size=5,
                            checkpoint_dir=str(out_dir / "resume"), mesh=mesh, resume=True,
                            **DET_LOOP)
    record = {name: [{k: v for k, v in h.items()} for h in run["history"]]
              for name, run in (("loop", loop), ("first", first), ("second", second))}
    (out_dir / f"det_loop_rank{rank}.json").write_text(json.dumps(record))
    for name, run in (("loop", loop), ("first", first), ("second", second)):
        np.savez(out_dir / f"det_{name}_rank{rank}.npz",
                 **{k: v.detach().numpy() for k, v in run["params"].items()})


def detector_mesh_run(rank, out_dir, train_paths, dev_paths, config):
    """`train_detector(mesh=make_mesh())` for one epoch with evaluation,
    each rank writing its history and final params."""
    from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
    from objectpermanence_tpu_torch.models.detector.detector import DetectorConfig
    from objectpermanence_tpu_torch.parallel.mesh import make_mesh
    from objectpermanence_tpu_torch.train.detector_loop import train_detector

    out_dir = Path(out_dir)
    result = train_detector(DetectionDataset(*train_paths), DetectionDataset(*dev_paths),
                            DetectorConfig(**config), num_epochs=1, batch_size=3,
                            learning_rate=1e-2, warmup_iters=2, print_step=2, seed=1,
                            device="cpu", checkpoint_dir=str(out_dir / "ckpt"), mesh=make_mesh())
    (out_dir / f"history_rank{rank}.json").write_text(json.dumps(result["history"]))
    np.savez(out_dir / f"final_rank{rank}.npz",
             **{k: v.detach().numpy() for k, v in result["params"].items()})


# ---------------------------------------------------------------------------
# the model-parallel meshes (tensor, sequence, pipeline, expert parallel), at
# world 4 on (data 2 x model/pipe/expert 2) or (data 1 x pipe 4)

MP_BATCH, MP_FRAMES, MP_STEPS = 8, 12, 2
TRANSFORMER = {"boxes_features_dim": 16, "num_attention_heads": 2, "num_attention_layers": 1,
               "num_lstm_layers": 2, "lstm_hidden_dim": 24}
MOE_IN, MOE_OUT, MOE_EXPERTS, MOE_HIDDEN = 24, 4, 4, 8
GENERIC_WIDTHS = {2: [6, 24, 4], 4: [6, 24, 16, 12, 4]}    # in, hidden..., out per pipe width


def mp_batch(seed, batch=MP_BATCH, frames=MP_FRAMES, feat=6):
    """(boxes, labels, mask) of one step or forward."""
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, frames, 15, feat).astype(np.float32),
            rng.rand(batch, frames, 4).astype(np.float32),
            rng.rand(batch, frames, 4) > 0.5)


def _load_npz(path):
    with np.load(path) as blob:
        return {k: torch.from_numpy(blob[k]) for k in blob.files}


def _opnet(path):
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    spec = get_model_spec("opnet")
    model = spec.build(NARROW, torch.Generator().manual_seed(0))
    model.load_state_dict(_load_npz(path))
    return spec, model


def tp_steps(rank, out_dir):
    """Tensor parallel on (data 2, model 2): each rank's shards of the
    weights from `<out_dir>/tp_init.npz`, then MP_STEPS Adam steps of OPNet
    (`make_train_step` with the mesh) on the batches of seeds 20, 21; each
    rank writes its shards before and after, its gradients' shards and the
    losses."""
    from objectpermanence_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from objectpermanence_tpu_torch.parallel.sharding import local_shards, shard_params
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step

    out_dir = Path(out_dir)
    spec, model = _opnet(out_dir / "tp_init.npz")
    mesh = make_mesh(n_data=2, n_model=2)
    tp = shard_params(model, mesh, strict=True)
    arrays = {f"init/{k}": v.numpy().copy() for k, v in local_shards(tp).items()}
    optimizer = make_optimizer(tp.parameters(), LR)
    step = make_train_step(spec, optimizer, mesh=mesh)
    rows = batch_sharding(mesh, MP_BATCH)
    losses = []
    for s in range(MP_STEPS):
        boxes, labels, mask = mp_batch(20 + s)
        metrics = step(tp, _t(boxes[rows]), _t(labels[rows]), _t(mask[rows]))
        losses.append(float(metrics["loss"]))
        arrays.update({f"grad{s}/{n}": p.grad.to_local().numpy().copy()
                       for n, p in tp.named_parameters()})
    arrays.update({f"param/{k}": v.numpy() for k, v in local_shards(tp).items()})
    np.savez(out_dir / f"tp_rank{rank}.npz", **arrays)
    (out_dir / f"tp_rank{rank}.json").write_text(json.dumps(losses))


def generic_stage(params, boxes, gate):
    """A per-frame stage of several inputs and outputs of mixed ranks."""
    feats = torch.einsum("bfod,dh->bfoh", boxes, params["w"]) + params["b"]
    pooled = torch.einsum("bfoh,bfo->bfh", torch.relu(feats), torch.softmax(gate, dim=-1))
    return pooled, pooled.sum(-1)


def sp_suite(rank, out_dir):
    """Sequence parallel on (data 2, model 2): the IoU, OPNet's and the
    transformer's forwards and a generic frame-sharded stage on the inputs
    of `<out_dir>/sp_inputs.npz`, each rank writing the global results it
    returned; then whether frames or a batch that do not divide raise."""
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.parallel.mesh import make_mesh
    from objectpermanence_tpu_torch.parallel.sequence import (
        frame_sharded, make_sequence_parallel_iou, make_sequence_parallel_opnet_forward,
        make_sequence_parallel_transformer_forward,
    )

    out_dir = Path(out_dir)
    x = _load_npz(out_dir / "sp_inputs.npz")
    mesh = make_mesh(n_data=2, n_model=2)
    _, opnet = _opnet(out_dir / "sp_opnet.npz")
    transformer = get_model_spec("transformer_lstm").build(TRANSFORMER)
    transformer.load_state_dict(_load_npz(out_dir / "sp_transformer.npz"))
    out = {}
    out["iou_mean"], out["iou_msum"], out["iou_mcnt"] = make_sequence_parallel_iou(mesh)(
        x["pred"], x["labels"], x["mask"])
    opnet_fwd = make_sequence_parallel_opnet_forward(mesh)
    out["opnet_y"], out["opnet_logits"] = opnet_fwd(opnet, x["boxes"])
    out["transformer_y"] = make_sequence_parallel_transformer_forward(mesh)(
        transformer, x["boxes5"])
    out["pooled"], out["pooled_sum"] = frame_sharded(mesh, generic_stage)(
        {"w": x["w"], "b": x["b"]}, x["boxes"], x["gate"])
    raised = {}
    for what, boxes in (("frames", x["boxes"][:, :MP_FRAMES - 1]), ("batch", x["boxes"][:3])):
        try:
            opnet_fwd(opnet, boxes)
            raised[what] = None
        except ValueError as exc:
            raised[what] = str(exc)
    np.savez(out_dir / f"sp_rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
    (out_dir / f"sp_rank{rank}.json").write_text(json.dumps(raised))


def generic_stage_fns(widths):
    def stage(i):
        def fn(local, transit, x_mb):
            src = x_mb if i == 0 else transit[..., :widths[i]]
            return torch.tanh(src @ local["w"][:widths[i], :widths[i + 1]])
        return fn
    return [stage(i) for i in range(len(widths) - 1)]


def pp_suite(rank, out_dir, n_pipe):
    """Pipeline parallel on (data 4/n_pipe, pipe n_pipe): OPNet's forward
    and one train step (Adam) from `<out_dir>/pp_init.npz` on the batch of
    seed 30, then the generic engine on a tanh MLP of `GENERIC_WIDTHS`
    (forward, and one step's gradients of mean(y^2)); each rank writes its
    stage's state_dict, gradients and results."""
    from objectpermanence_tpu_torch.parallel.mesh import make_pipe_mesh
    from objectpermanence_tpu_torch.parallel.pipeline import (
        make_gpipe_forward, make_gpipe_train_step, make_pipelined_opnet_forward,
        make_pipelined_opnet_train_step, stack_stage_param_list, stack_stage_params,
    )

    out_dir = Path(out_dir)
    _, model = _opnet(out_dir / "pp_init.npz")
    mesh = make_pipe_mesh(n_data=4 // n_pipe, n_pipe=n_pipe)
    local = stack_stage_params(model, mesh, num_stages=n_pipe)
    boxes, labels, mask = (_t(a) for a in mp_batch(30))
    arrays = {"y": make_pipelined_opnet_forward(mesh, NARROW, num_microbatches=2,
                                                num_stages=n_pipe)(local, boxes).numpy()}
    optimizer = torch.optim.Adam(local.parameters(), lr=LR)
    step = make_pipelined_opnet_train_step(mesh, NARROW, optimizer, num_microbatches=2,
                                           num_stages=n_pipe)
    metrics = step(local, boxes, labels, mask)
    arrays.update({f"grad/{n}": p.grad.numpy() for n, p in local.named_parameters()})
    arrays.update({f"param/{n}": p.detach().numpy() for n, p in local.named_parameters()})

    widths = GENERIC_WIDTHS[n_pipe]
    with np.load(out_dir / "pp_generic.npz") as blob:
        ws = [blob[f"w{i}"] for i in range(n_pipe)]
        x = torch.from_numpy(blob["x"])
    fns = generic_stage_fns(widths)
    stage = stack_stage_param_list([{"w": w} for w in ws], mesh)
    arrays["generic_y"] = make_gpipe_forward(mesh, fns, transit_dim=max(widths),
                                             out_dim=widths[-1], num_microbatches=2)(
        stage, x).numpy()
    generic_step = make_gpipe_train_step(
        mesh, fns, torch.optim.SGD(stage.parameters(), lr=0.0), transit_dim=max(widths),
        out_dim=widths[-1], num_microbatches=2,
        loss_fn=lambda y, labels, mask: ((y ** 2).mean(), {"loss": (y ** 2).mean()}))
    generic_step(stage, x, x, x)
    arrays["generic_grad"] = stage.w.grad.numpy()
    np.savez(out_dir / f"pp{n_pipe}_rank{rank}.npz", **arrays)
    (out_dir / f"pp{n_pipe}_rank{rank}.json").write_text(
        json.dumps({k: float(v) for k, v in metrics.items()}))


def ep_suite(rank, out_dir):
    """Expert parallel on (data 2, expert 2): the MoE head of
    `<out_dir>/ep_head.npz` on this rank's rows of `ep_inputs.npz`, its
    output and the gradients of mean(y^2) (averaged over data), then the
    generic layer with a gated expert; each rank writes its results and
    the shapes it holds."""
    from objectpermanence_tpu_torch.models.moe import MoEHead
    from objectpermanence_tpu_torch.parallel.expert import (
        make_expert_parallel_layer, make_expert_parallel_moe_head, shard_expert_params,
    )
    from objectpermanence_tpu_torch.parallel.mesh import (
        EXPERT_AXIS, axis_slice, batch_sharding, data_group, make_expert_mesh,
    )

    out_dir = Path(out_dir)
    x = _load_npz(out_dir / "ep_inputs.npz")
    head = MoEHead(MOE_IN, MOE_OUT, MOE_EXPERTS, MOE_HIDDEN)
    head.load_state_dict(_load_npz(out_dir / "ep_head.npz"))
    mesh = make_expert_mesh(n_data=2, n_expert=2)
    rows = batch_sharding(mesh, x["h"].shape[0])
    sharded = shard_expert_params(head, mesh)
    y = make_expert_parallel_moe_head(mesh)(sharded, x["h"][rows])
    (y ** 2).mean().backward()
    arrays = {"y": y.detach().numpy()}
    for name, param in sharded.items():
        grad = param.grad.to_local()
        dist.all_reduce(grad, group=data_group(mesh))
        arrays[f"grad/{name}"] = (grad / 2).numpy()
        arrays[f"held/{name}"] = np.array(param.to_local().shape)
    mine = axis_slice(mesh, EXPERT_AXIS, MOE_EXPERTS)

    def expert_fn(ep, h):
        return (torch.sigmoid(h @ ep["wg"]) * (h @ ep["wu"])) @ ep["wo"]

    layer = make_expert_parallel_layer(mesh, expert_fn)
    arrays["custom_y"] = layer({"router": x["router"],
                                "experts": {k: x[k][mine] for k in ("wg", "wu", "wo")}},
                               x["gh"][rows]).numpy()
    np.savez(out_dir / f"ep_rank{rank}.npz", **arrays)
