"""The multi-device dry run, the counterpart of
`__graft_entry__.py::dryrun_multichip`: one run through every strategy of
`parallel/` at OPNet's flagship width, with JAX's assertions.

    python -m objectpermanence_tpu_torch.parallel.dryrun N [--device cpu]
    torchrun --nproc_per_node N -m objectpermanence_tpu_torch.parallel.dryrun N

On N ranks (one per card over NCCL, or gloo ranks on the CPU with
`--device cpu`, in place of JAX's virtual CPU devices) it runs:
- one dp+tp train step of OPNet (256/512) on a (data, model) mesh, `model`
  2 where N is even, under `strict` sharding, and checks that the weights
  and Adam's moments keep their tensor-parallel shards through the update;
- the sequence-parallel IoU against itself (1.0) and the sequence-parallel
  OPNet forward against the single-device forward;
- where N is even, the pipelined forward against the single-device forward
  and one pipelined train step, in 4 stages where N divides by 4, else 2,
  each rank holding only its stage; and the expert-parallel MoE head's
  forward against the dense head and its gradient, the experts sharded;
- one FSDP2 step, with the shardings `fsdp_param_shardings` prescribes kept;
and prints JAX's closing line, `dryrun_multichip(N): mesh=... loss=...
dp+tp+sp(...)...+fsdp ok`.

The device is explicit: `device="cuda"` (the default) needs N cards and
raises without them; it never becomes a run on the CPU.
"""

import argparse
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Replicate, Shard

from objectpermanence_tpu_torch import resolve_device

OPNET_CONFIG = {"object_to_track_pred_dim": 15, "object_to_track_hidden_dim": 256,
                "videos_hidden_dim": 512}
FRAMES = 16
RTOL, ATOL = 2e-5, 2e-6          # JAX's parity limits for the sharded forwards
SPAWN_TIMEOUT = 1800


def _close(got, want, what):
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        diff = float((got - want).abs().max())
        raise AssertionError(f"{what} parity failed: max |diff| {diff}")


def _dryrun_impl(n_devices: int, device: torch.device) -> str:
    """The dry run on this rank of an initialized process group of
    `n_devices` ranks; returns the closing line."""
    from objectpermanence_tpu_torch.models.moe import MoEHead
    from objectpermanence_tpu_torch.models.registry import get_model_spec
    from objectpermanence_tpu_torch.parallel.expert import (
        make_expert_parallel_moe_head, shard_expert_params,
    )
    from objectpermanence_tpu_torch.parallel.fsdp import (
        fsdp_param_shardings, make_fsdp_train_step, param_groups, shard_model,
    )
    from objectpermanence_tpu_torch.parallel.mesh import (
        MODEL_AXIS, PIPE_AXIS, axis_rank, axis_width, batch_sharding, data_width,
        make_expert_mesh, make_mesh, make_pipe_mesh,
    )
    from objectpermanence_tpu_torch.parallel.pipeline import (
        make_pipelined_opnet_forward, make_pipelined_opnet_train_step, opnet_stage_shapes,
        stack_stage_params,
    )
    from objectpermanence_tpu_torch.parallel.sequence import (
        make_sequence_parallel_iou, make_sequence_parallel_opnet_forward,
    )
    from objectpermanence_tpu_torch.parallel.sharding import (
        full_params, shard_params, tp_param_shardings,
    )
    from objectpermanence_tpu_torch.train.loop import _fp32_products, make_optimizer, make_train_step

    _fp32_products(device)
    # (data, model): a model dim of 2 where the count allows
    n_model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model)
    spec = get_model_spec("opnet")
    config = OPNET_CONFIG
    # the flagship dims, strict: a config-size regression fails the dry run
    # instead of passing unsharded
    model = spec.build(config, torch.Generator().manual_seed(0)).to(device).train()
    tp_model = shard_params(model, mesh, strict=True)
    optimizer = make_optimizer(tp_model.parameters(), 1e-3)
    train_step = make_train_step(spec, optimizer, mesh=mesh)

    batch = data_width(mesh) * 2
    boxes = torch.from_numpy(np.random.RandomState(0).rand(batch, FRAMES, 15, 6)
                             .astype(np.float32)).to(device)
    labels = torch.from_numpy(np.random.RandomState(1).rand(batch, FRAMES, 4)
                              .astype(np.float32)).to(device)
    mask = torch.zeros(batch, FRAMES, 4, dtype=torch.bool, device=device)
    rows = batch_sharding(mesh, batch)
    metrics = train_step(tp_model, boxes[rows], labels[rows], mask[rows])
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"non-finite loss from multichip dry run: {loss}"

    # the weights and Adam's moments kept their tp shardings through the update
    w_hh = dict(tp_model.named_parameters())["video_lstm.w_hh"]
    dim = tp_param_shardings({"video_lstm.w_hh": w_hh}, mesh)["video_lstm.w_hh"]
    for what, tensor in (("w_hh", w_hh), ("its Adam moment", optimizer.state[w_hh]["exp_avg"])):
        assert isinstance(tensor, DTensor) and tuple(tensor.placements) == (
            Replicate(), Shard(dim)), f"tp sharding lost: {what} {tensor.placements}"
        assert tensor.to_local().shape[dim] == w_hh.shape[dim] // axis_width(mesh, MODEL_AXIS), \
            f"tp shard of {what} is {tuple(tensor.to_local().shape)}"

    # sequence parallelism: the frame-sharded IoU (well-formed boxes, so
    # self-IoU is exactly 1), then OPNet's forward against the plain one
    host = spec.build(config).to(device)
    host.load_state_dict(full_params(tp_model))
    lo = torch.minimum(labels[..., :2], labels[..., 2:])
    hi = torch.maximum(labels[..., :2], labels[..., 2:])
    boxes_ok = torch.cat([lo, hi], dim=-1)
    mean_iou, _, _ = make_sequence_parallel_iou(mesh)(boxes_ok, boxes_ok, mask)
    assert torch.allclose(mean_iou, torch.ones_like(mean_iou)), "sp IoU self-comparison != 1"
    y_sp, logits_sp = make_sequence_parallel_opnet_forward(mesh)(host, boxes)
    with torch.no_grad():
        ref_y, ref_logits = host.forward_layers(boxes)
    _close(y_sp, ref_y, "sp opnet forward")
    _close(logits_sp, ref_logits, "sp opnet logits")

    pp_ok = ""
    if n_devices % 2 == 0:
        n_stages = 4 if n_devices % 4 == 0 else 2
        pmesh = make_pipe_mesh(n_data=n_devices // n_stages, n_pipe=n_stages)
        local = stack_stage_params(host, pmesh, num_stages=n_stages)
        y_pp = make_pipelined_opnet_forward(pmesh, config, num_microbatches=2,
                                            num_stages=n_stages)(local, boxes)
        _close(y_pp, ref_y, "pp forward")
        pp_opt = torch.optim.Adam(local.parameters(), lr=1e-3)
        pp_step = make_pipelined_opnet_train_step(pmesh, config, pp_opt, num_microbatches=2,
                                                  num_stages=n_stages)
        pp_metrics = pp_step(local, boxes, labels, mask)
        assert np.isfinite(float(pp_metrics["loss"])), "pp train loss non-finite"
        want = opnet_stage_shapes(config, n_stages)[axis_rank(pmesh, PIPE_AXIS)]
        want = {f"{k}.{leaf}": shape for k, sub in want.items() for leaf, shape in sub.items()}
        held = {k: tuple(v.shape) for k, v in local.state_dict().items()}
        assert held == want, f"pp stage sharding lost in train step: {held} != {want}"
        pp_ok = f"+pp(fwd+train,{n_stages}stage)"

    ep_ok = ""
    if n_devices % 2 == 0:
        moe = MoEHead(config["videos_hidden_dim"], 4, num_experts=4, expert_hidden=128,
                      generator=torch.Generator().manual_seed(3)).to(device)
        feats = torch.from_numpy(np.random.RandomState(2).randn(
            batch, FRAMES, config["videos_hidden_dim"]).astype(np.float32)).to(device)
        emesh = make_expert_mesh(n_data=n_devices // 2, n_expert=2)
        rows_e = batch_sharding(emesh, batch)
        with torch.no_grad():
            ref_moe = moe(feats[rows_e])
        sharded = shard_expert_params(moe, emesh)
        ep_head = make_expert_parallel_moe_head(emesh)
        y_ep = ep_head(sharded, feats[rows_e])
        _close(y_ep, ref_moe, "ep head")
        (y_ep ** 2).mean().backward()
        grads = {k: p.grad.to_local() for k, p in sharded.items()}
        assert all(bool(torch.isfinite(g).all()) for g in grads.values()), "ep grads non-finite"
        assert grads["w1"].shape[0] == 2 and grads["w2"].shape[0] == 2, \
            f"ep grad sharding lost: {tuple(grads['w1'].shape)}"
        ep_ok = "+ep(fwd+grad)"

    # FSDP2 over a flat data mesh: the large leaves sharded, Adam's moments
    # with them, kept through the update
    fmesh = make_mesh(n_data=n_devices, n_model=1)
    f_model = spec.build(config, torch.Generator().manual_seed(4)).to(device).train()
    shardings = fsdp_param_shardings(f_model, fmesh)
    f_sharded = shard_model(f_model, fmesh)
    f_opt = make_optimizer(param_groups(f_sharded), 1e-3)
    f_rows = batch_sharding(fmesh, batch)
    f_metrics = make_fsdp_train_step(spec, f_opt, fmesh)(
        f_sharded, boxes[f_rows], labels[f_rows], mask[f_rows].float())
    assert np.isfinite(float(f_metrics["loss"])), "fsdp loss non-finite"
    f_w_hh = dict(f_model.named_parameters())["video_lstm.w_hh"]
    f_dim = shardings["video_lstm.w_hh"]
    kept = (not isinstance(f_w_hh, DTensor) if f_dim is None
            else isinstance(f_w_hh, DTensor) and f_w_hh.placements == (Shard(f_dim),))
    assert kept, f"fsdp sharding lost through update: {getattr(f_w_hh, 'placements', None)}"

    shape = {name: axis_width(mesh, name) for name in mesh.mesh_dim_names}
    return (f"dryrun_multichip({n_devices}): mesh={shape} loss={loss:.4f} "
            f"dp+tp+sp(iou+opnet-fwd){pp_ok}{ep_ok}+fsdp ok")


def _rank_main(rank: int, world: int, init_method: str, device_type: str, queue) -> None:
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank, world_size=world,
                                device_id=device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        line = _dryrun_impl(world, device)
        if rank == 0:
            queue.put(line)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device=None) -> str:
    """Run the dry run over `n_devices` ranks and return (and print) its
    closing line. `device` "cuda" (the default) starts one NCCL rank per
    card and raises when fewer than `n_devices` cards are present; "cpu"
    starts `n_devices` gloo ranks on the CPU. Inside an initialized process
    group of `n_devices` ranks (`torchrun`), it runs on this rank."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards, one per rank, but "
            f"{torch.cuda.device_count()} are present: run it on a host with {n_devices} cards, "
            f"or pass device='cpu' for {n_devices} gloo ranks on the CPU")
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a process group of "
                             f"{dist.get_world_size()} ranks")
        line = _dryrun_impl(n_devices, device)
        if dist.get_rank() == 0:
            print(line, flush=True)
        return line
    queue = mp.get_context("spawn").SimpleQueue()
    context = mp.start_processes(
        _rank_main, args=(n_devices, f"tcp://localhost:{_free_port()}", device.type, queue),
        nprocs=n_devices, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        while not context.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"dryrun_multichip({n_devices}) took over {SPAWN_TIMEOUT} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
    line = queue.get()
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    if "WORLD_SIZE" in os.environ:      # one rank of a launcher
        from objectpermanence_tpu_torch.parallel.mesh import init_from_env
        device = init_from_env(args.device)
        try:
            dryrun_multichip(args.n_devices, device)
        finally:
            dist.destroy_process_group()
    else:
        dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
