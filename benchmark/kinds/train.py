"""The `train` kind: train steps through the port's
`train/loop.py::make_train_step` with Adam, each batch gathered on the
device by `DeviceDataset.batch` from indices drawn by the seed.

Set-up builds the one model, optimizer and step that the window runs, and
drives them through their first three steps on batches whose rows all
differ; it keeps each step's loss, the first gradient as Adam holds it
after one step (its first moment over 1 - beta1) and the change of every
weight after the three. Dropout, where the model has it, draws from a
generator on the card seeded from the run's seed. No eval and no
checkpoint runs in the window.

Mix keys: `videos` (a batch) and `frames`; `learning_rate`; `checked_steps`,
the first steps the reference follows; `schedule`, the batches of indices
drawn ahead, which the window cycles over; `trace_calls`, steps in the
profiled stretch.
"""

import statistics
from contextlib import nullcontext
from time import perf_counter

import numpy as np
import torch

from benchmark import stats
from benchmark.kinds import Window
from benchmark.models import make_weights, port_model
from benchmark.reference.common import Adam, l1_loss

BETA1 = 0.9
# A leaf moves by round-off alone (as a key's bias under softmax) where its
# first gradient in the reference is under SMALL_LEAF of the median leaf's
# norm and lies farther than ROUNDOFF of its norm from the same gradient
# worked out in float64: a small gradient that float32 computes to a few
# digits is real, and Adam moves its leaf by it.
SMALL_LEAF = 1e-3
ROUNDOFF = 0.1


def _device_dataset(ctx):
    from objectpermanence_tpu_torch.data.ingest import IngestedDataset
    from objectpermanence_tpu_torch.train.loop import DeviceDataset

    frames, feats = ctx.mix["frames"], ctx.adapter.FEATURES
    boxes = np.ascontiguousarray(ctx.cache["boxes"][:, :frames, :, :feats])
    labels = np.ascontiguousarray(ctx.cache["labels"][:, :frames])
    tracks = np.ascontiguousarray(ctx.cache["index_to_track"][:, :frames])
    names = [f"video_{i:02d}" for i in range(len(boxes))]
    return DeviceDataset(IngestedDataset(names, boxes, tracks, labels), ctx.device), boxes, labels


def _schedule(ctx, count):
    """Index batches: the first `checked_steps` with no row twice, then
    epochs of seeded permutations cut into batches."""
    rng = np.random.default_rng(stats.subseed(ctx.seed, "batches"))
    batch, steps = ctx.mix["videos"], ctx.mix["checked_steps"]
    first = rng.permutation(count)[:batch * steps].reshape(steps, batch)
    rest = []
    while len(rest) < ctx.mix["schedule"]:
        order = rng.permutation(count)
        rest += [order[i:i + batch] for i in range(0, count - batch + 1, batch)]
    return list(first), rest[:ctx.mix["schedule"]]


def setup(ctx):
    from objectpermanence_tpu_torch.train.loop import make_optimizer, make_train_step

    device, mix = ctx.device, ctx.mix
    data, boxes, labels = _device_dataset(ctx)
    first, rest = _schedule(ctx, data.count)
    weights = make_weights(ctx.adapter.leaves(ctx.config), stats.subseed(ctx.seed, "weights"),
                           device)
    spec, model = port_model(ctx.adapter.PORT_NAME, ctx.config, weights, device, train=True)
    optimizer = make_optimizer(model.parameters(), mix["learning_rate"])
    generator = torch.Generator(device).manual_seed(stats.subseed(ctx.seed, "dropout"))
    step = make_train_step(spec, optimizer, generator)
    ctx.log("dataset staged, weights made, model built")
    state = {"data": data, "boxes": boxes, "labels": labels, "first": first, "rest": rest,
             "weights": weights, "model": model, "optimizer": optimizer, "step": step}
    losses = []
    for s, indices in enumerate(first):
        losses.append(_call(state, indices)["loss"])
        if s == 0:  # a leaf Adam holds no state of has had no gradient
            state["grad"] = {name: optimizer.state[p]["exp_avg"] / (1 - BETA1)
                             if "exp_avg" in optimizer.state.get(p, {}) else torch.zeros_like(p)
                             for name, p in model.named_parameters()}
    state["losses"] = [float(x) for x in losses]
    ctx.log(f"{len(first)} first steps")
    state["change"] = {name: (p.detach() - weights[name]) for name, p in model.named_parameters()}
    return state


def _call(state, indices):
    boxes, labels, mask, _ = state["data"].batch(indices)
    return state["step"](state["model"], boxes, labels, mask)


def _steps(state, span, stop):
    rest, losses, call_s = state["rest"], [], []
    i = 0
    while not stop(i):
        t = perf_counter()
        with span("bench.train.step"):
            losses.append(_call(state, rest[i % len(rest)])["loss"])
        call_s.append(perf_counter() - t)
        i += 1
    with span("bench.sync"):
        _sync(state["model"])
    return i, losses, call_s


def _sync(model):
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(ctx, state, seconds, span=lambda name: nullcontext()):
    start = perf_counter()
    deadline = start + seconds
    steps, losses, call_s = _steps(state, span, lambda i: perf_counter() >= deadline)
    elapsed = perf_counter() - start
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    return Window(attempted=steps, frames=steps * ctx.mix["videos"] * ctx.mix["frames"],
                  seconds=elapsed, host_call_s=call_s, failed=failed)


def stretch(ctx, state, span):
    calls = ctx.mix["trace_calls"]
    _steps(state, span, lambda i: i >= calls)
    return calls


def expected_launches(ctx, state, attempted):
    """K2 and K3 once per LSTM layer a step, and no K1 or K4."""
    layers = len(ctx.adapter.lstm_widths(ctx.config))
    return {"K2": attempted * layers, "K3": attempted * layers, "K1": 0, "K4": 0}


def release(state):
    for key in ("model", "optimizer", "step", "data"):
        state.pop(key, None)


def reference_run(ctx, state, precision="fp32", rows=None, dtype=torch.float32, steps=None):
    """The reference's first `checked_steps` steps (or `steps`) from the
    same weights on the same batches, in `dtype`, with dropout from a
    generator seeded as the program's: -> (losses, first gradient by leaf,
    change by leaf after the steps). `rows` keeps that many rows of each
    batch (a planted fault)."""
    device = ctx.device
    params = {k: w.to(dtype, copy=True).requires_grad_(True)
              for k, w in state["weights"].items()}
    adam = Adam(params, lr=ctx.mix["learning_rate"])
    generator = torch.Generator(device).manual_seed(stats.subseed(ctx.seed, "dropout"))
    losses, first = [], None
    for indices in state["first"][:steps]:
        indices = indices[:rows]
        boxes = torch.from_numpy(state["boxes"][indices]).to(device, dtype)
        labels = torch.from_numpy(state["labels"][indices]).to(device, dtype)
        y = ctx.reference.forward(params, boxes, ctx.config, precision, generator, train=True)
        loss = l1_loss(y, labels)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        losses.append(float(loss.detach()))
        if first is None:
            first = grads
        adam.step(grads)
    change = {k: (p.detach() - state["weights"][k]) for k, p in params.items()}
    return losses, first, change


def roundoff_leaves(ctx, state, grad):
    """The leaves of the reference's first gradient `grad` that move by
    round-off alone (see SMALL_LEAF): the float64 run is made only where a
    leaf is that small."""
    norms = {k: float(g.norm()) for k, g in grad.items()}
    median = statistics.median(norms.values())
    small = [k for k, n in norms.items() if n < SMALL_LEAF * median]
    if not small:
        return []
    exact = reference_run(ctx, state, dtype=torch.float64, steps=1)[1]
    return [k for k in small
            if float((grad[k].double() - exact[k]).norm()) > ROUNDOFF * float(exact[k].norm())]


def _gaps(ours, truth, keys):
    """Worst leaf: |norm(ours) - norm(truth)| over the larger of the truth's
    norm of that leaf and the median leaf's."""
    norms = {k: float(truth[k].norm()) for k in keys}
    median = statistics.median(norms.values())
    return max(abs(float(ours[k].norm()) - norms[k]) / max(norms[k], median) for k in keys)


def numbers(ctx, state, precision="fp32", rows=None):
    """`loss_gap`, the widest relative gap of the checked steps' losses;
    `grad_gap` and `change_gap`, the worst leaf's gap of norms of the first
    gradient and of the change after the checked steps. With `precision`
    other than "fp32" or with `rows`, the reference run so stands in for
    the program (the control, a fault)."""
    cache = state.setdefault("reference", {})
    if "fp32" not in cache:
        cache["fp32"] = reference_run(ctx, state)
    losses, grad, change = cache["fp32"]
    if precision == "fp32" and rows is None:
        ours = state["losses"], state["grad"], state["change"]
    else:
        ours = reference_run(ctx, state, precision, rows)
    if "left_out" not in cache:
        cache["left_out"] = roundoff_leaves(ctx, state, grad)
    moving = [k for k in grad if k not in cache["left_out"]]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(ours[0], losses)),
            "grad_gap": _gaps(ours[1], grad, list(grad)),
            "change_gap": _gaps(ours[2], change, moving),
            "left_out": sorted(set(grad) - set(moving))}
