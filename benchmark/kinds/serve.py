"""The `serve` kind: one client sends batches of videos in a closed loop
with a fixed number in flight, as `bench_torch.py` serves them (its loop
copied here from commit 443ce38), through the port's
`infer/reasoning.py::make_predict_step`, and copies each batch's int16 pixel
boxes to the host. A request's latency runs from its submission, on the
host's clock, to the event recorded after its copy, brought onto the host's
clock (`_Clock`).

Mix keys: `videos` and `frames` a request; `depth`, the batches in flight
beyond the one being waited for; `pool`, the device-resident batches that
requests cycle over, each `videos` draws with replacement from the frozen
ingest cache; `warmup`, calls before the window; `checked`, the requests
drawn from the seed, among those the window finished, whose boxes are
compared with the reference; `trace_calls`, calls in the profiled stretch;
`reference_rows`, videos a reference block runs at once.
"""

from collections import deque
from contextlib import nullcontext
from time import perf_counter as time_now

import numpy as np
import torch

from benchmark import stats
from benchmark.kinds import Window
from benchmark.models import make_weights, port_model
from benchmark.reference.common import to_pixels


def setup(ctx):
    from objectpermanence_tpu_torch.infer.reasoning import make_predict_step

    mix, device = ctx.mix, ctx.device
    cache = torch.from_numpy(ctx.cache["boxes"][:, :mix["frames"], :, :ctx.adapter.FEATURES])
    cache = cache.contiguous().to(device)
    draws = np.random.default_rng(stats.subseed(ctx.seed, "inputs")).integers(
        0, cache.shape[0], size=(mix["pool"], mix["videos"]))
    pool = [cache[torch.as_tensor(row, device=device)].contiguous() for row in draws]
    weights = make_weights(ctx.adapter.leaves(ctx.config), stats.subseed(ctx.seed, "weights"),
                           device)
    spec, model = port_model(ctx.adapter.PORT_NAME, ctx.config, weights, device, train=False)
    predict = make_predict_step(spec, device=device, out_dtype=torch.int16)
    ctx.log("inputs staged, weights made, model built")
    state = {"pool": pool, "weights": weights, "model": model, "predict": predict,
             "rng": np.random.default_rng(stats.subseed(ctx.seed, "checked")),
             "kept": [], "requests": 0}
    for i in range(mix["warmup"]):
        predict(model, pool[i % len(pool)]).cpu()
    ctx.log(f"{mix['warmup']} warm-up calls")
    return state


class _Clock:
    """The card's event times on the host's clock. Two anchors, each an
    event recorded on the idle card beside a reading of the host's clock,
    one before the loop and one after it, and the line through them, which
    also takes out the drift between the two clocks. Off the card a
    completion is read on the host's clock when it is waited for."""

    def __init__(self, device):
        self.device = device
        self.start = self._anchor()
        self.end = None

    def _anchor(self):
        if self.device.type != "cuda":
            return time_now(), None
        torch.cuda.synchronize(self.device)
        event = torch.cuda.Event(enable_timing=True)
        host = time_now()
        event.record()
        event.synchronize()
        return host, event

    def stop(self):
        self.end = self._anchor()

    def host_s(self, done):
        """The host's clock when the event `done` completed; a float is a
        reading of the host's clock already."""
        if not isinstance(done, torch.cuda.Event):
            return done
        (h0, e0), (h1, e1) = self.start, self.end
        return h0 + e0.elapsed_time(done) / e0.elapsed_time(e1) * (h1 - h0)


def _loop(ctx, state, span, stop, record):
    """The closed loop: submit, copy back, and wait for the oldest whenever
    more than `depth` batches are in flight. `stop(i)` ends the submissions;
    every request submitted is waited for. A request completes when the
    copy of its boxes to the host has (an event recorded after the copy),
    and not when the loop comes to wait for it. -> (requests, the clock)."""
    pool, model, predict, depth = state["pool"], state["model"], state["predict"], ctx.mix["depth"]
    in_flight = deque()
    clock = _Clock(pool[0].device)
    i = 0

    def collect():
        index, submitted, done, host = in_flight.popleft()
        with span("bench.serve.wait"):
            if done is None:
                done = time_now()
            else:
                done.synchronize()
        record(index, submitted, done, host)

    while not stop(i):
        submitted = time_now()
        with span("bench.serve.call"):
            out = predict(model, pool[i % len(pool)])
        called = time_now()
        with span("bench.serve.copy"):
            host = out.to("cpu", non_blocking=True)
            done = torch.cuda.Event(enable_timing=True) if out.is_cuda else None
            if done is not None:
                done.record()
        in_flight.append((i, submitted, done, host))
        record.call_s.append(called - submitted)
        i += 1
        if len(in_flight) > depth:
            collect()
    while in_flight:
        collect()
    clock.stop()
    return i, clock


class _Recorder:
    """Every request's submission and completion; the boxes of the
    `checked` requests that a seeded reservoir keeps (each finished request
    as likely as any other)."""

    def __init__(self, state, checked, keep):
        self.state, self.checked, self.keep = state, checked, keep
        self.call_s, self.completions = [], []

    def __call__(self, index, submitted, done, host):
        self.completions.append((submitted, done))
        if not self.keep:
            return
        kept, rng = self.state["kept"], self.state["rng"]
        n = self.state["requests"]
        if len(kept) < self.checked:
            kept.append((index, host))
        else:
            slot = int(rng.integers(0, n + 1))
            if slot < self.checked:
                kept[slot] = (index, host)
        self.state["requests"] = n + 1


def window(ctx, state, seconds, span=lambda name: nullcontext()):
    recorder = _Recorder(state, ctx.mix["checked"], keep=True)
    start = time_now()
    deadline = start + seconds
    attempted, clock = _loop(ctx, state, span, lambda i: time_now() >= deadline, recorder)
    finished = [clock.host_s(done) for _, done in recorder.completions]
    frames = attempted * ctx.mix["videos"] * ctx.mix["frames"]
    return Window(attempted=attempted, frames=frames, seconds=max(finished) - start,
                  host_call_s=recorder.call_s,
                  latencies_s=[f - s for (s, _), f in zip(recorder.completions, finished)])


def stretch(ctx, state, span):
    calls = ctx.mix["trace_calls"]
    _loop(ctx, state, span, lambda i: i >= calls, _Recorder(state, 0, keep=False))
    return calls


def expected_launches(ctx, state, attempted):
    """K1 once a request for OPNet; otherwise K4 once per LSTM layer."""
    if ctx.adapter.PORT_NAME == "opnet":
        return {"K1": attempted}
    return {"K4": attempted * len(ctx.adapter.lstm_widths(ctx.config))}


def release(state):
    for key in ("model", "predict"):
        state.pop(key, None)


def _reference_pixels(ctx, state, index, precision):
    """The reference's int16 boxes for pool batch `index`, in blocks of
    `reference_rows` videos."""
    boxes = state["pool"][index]
    rows = ctx.mix["reference_rows"]
    with torch.no_grad():
        return torch.cat([to_pixels(ctx.reference.forward(state["weights"], boxes[r:r + rows],
                                                          ctx.config, precision))
                          for r in range(0, boxes.shape[0], rows)]).cpu()


def numbers(ctx, state, precision="fp32"):
    """Over the kept requests: `px_gap`, the widest gap in pixels between a
    served coordinate and the reference's; `px_diff_share`, the share of
    served coordinates that differ from it; `video_diff_share`, the largest
    such share in one video. With `precision` other than "fp32" the
    reference in that precision stands in for the program (the control)."""
    cache = state.setdefault("reference", {})

    def reference(j, precision):
        if (precision, j) not in cache:
            cache[(precision, j)] = _reference_pixels(ctx, state, j, precision)
        return cache[(precision, j)]

    gap, differ, total, worst = 0, 0, 0, 0.0
    for index, served in state["kept"]:
        j = index % len(state["pool"])
        if precision != "fp32":
            served = reference(j, precision)
        diff = (served.to(torch.int32) - reference(j, "fp32").to(torch.int32)).abs()
        gap = max(gap, int(diff.max()))
        differ += int((diff > 0).sum())
        total += diff.numel()
        worst = max(worst, float((diff > 0).flatten(1).float().mean(1).max()))
    return {"px_gap": gap, "px_diff_share": differ / total, "video_diff_share": worst,
            "checked": len(state["kept"])}
