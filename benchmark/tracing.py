"""The reduction of a `torch.profiler` stretch to the numbers the per-layer
readers and the result's `device` and `breakdown` take.

The stretch is the span `bench.profiled`, which ends in a synchronise, so
every device operation it enqueued lies inside it. Device time is the union
of the device operations' intervals (kernels, copies, sets) clipped to the
stretch; an idle gap is a stretch of no device operation, put down to the
benchmark's own host span (`bench.*`) that covers its midpoint.
"""

import re
from contextlib import contextmanager
from types import SimpleNamespace
from dataclasses import dataclass, field

import torch

STRETCH = "bench.profiled"
_NAME = re.compile(r"^(?:void )?([A-Za-z_][\w:]*(?:<[^(]*>)?)")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    calls: int                                        # calls or steps in the stretch
    op_s: dict = field(default_factory=dict)          # device seconds by operation name
    idle_by_span: dict = field(default_factory=dict)  # idle seconds by host span

    def seconds_of(self, *identifiers):
        """Device seconds of the operations whose name holds one of
        `identifiers` as a whole word."""
        pattern = re.compile(r"\b(?:" + "|".join(map(re.escape, identifiers)) + r")\b")
        return sum(s for name, s in self.op_s.items() if pattern.search(name))

    def gemm_seconds(self):
        """Device seconds of the GEMMs: the operations named as cuBLAS and
        CUTLASS name them (`..._gemm_...`, `..._sgemm_...`)."""
        return sum(s for name, s in self.op_s.items() if "gemm" in name.lower())

    def breakdown(self, top=10):
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def op_name(raw):
    """A device operation's name without its argument list."""
    raw = raw.replace("(anonymous namespace)::", "")
    match = _NAME.match(raw)
    return match.group(1) if match else raw.split("(")[0]


@contextmanager
def profiled(device):
    """Profile the enclosed stretch (host and, on a card, device); yields a
    holder whose `profile` is the finished profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    holder = SimpleNamespace()
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(STRETCH):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    holder.profile = prof


def reduce(prof, calls):
    """The `Trace` of a finished profiler over a `bench.profiled` stretch of
    `calls` calls or steps."""
    events = prof.events()
    stretch = [e for e in events if e.name == STRETCH]
    if len(stretch) != 1:
        raise RuntimeError(f"expected one {STRETCH} span, found {len(stretch)}")
    t0, t1 = stretch[0].time_range.start, stretch[0].time_range.end
    device_ops, spans = [], []
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                start, end = max(e.time_range.start, t0), min(e.time_range.end, t1)
                if end > start:
                    device_ops.append((start, end, op_name(e.name)))
        elif e.name.startswith("bench.") and e.name != STRETCH:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    op_s = {}
    for start, end, name in device_ops:
        op_s[name] = op_s.get(name, 0.0) + (end - start) / 1e6
    busy_us, idle = 0.0, {}
    cursor = t0
    for start, end in _union((s, e) for s, e, _ in device_ops) + [(t1, t1)]:
        if start > cursor:
            where = _span_at((cursor + start) / 2, spans)
            idle[where] = idle.get(where, 0.0) + (start - cursor) / 1e6
        busy_us += end - start
        cursor = max(cursor, end)
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6, calls=calls, op_s=op_s,
                 idle_by_span=idle)


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [tuple(iv) for iv in merged]


def _span_at(t, spans):
    """The innermost benchmark span covering time `t`, or "other"."""
    covering = [(end - start, name) for start, end, name in spans if start <= t <= end]
    return min(covering)[1] if covering else "other"
