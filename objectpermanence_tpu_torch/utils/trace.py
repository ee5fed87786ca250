"""Spans and counters at the port's layer boundaries.

A span is off unless `torch.profiler` is recording or a `recording()` block
is open. Off, `span()` costs one check and returns a shared null context:
no `record_function`, no event, nothing kept. On, a span

- opens `torch.profiler.record_function(name)` while a profiler records, so
  it shows in the profiler's trace beside the kernels it launched;
- keeps a `Span` in a bounded memory (`spans()`, `clear()`): name, id,
  parent, root, start and end in Unix-epoch ns (`time.time_ns()`, the clock
  the profiler's events are stamped in: a trace's `trace_start_ns()` plus
  an event's `time_range` in us);
- where `device` is a card, records a CUDA event at each end on the
  device's current stream; `Span.device_ms` reads their interval once the
  caller has synchronised. On the CPU the device interval is the host's.

A root span (none open on its thread) keeps the delta of `host_syncs` over
its interval; its id is the `root` of every span under it, the request
(serve) or step (train) id they share.

`host_syncs` is a plain integer, always on: the blocking copies between
host and device that the reasoner paths make (`h2d`, `d2h`), each of which
blocks the host until the stream has drained.

The port's spans and counters, and what reads them:

- `objperm.serve.predict` (root; `infer/reasoning.py`'s `predict_step`) and
  `objperm.train.step` (root; `train/loop.py`'s `train_step`): a call,
  whose spans the benchmark's program readers group, and whose host time
  `host_own_ms_per_call.*` reads;
- `objperm.model.encoder` (device; `ops/attention.py::Encoder.forward`):
  the encoder's forward, `encoder_ms_per_call.*`;
- `objperm.train.backward` (device; `loss.backward()` in `train_step`):
  `backward_ms_per_call.train`;
- `objperm.host.h2d`, `objperm.host.d2h` with `host_syncs`: the host's
  wait, which `host_own_ms_per_call.*` takes out of a call's host time,
  `host_syncs_per_call.*`, and `TrainingConfig.profile_dir`'s trace.
"""

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from typing import Optional

import torch

KEEP = 8192  # spans kept; older ones drop out

host_syncs = 0

_NULL = nullcontext()
_records = deque(maxlen=KEEP)
_ids = itertools.count(1)
_local = threading.local()
_recording = 0
_profiling = torch.autograd._profiler_enabled


@dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    root: int
    start_ns: int
    end_ns: int = 0
    syncs: Optional[int] = None      # a root's delta of `host_syncs`
    events: Optional[tuple] = None   # CUDA events at the two ends
    on_device: bool = False          # a device was named

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """The span's interval on its device's stream (after a synchronise);
        on the CPU the host interval; None where it names no device."""
        if self.events is not None:
            return self.events[0].elapsed_time(self.events[1])
        return self.host_ms if self.on_device else None


class _Open:
    __slots__ = ("name", "device", "record", "function", "before")

    def __init__(self, name, device):
        self.name, self.device = name, device
        self.before = host_syncs  # taken before a copy helper counts its copy

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.function = None
        if _profiling():
            self.function = torch.profiler.record_function(self.name)
            self.function.__enter__()
        span_id = next(_ids)
        parent = stack[-1] if stack else None
        events = None
        if self.device is not None and self.device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record(torch.cuda.current_stream(self.device))
        self.record = Span(self.name, span_id, parent.id if parent else None,
                           parent.root if parent else span_id, time.time_ns(),
                           events=events, on_device=self.device is not None)
        stack.append(self.record)
        return self.record

    def __exit__(self, *exc):
        record = self.record
        if record.events is not None:
            record.events[1].record(torch.cuda.current_stream(self.device))
        record.end_ns = time.time_ns()
        _local.stack.pop()
        if record.parent is None:
            record.syncs = host_syncs - self.before
        _records.append(record)
        if self.function is not None:
            self.function.__exit__(*exc)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context manager: the span `name`, with a device interval on
    `device` where one is given (see the module's docstring)."""
    if not (_recording or _profiling()):
        return _NULL
    return _Open(name, device)


@contextmanager
def recording():
    """Keep spans without a profiler while the block is open."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The kept spans, oldest end first."""
    return list(_records)


def clear() -> None:
    _records.clear()


def h2d(source: torch.Tensor, device: torch.device):
    """Count the blocking copy of host tensor `source` onto `device` that the
    block makes, and span it while on. Nothing where `source` is already
    off the host or `device` is the CPU."""
    global host_syncs
    if source.device.type != "cpu" or device.type == "cpu":
        return _NULL
    opened = span("objperm.host.h2d")
    host_syncs += 1
    return opened


def d2h(*tensors: torch.Tensor):
    """Count the blocking reads onto the host of the device tensors among
    `tensors` that the block makes, one each, and span them while on."""
    global host_syncs
    read = sum(t.device.type != "cpu" for t in tensors)
    if not read:
        return _NULL
    opened = span("objperm.host.d2h")
    host_syncs += read
    return opened
