"""Readers of the port's own spans and counters
(`objectpermanence_tpu_torch.utils.trace`). The port keeps spans only while
a profiler records, so in a run they are those of the profiled stretch.

A call is one of the stretch's last `run.trace.calls` root spans of the
cell's kind (`objperm.serve.predict`, `objperm.train.step`), with its
descendants and the port's copies made outside any call since the one
before it (a train step's batch is gathered before the step). Where the
port's bounded memory is full, a call that began before its oldest span
ended may have lost spans, and is left out. A reader averages the calls
that have what it reads, and returns None where none has: a port without
these spans included."""

import statistics

ROOTS = {"serve": "objperm.serve.predict", "train": "objperm.train.step"}
COPIES = "objperm.host."


def calls(run):
    """-> [(the call's roots, all its spans)] over the stretch's last
    calls, or None."""
    if run.trace is None:
        return None
    try:
        from objectpermanence_tpu_torch.utils import trace
    except ImportError:
        return None
    records = trace.spans()
    kind = ROOTS[run.ctx.mix["kind"]]
    groups, loose = [], []
    for root in sorted((r for r in records if r.parent is None), key=lambda r: r.start_ns):
        if root.name == kind:
            groups.append([root] + loose)
            loose = []
        elif root.name.startswith(COPIES):
            loose.append(root)
        else:
            loose = []
    if len(records) == trace.KEEP:
        groups = [g for g in groups if min(r.start_ns for r in g) > records[0].end_ns]
    groups = groups[-run.trace.calls:]
    if not groups:
        return None
    members = {}
    for record in records:
        members.setdefault(record.root, []).append(record)
    return [(roots, [s for r in roots for s in members[r.id]]) for roots in groups]


def _mean(run, value):
    """The mean of `value(roots, spans)` over the calls where it is not
    None, or None."""
    found = calls(run)
    values = [] if found is None else [value(*call) for call in found]
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def _device_ms(name):
    def value(roots, spans):
        times = [s.device_ms for s in spans if s.name == name]
        return sum(times) if times else None
    return value


def host_own_ms_per_call(run):
    """Host milliseconds of a call outside the port's blocking copies: its
    roots' host time less the host's wait in those copies."""
    return _mean(run, lambda roots, spans: sum(r.host_ms for r in roots) - sum(
        s.host_ms for s in spans if s.name.startswith(COPIES)))


def host_syncs_per_call(run):
    """Copies that blocked the host until the stream drained, a call."""
    return _mean(run, lambda roots, spans: sum(r.syncs for r in roots))


def encoder_ms_per_call(run):
    """Device milliseconds of the encoder's forward, a call."""
    return _mean(run, _device_ms("objperm.model.encoder"))


def backward_ms_per_call(run):
    """Device milliseconds of `loss.backward()`, a step."""
    return _mean(run, _device_ms("objperm.train.backward"))
