"""Readers of the port's spans and counters on the detector's path
(`objectpermanence_tpu_torch.utils.trace`), and of K7's share of its
least time. The port keeps spans only while a profiler records, so in a
run they are those of the profiled stretch.

A call is one of the stretch's last `run.trace.calls` root spans
`objperm.detect.video` with its descendants: its chunks' device spans and
copies. Where the port's bounded memory is full, a video that began
before its oldest span ended may have lost spans, and is left out. A
reader averages the videos that have what it reads, and returns None where
none has: a port without these spans included."""

import statistics

from benchmark import detector_bounds, readers
from benchmark.program_readers import _device_ms

ROOT = "objperm.detect.video"


def videos(run):
    """-> [(the video's root, all its spans)] over the stretch's last
    calls, or None."""
    if run.trace is None:
        return None
    try:
        from objectpermanence_tpu_torch.utils import trace
    except ImportError:
        return None
    records = trace.spans()
    roots = sorted((r for r in records if r.parent is None and r.name == ROOT),
                   key=lambda r: r.start_ns)
    if len(records) == trace.KEEP:
        roots = [r for r in roots if r.start_ns > records[0].end_ns]
    roots = roots[-run.trace.calls:]
    members = {}
    for record in records:
        members.setdefault(record.root, []).append(record)
    return [(root, members[root.id]) for root in roots] or None


def _mean(run, value):
    found = videos(run)
    values = [] if found is None else [value(*video) for video in found]
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def host_syncs_per_call(run):
    """Blocking reads and copies a video: its frames' copies to the card,
    its outputs' copies back and any wait of NMS's."""
    return _mean(run, lambda root, spans: root.syncs)


def backbone_ms_per_call(run):
    return _mean(run, _device_ms("objperm.detector.backbone"))


def proposals_ms_per_call(run):
    return _mean(run, _device_ms("objperm.detector.proposals"))


def heads_ms_per_call(run):
    return _mean(run, _device_ms("objperm.detector.heads"))


def roi_align_roofline(run):
    """K7's least time for a video's chunks (`detector_bounds`: the whole
    pyramid read once, the pooled rois written once) over the device time
    of the RoIAlign forward kernel."""
    config, frames = run.ctx.config, run.ctx.mix["frames"]
    chunk = config["preprocess_config"]["batch_size"]
    least = sum(detector_bounds.roi_align_seconds(config, min(chunk, frames - start))
                for start in range(0, frames, chunk))
    return readers.roofline(run, least, "roi_align_forward_kernel")
