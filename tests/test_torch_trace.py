"""The port's spans and counters (`objectpermanence_tpu_torch/utils/trace.py`):
off they cost a check and keep nothing; on, under `torch.profiler` or
`recording()`, each span lies inside the profiler's event of its name on
the profiler's clock, a call's spans share their root's id, the memory is
bounded, the copy sites count their syncs, `predict_step` and `train_step`
make their roots and children, the benchmark's program readers group and
average calls, and the benchmark's cells at their CPU test sizes report
every metric read from them."""

import importlib.util
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.data.ingest import IngestedDataset
from objectpermanence_tpu_torch.infer.reasoning import make_predict_step
from objectpermanence_tpu_torch.models.registry import get_model_spec
from objectpermanence_tpu_torch.train.loop import DeviceDataset, make_optimizer, make_train_step
from objectpermanence_tpu_torch.utils import trace

REPO_ROOT = Path(__file__).resolve().parent.parent
NEW_METRICS = ["host_own_ms_per_call", "host_syncs_per_call", "encoder_ms_per_call",
               "backward_ms_per_call"]
# the per-layer metrics of the accepted benchmark, in its order
ACCEPTED = ["host_ms_per_call.serve", "host_ms_per_call.train", "mfu.serve", "mfu.train",
            "opnet_fused_roofline.serve", "lstm_scan_roofline.train",
            "lstm_scan_roofline.serve", "device_idle.serve", "device_idle.train"]


def _tiny():
    """`benchmark/tests/conftest.py`'s small configurations and mixes."""
    threads = torch.get_num_threads()
    spec = importlib.util.spec_from_file_location(
        "benchmark_tests_conftest", REPO_ROOT / "benchmark" / "tests" / "conftest.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.set_num_threads(threads)  # that file sets its own process's threads
    return module.TINY_CONFIGS, module.TINY_MIXES


TINY_CONFIGS, TINY_MIXES = _tiny()


@pytest.fixture(autouse=True)
def _fresh():
    trace.clear()
    yield
    trace.clear()


def _no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _model(name, train=False):
    config = TINY_CONFIGS[name]
    spec = get_model_spec(name, config)
    return spec, spec.build(config, torch.Generator().manual_seed(0)).train(train)


def _boxes(spec, batch=2, frames=12):
    rng = np.random.default_rng(0)
    return rng.random((batch, frames, 15, spec.feature_width), dtype=np.float32)


def _dataset(count=5, frames=12, features=6):
    rng = np.random.default_rng(1)
    return IngestedDataset([f"video_{i}" for i in range(count)],
                           rng.random((count, frames, 15, features), dtype=np.float32),
                           np.zeros((count, frames), np.int64),
                           rng.random((count, frames, 4), dtype=np.float32))


def test_off_a_span_calls_no_record_function_and_keeps_nothing(monkeypatch):
    _no_record_function(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    with trace.span("objperm.test", torch.device("cpu")) as opened:
        assert opened is None
    assert trace.span("objperm.a") is trace.span("objperm.b")
    spec, model = _model("transformer_lstm")
    make_predict_step(spec, "cpu")(model, _boxes(spec))
    assert trace.spans() == []


def test_spans_lie_inside_the_profiler_events_of_their_names():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("objperm.test.outer", torch.device("cpu")):
            with trace.span("objperm.test.inner"):
                torch.ones(1000).sum()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events() if e.name.startswith("objperm.test")}
    kept = trace.spans()
    assert sorted(s.name for s in kept) == sorted(events) == ["objperm.test.inner",
                                                              "objperm.test.outer"]
    for record in kept:
        event = events[record.name]
        low = start_ns + event.time_range.start * 1e3
        high = start_ns + event.time_range.end * 1e3
        assert low - 50e3 <= record.start_ns < record.end_ns <= high + 50e3, record.name
    outer, inner = sorted(kept, key=lambda s: s.start_ns)
    assert outer.device_ms == outer.host_ms and inner.device_ms is None


def test_a_calls_spans_share_its_root_and_two_calls_differ():
    with trace.recording():
        for _ in range(2):
            with trace.span("objperm.test.root"):
                with trace.span("objperm.test.child"):
                    with trace.span("objperm.test.leaf"):
                        pass
    kept = trace.spans()
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["objperm.test.root"] * 2
    assert roots[0].id != roots[1].id
    for root in roots:
        mine = {s.name: s for s in kept if s.root == root.id}
        assert set(mine) == {"objperm.test.root", "objperm.test.child", "objperm.test.leaf"}
        assert mine["objperm.test.child"].parent == root.id
        assert mine["objperm.test.leaf"].parent == mine["objperm.test.child"].id
        assert root.syncs == 0 and mine["objperm.test.child"].syncs is None


def test_recording_keeps_spans_without_a_profiler(monkeypatch):
    _no_record_function(monkeypatch)
    with trace.recording():
        with trace.span("objperm.test", torch.device("cpu")) as opened:
            pass
    with trace.span("objperm.test.after"):
        pass
    assert trace.spans() == [opened]
    assert opened.name == "objperm.test" and opened.end_ns >= opened.start_ns


def test_the_memory_is_bounded():
    ids = []
    with trace.recording():
        for _ in range(trace.KEEP + 5):
            with trace.span("objperm.test") as opened:
                ids.append(opened.id)
    kept = trace.spans()
    assert len(kept) == trace.KEEP
    assert [s.id for s in kept] == ids[5:]


@pytest.mark.parametrize("on", [True, False], ids=["recording", "off"])
def test_a_copy_site_counts_its_syncs_with_the_delta_on_the_root(on):
    """`DeviceDataset.batch` on the meta device (a device that is not the
    host) copies its indices: one sync; reads of two device tensors are two
    syncs; nothing is counted on the CPU."""
    data = DeviceDataset(_dataset(), "meta")
    before = trace.host_syncs
    with trace.recording() if on else nullcontext():
        with trace.span("objperm.test.root") as root:
            data.batch(np.array([0, 2, 4]))
            read = (torch.empty(3, device="meta"), torch.empty(2, dtype=torch.int16,
                                                                device="meta"), torch.ones(1))
            with trace.d2h(*read):
                pass
            DeviceDataset(_dataset(), "cpu").batch(np.array([1]))
        data.batch(np.array([1, 3]))  # a copy with no span open is a root itself
    assert trace.host_syncs - before == 4
    if not on:
        assert root is None and trace.spans() == []
        return
    assert root.syncs == 3
    copies = [s.name for s in trace.spans() if s.parent == root.id]
    assert copies == ["objperm.host.h2d", "objperm.host.d2h"]
    loose = trace.spans()[-1]
    assert loose.parent is None and loose.name == "objperm.host.h2d" and loose.syncs == 1


@pytest.mark.parametrize("name", ["opnet", "transformer_lstm"])
def test_predict_step_makes_its_root_and_children(name):
    spec, model = _model(name)
    predict = make_predict_step(spec, "cpu", out_dtype=torch.int16)
    with trace.recording():
        for _ in range(2):
            predict(model, _boxes(spec))
    kept = trace.spans()
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["objperm.serve.predict"] * 2
    assert roots[0].id != roots[1].id
    for root in roots:
        assert root.device_ms is None and root.host_ms > 0 and root.syncs == 0
        children = [s for s in kept if s.root == root.id and s is not root]
        want = ["objperm.model.encoder"] if name == "transformer_lstm" else []
        assert [s.name for s in children] == want
        for child in children:
            assert child.parent == root.id and child.device_ms == child.host_ms > 0
            assert root.start_ns <= child.start_ns <= child.end_ns <= root.end_ns


def test_train_step_makes_its_root_encoder_and_backward():
    spec, model = _model("transformer_lstm", train=True)
    step = make_train_step(spec, make_optimizer(model.parameters(), 1e-3),
                           torch.Generator().manual_seed(2))
    data = DeviceDataset(_dataset(features=spec.feature_width), "cpu")
    with trace.recording():
        for indices in ([0, 1], [2, 3]):
            boxes, labels, mask, _ = data.batch(np.array(indices))
            step(model, boxes, labels, mask)
    kept = trace.spans()
    roots = [s for s in kept if s.parent is None]
    assert [s.name for s in roots] == ["objperm.train.step"] * 2
    for root in roots:
        mine = {s.name: s for s in kept if s.root == root.id and s is not root}
        assert set(mine) == {"objperm.model.encoder", "objperm.train.backward"}
        encoder, backward = mine["objperm.model.encoder"], mine["objperm.train.backward"]
        assert encoder.parent == backward.parent == root.id
        assert root.start_ns <= encoder.start_ns < encoder.end_ns <= backward.start_ns
        assert backward.end_ns <= root.end_ns
        assert root.device_ms is None and root.host_ms > 0
        for record in (encoder, backward):
            assert record.device_ms == record.host_ms > 0


def _three_steps():
    """Three train steps as the benchmark's train cell makes them: a batch
    copied onto a device that is not the host, then the step's root with
    its encoder and backward on the CPU."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    with trace.recording():
        for _ in range(3):
            with trace.h2d(torch.ones(2), meta):
                time.sleep(1e-3)
            with trace.span("objperm.train.step"):
                with trace.span("objperm.model.encoder", cpu):
                    time.sleep(1e-3)
                with trace.span("objperm.train.backward", cpu):
                    pass
    return trace.spans()


def _train_run(calls):
    return SimpleNamespace(trace=SimpleNamespace(calls=calls),
                           ctx=SimpleNamespace(mix={"kind": "train"}))


def test_the_readers_group_a_step_with_its_batch_and_skip_a_missing_span(monkeypatch):
    from benchmark import program_readers as read

    kept = _three_steps()
    steps = [s for s in kept if s.name == "objperm.train.step"]
    encoders = [s for s in kept if s.name == "objperm.model.encoder"]
    run = _train_run(3)
    found = read.calls(run)
    assert [[r.name for r in roots] for roots, _ in found] == [
        ["objperm.train.step", "objperm.host.h2d"]] * 3
    assert read.host_syncs_per_call(run) == 1
    own = read.host_own_ms_per_call(run)
    assert own == pytest.approx(sum(s.host_ms for s in steps) / 3)
    assert read.encoder_ms_per_call(run) == pytest.approx(
        sum(s.device_ms for s in encoders) / 3)
    # a call whose encoder span is gone is left out of that mean, not read as 0
    monkeypatch.setattr(trace, "spans", lambda: [s for s in kept if s is not encoders[1]])
    assert read.encoder_ms_per_call(run) == pytest.approx(
        (encoders[0].device_ms + encoders[2].device_ms) / 2)
    assert read.host_own_ms_per_call(run) == pytest.approx(own)


def test_the_readers_leave_out_a_call_the_bounded_memory_cut(monkeypatch):
    """With the memory full, the first step, whose batch copy and encoder
    dropped out, is not a call; the two after it are."""
    from benchmark import program_readers as read

    kept = _three_steps()[2:]
    monkeypatch.setattr(trace, "spans", lambda: kept)
    monkeypatch.setattr(trace, "KEEP", len(kept))
    steps = [s for s in kept if s.name == "objperm.train.step"]
    found = read.calls(_train_run(3))
    assert [roots[0].id for roots, _ in found] == [s.id for s in steps[1:]]
    assert read.host_syncs_per_call(_train_run(3)) == 1


@pytest.mark.parametrize("cell", ["opnet.serve_b512", "transformer_lstm.train_b16",
                                  "transformer_lstm.serve_b512"])
def test_a_traced_cell_reports_every_metric_read_from_the_port(cell):
    from benchmark import harness

    manifest = harness.load_json(harness.MANIFEST)
    assert [m["name"] for m in manifest["per_layer"][:len(ACCEPTED)]] == ACCEPTED
    config, kind = cell.split(".")[0], "serve" if "serve" in cell else "train"
    result, _, _ = harness.run_cell(
        manifest, cell, 2**33 + 11, 0.3, True, torch.device("cpu"), 0.0,
        config=TINY_CONFIGS[config], mix=TINY_MIXES[kind], log=lambda text: None)
    assert result["correct"]
    listed = {m["name"] for m in harness.metrics_of(manifest, cell, trace=True)}
    new = {name for name in listed if name.split(".")[0] in NEW_METRICS}
    want = {f"host_own_ms_per_call.{kind}", f"host_syncs_per_call.{kind}"}
    if config == "transformer_lstm":
        want.add(f"encoder_ms_per_call.{kind}")
    if kind == "train":
        want.add("backward_ms_per_call.train")
    assert new == want
    reported = result["metrics"]
    assert want <= set(reported) <= listed
    # the host's clock metrics are still read; on the CPU no card was waited for
    assert {f"host_ms_per_call.{kind}", f"mfu.{kind}"} <= set(reported)
    assert reported[f"host_syncs_per_call.{kind}"]["value"] == 0
    for name in want - {f"host_syncs_per_call.{kind}"}:
        assert reported[name]["value"] > 0 and reported[name]["unit"] == "ms"
