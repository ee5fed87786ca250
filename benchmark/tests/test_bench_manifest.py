"""BENCHMARK.json against the benchmark's contract, and every file a cell
is found by."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    every = [x["name"] for x in manifest["configs"] + manifest["workloads"] + metrics]
    assert len(every) == len(set(every))
    for name in every:
        assert NAME.match(name), name
    for metric in metrics:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES
    for metric in manifest["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_has_its_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for cell in manifest["workloads"]:
        assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
        config = configs[cell["config"]]
        assert config["file"] == f"benchmark/configs/{cell['config']}.json"
        assert (harness.ROOT / config["file"]).exists()
        for path in (f"traffic/{cell['traffic']}.json", f"limits/{cell['name']}.json",
                     f"models/{cell['config']}.py", f"reference/{cell['config']}.py"):
            assert (harness.BENCH_DIR / path).exists(), path
        mix = harness.load_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
        assert (harness.BENCH_DIR / "kinds" / f"{mix['kind']}.py").exists()


def test_every_cell_reports_what_its_metrics_move(manifest):
    end_to_end = {m["name"] for m in manifest["end_to_end"]}
    for cell in manifest["workloads"]:
        own = {m["name"] for m in harness.metrics_of(manifest, cell["name"], trace=False)}
        layer = harness.metrics_of(manifest, cell["name"], trace=True)
        assert "setup_s" in own and len(own) >= 2 and layer
        for metric in layer:
            assert metric["moves"] in own & end_to_end, (cell["name"], metric["name"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(manifest, group):
    for metric in manifest[group]:
        assert callable(harness.reader(metric["name"]))


def test_each_layer_named_alike(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    assert layers == {"entry and driver", "model step", "kernels", "device"}


def test_a_full_check_fits_with_24_cells(manifest):
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_limits_name_numbers_the_kinds_compute(manifest):
    produced = {"serve": {"px_gap", "px_diff_share", "video_diff_share"},
                "train": {"loss_gap", "grad_gap", "change_gap"}}
    for cell in manifest["workloads"]:
        limits = harness.load_json(harness.BENCH_DIR / "limits" / f"{cell['name']}.json")
        mix = harness.load_json(harness.BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
        assert limits["numbers"] and set(limits["numbers"]) <= produced[mix["kind"]]
