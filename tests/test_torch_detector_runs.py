"""The port's 800 px detector drivers against the JAX package's scripts on
the CPU: `experiments/detector_800px_run.py`, `detector_infer800.py` and
`detector_transfer_demo.py` (JAX's imported as `scripts.<name>`), and the
weight export they rely on, `models/detector/convert.py::
export_torchvision_state_dict`.

The detectors are TINY (ResNet 1-1-1-1, width 16, FPN 32, RPN 100/60, 16
detections, GroupNorm): `contract` and `detector_infer800` at the real 800
px geometry (240 x 320 frames to 800 x 1067, padded to 800 x 1088), the
native stages at the two-stage test's 60 x 80, `steptime` and `train800`
(held on the structure of what they write) at a small "800" geometry of
120 x 160. Both packages run on the same seeded scenes, each on its own
root; where they share weights, those are JAX's `PRNGKey(0)` init, saved in
each package's format. JAX's windowed kernel runs in interpret mode.
Tolerances, with their reasons:
- `render` (frames only, scene links): every file and link byte for byte;
- `native` training from the same init on the same draws: each step's loss
  parts within 1e-5 relative (`tests/test_torch_detector_train.py`'s TINY
  step); the report with JAX's keys, its test mAP within 1e-6, its contract
  counts equal (no windowed dispatch: 0 rois); `train800` in bf16 (no JAX
  run: JAX's windowed backward has no interpret-mode compile here in the
  lane's time) on the structure of its report, real contract rates;
- `steptime`: the three rows with JAX's keys and the port's RoI path;
- `contract` on one checkpoint: the counts equal JAX's;
- `detector_infer800` on one checkpoint: the fp32_windowed row's test mAP,
  AP50 and AP75 within 1e-6 of JAX's, the bf16_windowed row (the port
  only) on its structure; rows merge into `infer800.json`;
- the transfer demo's datasets byte for byte, its `results.json` on its
  structure; the `.pth` round trip exact, and the export equal to JAX's
  `export_torchvision_state_dict` of the same weights, key for key.
"""

import functools
import json

import numpy as np
import pytest
import torch

import scripts.detector_800px_run as jax_d8
import scripts.detector_infer800 as jax_i8
import scripts.detector_transfer_demo as jax_td
from objectpermanence_tpu.models.detector.convert import (
    export_torchvision_state_dict as jax_export_torchvision_state_dict,
)
from objectpermanence_tpu.ops import pallas_roi_align as pra
from objectpermanence_tpu.utils.checkpoint import save_params as jax_save_params
from objectpermanence_tpu_torch.experiments import (
    containment_run, detector_800px_run, detector_infer800, detector_transfer_demo,
)
from objectpermanence_tpu_torch.models.detector.convert import export_torchvision_state_dict
from objectpermanence_tpu_torch.models.detector.detector import (
    CaterDetector, Detector, DetectorConfig,
)
from objectpermanence_tpu_torch.utils.checkpoint import save_params
from torch_experiment_helpers import (
    files, jax_config, jax_init, jax_main, run_quiet, same_detector_start,
)
from torch_lane import one_torch_thread  # noqa: F401

WIDTHS = dict(backbone_layers=(1, 1, 1, 1), backbone_width=16, fpn_channels=32,
              rpn_pre_nms_top_n=100, rpn_post_nms_top_n=60, detections_per_img=16,
              backbone_norm="group")
GEOMETRY = {"800": dict(min_size=800, max_size=1333), "native": dict(min_size=60, max_size=80)}
# steptime and train800, which hold the structure of what they write, at a
# smaller "800" geometry: a step at 800 px takes seconds on the CPU
SMALL = {**GEOMETRY, "800": dict(min_size=120, max_size=160)}
SPLITS = {"train": (4, 61), "dev": (2, 62), "test": (2, 63)}     # split: scenes, seed
FRAMES, SAMPLES, EPOCHS = 60, 2, 1
LOSS_RTOL, MAP_ATOL = 1e-5, 1e-6
REPORT_KEYS = {"geometry", "epochs", "batch", "compute_dtype", "best_dev_map", "test",
               "train_seconds", "train_contract", "eval_contract", "history", "checkpoint"}


def _tiny(config_cls, geometries=GEOMETRY):
    def config(geometry, roi_backend, compute_dtype="float32"):
        return config_cls(**geometries[geometry], **WIDTHS, roi_backend=roi_backend,
                          compute_dtype=compute_dtype)
    return config


@pytest.fixture
def tiny(monkeypatch):
    """Both 800 px run drivers at TINY width; JAX's windowed kernel in
    interpret mode."""
    monkeypatch.setattr(jax_d8, "_config", _tiny(jax_config))
    monkeypatch.setattr(detector_800px_run, "_config", _tiny(DetectorConfig))
    monkeypatch.setattr(pra.pl, "pallas_call",
                        functools.partial(pra.pl.pallas_call, interpret=True))


@pytest.fixture
def small(monkeypatch):
    """The 800 px run drivers at TINY width and the SMALL geometries."""
    monkeypatch.setattr(jax_d8, "_config", _tiny(jax_config, SMALL))
    monkeypatch.setattr(detector_800px_run, "_config", _tiny(DetectorConfig, SMALL))


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    src = tmp_path_factory.mktemp("src")
    for split, (scenes, seed) in SPLITS.items():
        run_quiet(containment_run.gen_split, src, split, scenes, seed, FRAMES, 4)
    base = tmp_path_factory.mktemp("det800")
    run_quiet(jax_d8.render, src, base / "jax", SAMPLES)
    run_quiet(detector_800px_run.render, src, base / "port", SAMPLES)
    return src, base / "jax", base / "port"


def _shared_checkpoint(jax_root, port_root, tag="det800"):
    """JAX's init at the 800 px TINY config as `<tag>/best_0.5` in each
    package's format."""
    params, state_dict = jax_init(jax_d8_config("800", "gather"))
    jax_save_params(jax_root / tag / "best_0.5", params)
    save_params(port_root / tag / "best_0.5.npz", state_dict)


def jax_d8_config(geometry, roi_backend, compute_dtype="float32"):
    return _tiny(jax_config)(geometry, roi_backend, compute_dtype)


def test_render_bytes_equal(rendered):
    src, jax_root, port_root = rendered
    ours, theirs = files(port_root), files(jax_root)
    assert ours == theirs
    for split, (scenes, _) in SPLITS.items():
        links = [v for k, v in ours.items() if k.startswith(f"{split}/scenes_subset/")]
        assert len(links) == scenes and all(v[1].startswith(str(src / split)) for v in links)
        assert len([k for k in ours if k.startswith(f"{split}/det_images/")
                    and k.endswith(".png")]) == scenes * SAMPLES
        assert not (port_root / split / "videos").exists()


def test_native_train_matches_jax_and_train800_writes_its_report(rendered, small, tmp_path):
    _, jax_rendered, port_rendered = rendered
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root, rendered_root in ((jax_root, jax_rendered), (port_root, port_rendered)):
        for split in SPLITS:
            (root / split).mkdir(parents=True)
            (root / split / "det_images").symlink_to(rendered_root / split / "det_images")
            (root / split / "detection_annotations.csv").symlink_to(
                rendered_root / split / "detection_annotations.csv")
    steps = SPLITS["train"][0] * SAMPLES // 8
    with pytest.MonkeyPatch.context() as mp:
        losses = same_detector_start(mp, jax_d8_config("native", "auto"), max(steps, 1))
        jax_main(jax_d8, ["native", "--root", jax_root, "--epochs", EPOCHS])
        run_quiet(detector_800px_run.main, ["native", "--root", str(port_root), "--epochs",
                                            str(EPOCHS), "--device", "cpu"])
    assert len(losses["port"]) == len(losses["jax"]) == max(steps, 1)
    for ours, theirs in zip(losses["port"], losses["jax"]):
        for name in theirs:
            assert ours[name] == pytest.approx(theirs[name], rel=LOSS_RTOL), name
    ours = json.loads((port_root / "detnative" / "report.json").read_text())
    theirs = json.loads((jax_root / "detnative" / "report.json").read_text())
    assert set(ours) == set(theirs) == REPORT_KEYS
    for key in ("geometry", "epochs", "batch", "compute_dtype"):
        assert ours[key] == theirs[key], key
    for key in theirs["test"]:
        assert ours["test"][key] == pytest.approx(theirs["test"][key], abs=MAP_ATOL), key
    for key in ("train_contract", "eval_contract"):
        assert ours[key] == theirs[key] == {"rois": 0, "out_of_contract": 0, "rate": None}

    run_quiet(detector_800px_run.main, ["train800", "--root", str(port_root), "--epochs",
                                        str(EPOCHS), "--compute-dtype", "bfloat16",
                                        "--device", "cpu"])
    report = json.loads((port_root / "det800" / "report.json").read_text())
    assert set(report) == REPORT_KEYS and report["compute_dtype"] == "bfloat16"
    assert report["geometry"] == "800" and report["batch"] == 4
    assert len(report["history"]) == EPOCHS and np.isfinite(report["history"][0]["train_loss"])
    for key in ("train_contract", "eval_contract"):
        c = report[key]
        assert c["rois"] > 0 and c["rate"] == round(c["out_of_contract"] / c["rois"], 5), c
    assert report["checkpoint"].startswith(str(port_root / "det800" / "best_"))
    assert "already complete" in run_quiet(detector_800px_run.main, [
        "train800", "--root", str(port_root), "--device", "cpu"])


def test_steptime_rows(rendered, small):
    _, _, port_root = rendered
    run_quiet(detector_800px_run.main, ["steptime", "--root", str(port_root), "--steps", "1",
                                        "--device", "cpu"])
    rows = json.loads((port_root / "steptime.json").read_text())
    assert list(rows) == ["800px_windowed", "800px_gather", "native_pallas"]
    assert [r["batch"] for r in rows.values()] == [4, 4, 8]
    assert [r["roi_path"] for r in rows.values()] == ["windowed", "exact", "exact"]
    for r in rows.values():
        assert set(r) == {"step_ms", "batch", "imgs_per_s", "roi_path"} and r["step_ms"] > 0
        assert r["imgs_per_s"] == pytest.approx(r["batch"] / r["step_ms"] * 1000, rel=1e-2)


def test_contract_counts_match_jax(rendered, tiny, tmp_path):
    _, jax_rendered, port_rendered = rendered
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root, rendered_root in ((jax_root, jax_rendered), (port_root, port_rendered)):
        for split in SPLITS:
            (root / split).mkdir(parents=True)
            for name in ("det_images", "detection_annotations.csv"):
                (root / split / name).symlink_to(rendered_root / split / name)
    _shared_checkpoint(jax_root, port_root)
    run_quiet(jax_d8.contract, jax_root, "det800", batches=1, batch=SAMPLES)
    run_quiet(detector_800px_run.contract, port_root, "det800", batches=1, batch=SAMPLES,
              device="cpu")
    ours = json.loads((port_root / "det800" / "contract.json").read_text())
    theirs = json.loads((jax_root / "det800" / "contract.json").read_text())
    assert ours == theirs and set(ours) == {"train_contract_cpu", "eval_contract_cpu"}
    # every roi slot: the proposals, and in training the padded gt rows too
    assert ours["train_contract_cpu"]["rois"] > ours["eval_contract_cpu"]["rois"] == SAMPLES * 60


def test_infer800_rows_match_jax(rendered, tmp_path):
    _, jax_rendered, port_rendered = rendered
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    for root, rendered_root in ((jax_root, jax_rendered), (port_root, port_rendered)):
        (root / "test").mkdir(parents=True)
        for name in ("det_images", "detection_annotations.csv"):
            (root / "test" / name).symlink_to(rendered_root / "test" / name)
    _shared_checkpoint(jax_root, port_root)

    def config(config_cls):
        return lambda c: config_cls(min_size=800, max_size=1333, **{
            **WIDTHS, "rpn_pre_nms_top_n": c["pre"] // 5, "rpn_post_nms_top_n": c["post"] // 5},
            compute_dtype=c["compute_dtype"], roi_backend="windowed")

    argv = ["--batch", "2", "--iters", "1", "--configs"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_i8, "_config", config(jax_config))
        mp.setattr(detector_infer800, "_config", config(DetectorConfig))
        mp.setattr(pra.pl, "pallas_call", functools.partial(pra.pl.pallas_call, interpret=True))
        jax_main(jax_i8, ["--root", jax_root, *argv, "fp32_windowed"])
        for name in ("fp32_windowed", "bf16_windowed"):
            run_quiet(detector_infer800.main, ["--root", str(port_root), *argv, name,
                                               "--device", "cpu"])
    ours = json.loads((port_root / "infer800.json").read_text())
    theirs = json.loads((jax_root / "infer800.json").read_text())
    assert list(ours) == ["fp32_windowed", "bf16_windowed"] and list(theirs) == ["fp32_windowed"]
    for row in ours.values():
        assert set(row) == set(theirs["fp32_windowed"]) and row["fps"] > 0
        assert row["batch"] == 2 and row["fps"] == pytest.approx(
            2 / row["ms_per_batch"] * 1000, rel=1e-2)
    assert ours["bf16_windowed"]["compute_dtype"] == "bfloat16"
    assert ours["fp32_windowed"]["speedup_vs_fp32"] == 1.0
    for key, value in theirs["fp32_windowed"]["test"].items():
        assert ours["fp32_windowed"]["test"][key] == pytest.approx(value, abs=MAP_ATOL), key
    with pytest.raises(FileNotFoundError, match="train800 first"):
        detector_infer800.main(["--root", str(tmp_path / "none"), "--device", "cpu"])


TRANSFER_CONFIG = dict(GEOMETRY["native"], **{**WIDTHS, "backbone_norm": "frozen"})


def test_transfer_demo_datasets_and_results(tmp_path):
    """The demo at TINY width (frozen BN, as its config) for 1 + 1 epochs,
    each set cut to 4 videos: its rendered sets are JAX's `build_dataset`'s
    byte for byte; the fine-tune from the saved `.pth` starts from the
    pretrained weights."""
    jax_ds = jax_td.build_dataset(tmp_path / "jax", "finetune_eval", 4, seed=300)
    with pytest.MonkeyPatch.context() as mp:
        # the pretraining set cut from 24 videos to 4: the demo's other two
        # sets are of 8 and 4 (also cut to 4)
        build = detector_transfer_demo.build_dataset
        mp.setattr(detector_transfer_demo, "build_dataset",
                   lambda root, tag, num_videos, seed: build(root, tag, min(num_videos, 4), seed))
        mp.setattr(detector_transfer_demo, "detector_config", lambda bf16: DetectorConfig(
            **TRANSFER_CONFIG, compute_dtype="bfloat16" if bf16 else "float32"))
        starts = []
        real = detector_transfer_demo.train_detector

        def spy(*args, **kwargs):
            starts.append(kwargs.get("init_params"))
            return real(*args, **kwargs)

        mp.setattr(detector_transfer_demo, "train_detector", spy)
        run_quiet(detector_transfer_demo.main, ["--root", str(tmp_path / "port"),
                                                "--pretrain-epochs", "1",
                                                "--finetune-epochs", "1", "--device", "cpu"])
    port_ds = files(tmp_path / "port" / "finetune_eval")
    assert port_ds == files(tmp_path / "jax" / "finetune_eval") and len(jax_ds) == 4 * 6
    results = json.loads((tmp_path / "port" / "results.json").read_text())
    assert set(results) == {"from_pretrained", "from_scratch"}
    for r in results.values():
        assert set(r) == {"best_map", "history"} and len(r["history"]) == 1
        assert {"epoch", "train_loss", "mAP", "AP50", "AP75"} <= set(r["history"][0])
    pretrained = torch.load(tmp_path / "port" / "pretrained.pth")["model_state_dict"]
    assert starts[0] is None and starts[2] is None
    assert set(starts[1]) == set(pretrained)
    for key, value in pretrained.items():
        assert torch.equal(starts[1][key].cpu(), value), key


def test_export_round_trip_and_jax_export(tmp_path):
    jax_cfg = jax_config(**TRANSFER_CONFIG)
    params, state_dict = jax_init(jax_cfg, seed=3)
    model = Detector(DetectorConfig(**TRANSFER_CONFIG))
    model.load_state_dict(state_dict)
    exported = export_torchvision_state_dict(model)
    assert exported.keys() == export_torchvision_state_dict(model.state_dict()).keys()
    want = jax_export_torchvision_state_dict(params, layers=jax_cfg.backbone_layers)
    assert list(exported) == list(model.state_dict()) and set(exported) == set(want)
    for key, value in want.items():
        assert isinstance(exported[key], np.ndarray) and exported[key].dtype == value.dtype
        np.testing.assert_array_equal(exported[key], value, err_msg=key)
    path = tmp_path / "pretrained.pth"
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in exported.items()}}, path)
    loaded = CaterDetector.load(str(path), DetectorConfig(**TRANSFER_CONFIG), device="cpu")
    for key, value in model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value), key
    # the exported arrays are copies: changing them leaves the model as it was
    exported["backbone.body.conv1.weight"][:] = 0
    assert model.state_dict()["backbone.body.conv1.weight"].abs().sum() > 0
