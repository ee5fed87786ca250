"""The port's detector training loop (`train/detector_loop.py`) on the CPU.

A narrow frozen-BN detector (one bottleneck per stage, width 16, FPN 32) on
native 240 x 320 fixture frames (`data/fixtures.py::write_detection_fixture`,
PNGs written here with PIL): `train_detector` for 2 epochs with
evaluation, then `resume=True` to epoch 3. Checked: the history, the
checkpoints it writes (`best_<mAP>.npz`, `final.npz`, only the newest
`resume/epoch_NNNN`), that the resumed run runs epoch 3 only, moves the
params and ends where an uninterrupted 3-epoch run ends, and that
`evaluate_detector` gives the JAX package's mAP on the same weights (the
trained `final.npz` carried into JAX by its own torchvision converter).
"""

import json

import numpy as np
import pytest
import torch

from objectpermanence_tpu_torch.data.detection_dataset import DetectionDataset
from objectpermanence_tpu_torch.data.fixtures import write_detection_fixture
from objectpermanence_tpu_torch.models.detector.detector import CaterDetector, DetectorConfig
from objectpermanence_tpu_torch.train.detector_loop import evaluate_detector, train_detector
from objectpermanence_tpu_torch.utils.checkpoint import load_params

CONFIG = dict(min_size=240, max_size=320, backbone_layers=(1, 1, 1, 1), backbone_width=16,
              fpn_channels=32, rpn_pre_nms_top_n=200, rpn_post_nms_top_n=100,
              detections_per_img=20)
TRAIN = dict(batch_size=3, learning_rate=1e-2, warmup_iters=2, print_step=2, seed=1,
             device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Training on one thread: the narrow net's small ops stall torch's
    thread pool when the lane's workers share the cores (40x slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("det")
    train = DetectionDataset(*write_detection_fixture(root / "train", num_scenes=4, seed=2,
                                                      write_images=True)[:2])
    dev_paths = write_detection_fixture(root / "dev", num_scenes=2, seed=3, write_images=True)[:2]
    return train, DetectionDataset(*dev_paths), dev_paths


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    train, dev, _ = data
    cfg = DetectorConfig(**CONFIG)
    ckpt = tmp_path_factory.mktemp("ckpt")
    first = train_detector(train, dev, cfg, num_epochs=2, checkpoint_dir=str(ckpt), **TRAIN)
    first_final = load_params(ckpt / "final.npz")
    resumed = train_detector(train, dev, cfg, num_epochs=3, checkpoint_dir=str(ckpt), resume=True,
                             **TRAIN)
    straight_dir = tmp_path_factory.mktemp("straight")
    straight = train_detector(train, dev, cfg, num_epochs=3, checkpoint_dir=str(straight_dir),
                              **TRAIN)
    return dict(ckpt=ckpt, first=first, first_final=first_final, resumed=resumed,
                straight=straight, cfg=cfg)


def test_history_and_checkpoints(runs):
    first, resumed, ckpt = runs["first"], runs["resumed"], runs["ckpt"]
    assert [h["epoch"] for h in first["history"]] == [1, 2]
    assert [h["epoch"] for h in resumed["history"]] == [3]   # only the epoch left
    for h in first["history"] + resumed["history"]:
        assert np.isfinite(h["train_loss"]) and len(h["train_losses"]) == 3
        assert set(h) >= {"mAP", "AP50", "AP75"} and 0.0 <= h["mAP"] <= 1.0
    best = sorted(p.name for p in ckpt.glob("best_*.npz"))
    assert best and f"best_{round(first['best_map'], 3)}.npz" in best
    assert resumed["best_map"] >= first["best_map"]
    assert (ckpt / "final.npz").exists()
    kept = sorted(p.name for p in (ckpt / "resume").iterdir())
    assert kept == ["epoch_0003"]                            # only the newest
    meta = json.loads((ckpt / "resume" / "epoch_0003" / "metadata.json").read_text())
    assert meta["epoch"] == 3 and meta["count"] == 9        # 3 steps per epoch, counted on


def test_resumed_run_moves_on_and_ends_where_a_straight_run_ends(runs):
    first_final, resumed, straight = runs["first_final"], runs["resumed"], runs["straight"]
    final = {k: v.detach().cpu() for k, v in resumed["params"].items()}
    moved = [k for k in final if not np.array_equal(final[k].numpy(), first_final[k].numpy())]
    assert len(moved) > 0.9 * len(final)
    for key, value in straight["params"].items():
        np.testing.assert_allclose(final[key].numpy(), value.detach().numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
    for a, b in zip(straight["history"][2]["train_losses"], resumed["history"][0]["train_losses"]):
        assert a == pytest.approx(b, rel=1e-6)


def test_frozen_bn_tensors_are_trained(runs):
    """The JAX package updates frozen BN's four tensors too (they are leaves
    of its param tree); so does the port."""
    final = runs["first_final"]
    init = CaterDetector(runs["cfg"], device="cpu").model.state_dict()
    for name in ("backbone.body.bn1.running_mean", "backbone.body.layer1.0.bn2.running_var",
                 "backbone.body.layer4.0.bn3.weight"):
        assert not np.array_equal(final[name].numpy(), init[name].numpy()), name


def test_evaluate_detector_gives_jax_map(runs, data, tmp_path):
    """Against the fixture's ground truth the 3-epoch net scores 0 (its
    class probabilities stay near 1/193, under the 0.05 score cut), so both
    sides keep every score and the set is relabelled with the net's own
    three best detections per frame, rounded to 0.01 px: a mAP well above
    0 for both."""
    import jax
    from objectpermanence_tpu.data.detection_dataset import DetectionDataset as JaxDataset
    from objectpermanence_tpu.models.detector import detector as jdet
    from objectpermanence_tpu.models.detector.convert import convert_torchvision_state_dict
    from objectpermanence_tpu.train.detector_loop import evaluate_detector as jax_evaluate
    _, dev, (images_dir, _) = data
    final = runs["ckpt"] / "final.npz"
    config = dict(CONFIG, score_thresh=0.0)
    ours_detector = CaterDetector.load(str(final), DetectorConfig(**config), device="cpu")
    rows = ["filename,object_class,X,Y,width,height"]
    for name in dev.filenames:
        boxes, labels, scores, valid = ours_detector(dev.load_image(name)[None])
        for box, label in list(zip(boxes[0][valid[0]], labels[0][valid[0]]))[:3]:
            rows.append(f"{name},{label},{box[0]:.2f},{box[1]:.2f},{box[2] - box[0]:.2f},"
                        f"{box[3] - box[1]:.2f}")
    csv_path = tmp_path / "relabelled.csv"
    csv_path.write_text("\n".join(rows) + "\n")
    assert len(rows) > len(dev.filenames)

    ours = evaluate_detector(ours_detector, DetectionDataset(images_dir, csv_path), batch_size=3)
    state = {k: v.numpy() for k, v in load_params(final).items()}
    params = jax.tree.map(np.asarray, convert_torchvision_state_dict(
        state, layers=CONFIG["backbone_layers"]))
    theirs = jax_evaluate(jdet.CaterDetector(jdet.DetectorConfig(**config), params),
                          JaxDataset(images_dir, csv_path), batch_size=3)
    assert set(ours) == set(theirs) == {"mAP", "AP50", "AP75"}
    assert ours["AP50"] > 0.5
    for key in ours:
        assert ours[key] == pytest.approx(theirs[key], abs=1e-6), key


def test_mesh_runs_at_world_two(data, tmp_path):
    """`train_detector(mesh=make_mesh())` in two gloo ranks on the CPU: the
    batch of 3 rounds up to 4, each rank trains 2 images of every batch,
    rank 0 evaluates and writes the checkpoints, and both ranks end with the
    same history (losses, mAP) and the same params."""
    from torch_dp_workers import detector_mesh_run, spawn

    train, _, (dev_images, dev_csv) = data
    train_paths = (str(train.images_dir), str(train.images_dir.parent / "detection_annotations.csv"))
    spawn(detector_mesh_run, 2, tmp_path, str(tmp_path), train_paths,
          (str(dev_images), str(dev_csv)), CONFIG, timeout=300)
    histories = [json.loads((tmp_path / f"history_rank{r}.json").read_text()) for r in (0, 1)]
    assert histories[0] == histories[1]
    (epoch,) = histories[0]
    assert epoch["epoch"] == 1 and len(epoch["train_losses"]) == 2  # 8 frames, batches of 4
    assert np.all(np.isfinite(epoch["train_losses"])) and 0.0 <= epoch["mAP"] <= 1.0
    finals = [np.load(tmp_path / f"final_rank{r}.npz") for r in (0, 1)]
    for key in finals[0].files:
        np.testing.assert_array_equal(finals[0][key], finals[1][key], err_msg=key)
    assert (tmp_path / "ckpt" / "final.npz").exists()
    assert len(list((tmp_path / "ckpt").glob("best_*.npz"))) == 1
