"""Bounded uniform-planner subset for the UNBIASED two-stage run, the
counterpart of `scripts/make_unbsub.py`.

The full unbiased dataset (`containment_run --uniform-planner`) is 3,200
train videos — rendering + preprocessing all of them through the real
detector is more than a bounded run affords, so the reference-faithful
pixels-to-analysis run uses a bounded subset: the first N train / M dev
scenes (deterministic name-order prefix, the convention of
`two_stage_run.py preprocess --limit`) and the FULL test split (held-out
metrics stay comparable across budgets).

Scenes/labels are symlinked (cheap, and provably identical to the parent
dataset); per-split annotation files are re-derived over the subset with
the same generator (`datagen/scene_labels.write_annotation_files`).

    python -m objectpermanence_tpu_torch.experiments.make_unbsub \
        --src data/unb --out data/unbsub --train 400 --dev 100

Host only: files and links.
"""

import argparse
from pathlib import Path

from objectpermanence_tpu_torch.datagen import scene_labels


def subset_split(src_split: Path, out_split: Path, n: int) -> None:
    scenes = sorted((src_split / "scenes").glob("*.json"))[:n]
    if len(scenes) < n:
        raise SystemExit(f"{src_split}: only {len(scenes)} scenes, need {n}")
    (out_split / "scenes").mkdir(parents=True, exist_ok=True)
    (out_split / "labels").mkdir(parents=True, exist_ok=True)
    for scene in scenes:
        for src, dst_dir in ((scene, out_split / "scenes"),
                             (src_split / "labels" / f"{scene.stem}_bb.json",
                              out_split / "labels")):
            dst = dst_dir / src.name
            if not dst.exists():
                dst.symlink_to(src)
    scene_labels.write_annotation_files(out_split / "scenes",
                                        out_split / "annotations")
    # visible-frames mask source for `*_no_labels` training
    # (data/ingest.training_mask_file): the parent's od_perception dir is
    # keyed by video name, so entries beyond the subset are never read
    perception = out_split / "od_perception"
    if not perception.exists():
        perception.symlink_to(src_split / "od_perception")
    print(f"[unbsub] {out_split.name}: {n} scenes", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=Path("data/unb"))
    ap.add_argument("--out", type=Path, default=Path("data/unbsub"))
    ap.add_argument("--train", type=int, default=400)
    ap.add_argument("--dev", type=int, default=100)
    args = ap.parse_args(argv)
    # the links name their targets by absolute path, so that a relative
    # --src still resolves from inside --out
    args.src = args.src.resolve()

    args.out.mkdir(parents=True, exist_ok=True)
    subset_split(args.src / "train", args.out / "train", args.train)
    subset_split(args.src / "dev", args.out / "dev", args.dev)
    # full test split: symlink the whole directory (scenes, labels,
    # annotations, od_perception incl. the visibility file analyze needs)
    test_link = args.out / "test"
    if not test_link.exists():
        test_link.symlink_to(args.src / "test")
    print(f"[unbsub] test -> {args.src / 'test'} (full split)", flush=True)


if __name__ == "__main__":
    main()
