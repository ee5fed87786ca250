"""Train SiamRPN on rendered scenes, then re-run the OPE benchmark, on the
port: the counterpart of `scripts/siam_run.py`.

The upstream `SiamRPNVOT.model` blob is absent from the reference snapshot,
so the tracker has only random weights. This trains the same net on
renderer-domain template/search pairs (`train/siam_loop.py`) and re-scores
the programmed-baseline comparison on a rendered video set.

    python -m objectpermanence_tpu_torch.experiments.siam_run data     # build the pair npz (host)
    python -m objectpermanence_tpu_torch.experiments.siam_run train    # train (the card)
    python -m objectpermanence_tpu_torch.experiments.siam_run bench    # OPE on the test render set

`bench` runs `objectpermanence_tpu_torch.experiments.tracker_benchmark` in
this process with the trained `checkpoint/final.npz`. `--device cpu` runs
`train` and `bench` on the CPU.
"""

import argparse
from pathlib import Path

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.experiments import tracker_benchmark
from objectpermanence_tpu_torch.train.siam_loop import build_pair_dataset, siam_train_main


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["data", "train", "bench", "all"])
    ap.add_argument("--root", type=Path, default=Path("data/siam"))
    ap.add_argument("--train-src", type=Path, default=Path("data/sim2k/train"))
    ap.add_argument("--train-videos", type=Path,
                    default=Path("data/twostage/train/videos"))
    ap.add_argument("--bench-src", type=Path, default=Path("data/sim2k/test"))
    ap.add_argument("--bench-videos", type=Path,
                    default=Path("data/twostage/test/videos"))
    ap.add_argument("--pairs", type=int, default=4000)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--bench-limit", type=int, default=120)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where train and bench run (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device) if args.stage != "data" else None
    args.root.mkdir(parents=True, exist_ok=True)
    pairs_npz = args.root / "pairs.npz"

    if args.stage in ("data", "all"):
        build_pair_dataset(args.train_videos, args.train_src / "scenes",
                           args.train_src / "labels", pairs_npz,
                           num_pairs=args.pairs)

    if args.stage in ("train", "all"):
        result = siam_train_main(pairs_npz, args.root / "checkpoint",
                                 num_epochs=args.epochs,
                                 batch_size=args.batch,
                                 learning_rate=args.lr, device=device)
        print(f"[siam] final holdout: {result['history'][-1]}", flush=True)

    if args.stage in ("bench", "all"):
        bench = ["--root", str(args.root / "ope"),
                 "--weights", str(args.root / "checkpoint" / "final.npz"),
                 "--existing-src", str(args.bench_src),
                 "--existing-videos", str(args.bench_videos),
                 "--limit", str(args.bench_limit), "--device", device.type]
        print("[siam] running: tracker_benchmark", " ".join(bench), flush=True)
        tracker_benchmark.main(bench)


if __name__ == "__main__":
    main()
