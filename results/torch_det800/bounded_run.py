"""The bounded 800 px detector run of the PyTorch/CUDA port on one CUDA card,
through the port's experiment drivers: the counterpart of `results/det800/`
(the JAX package's run).

    python3 results/torch_det800/bounded_run.py --src build/torch_twostage/src \
        [--root build/torch_det800] [--out results/torch_det800]

On a `containment_run datagen` root (`--src`; `results/torch_twostage/
bounded_run.py` makes one: 300 train / 100 dev / 200 test scenes):
1. `detector_800px_run render --det-samples 4` (frames only);
2. `steptime` (30 steps a row after 3 of warmup, CUDA events);
3. `train800 --compute-dtype bfloat16` (800 x 1088 padded, windowed
   RoIAlign, GroupNorm ResNet-50 FPN 256, RPN 500/300, batch 4, lr 5e-3,
   12 epochs), then `native` (240 x 320, batch 8, 12 epochs, float32);
4. `contract` on the train800 checkpoint;
5. `detector_infer800` over its six configs on that checkpoint.

Each stage runs through its driver's `main()` in this process, so that the
port's kernel wrappers' launch counts can be read around it. Writes to
`--out`: `report_800px_bf16.json`, `report_native_control.json` (their
histories without the per-step losses), `steptime.json`, `infer800.json`
and `run.json`: the card's name and power limit as `nvidia-smi` gives them,
each stage's wall seconds and launches by kernel. Needs the card; imports
nothing of JAX.
"""

import argparse
import importlib.util
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
# the two-stage runner's `card` and `stage`
_spec = importlib.util.spec_from_file_location(
    "torch_twostage_bounded_run", REPO / "results" / "torch_twostage" / "bounded_run.py")
_twostage = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_twostage)
card, stage = _twostage.card, _twostage.stage

DET_SAMPLES, EPOCHS, STEPS = 4, 12, 30


def main(argv=None) -> None:
    from objectpermanence_tpu_torch.experiments import detector_800px_run, detector_infer800

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, required=True)
    ap.add_argument("--root", type=Path, default=REPO / "build" / "torch_det800")
    ap.add_argument("--out", type=Path, default=REPO / "results" / "torch_det800")
    args = ap.parse_args(argv)
    src, root, out = args.src.resolve(), args.root.resolve(), args.out.resolve()
    out.mkdir(parents=True, exist_ok=True)
    smi = card()
    print(smi, flush=True)

    stages = {}
    common = ["--root", root, "--src", src]
    stage(stages, "render", detector_800px_run.main, "render", *common,
          "--det-samples", DET_SAMPLES)
    stage(stages, "steptime", detector_800px_run.main, "steptime", *common, "--steps", STEPS)
    stage(stages, "train800_bf16", detector_800px_run.main, "train800", *common,
          "--epochs", EPOCHS, "--compute-dtype", "bfloat16")
    stage(stages, "native", detector_800px_run.main, "native", *common, "--epochs", EPOCHS)
    stage(stages, "contract", detector_800px_run.main, "contract", *common)
    stage(stages, "infer800", detector_infer800.main, "--root", root)

    reports = {}
    for tag, name in (("det800", "report_800px_bf16.json"),
                      ("detnative", "report_native_control.json")):
        report = json.loads((root / tag / "report.json").read_text())
        for epoch in report["history"]:
            epoch.pop("train_losses", None)
        (out / name).write_text(json.dumps(report, indent=2) + "\n")
        reports[tag] = {k: report[k] for k in report if k not in ("history", "checkpoint")}
    shutil.copy(root / "steptime.json", out / "steptime.json")
    shutil.copy(root / "infer800.json", out / "infer800.json")
    run = {"card": smi, "card_at_end": card(), "det_samples": DET_SAMPLES, "epochs": EPOCHS,
           "steps": STEPS, "frames": {s: len(list((root / s / "det_images").glob("*.png")))
                                      for s in ("train", "dev", "test")},
           "stages": stages, "reports": reports}
    (out / "run.json").write_text(json.dumps(run, indent=2) + "\n")
    print(json.dumps(run), flush=True)


if __name__ == "__main__":
    main()
