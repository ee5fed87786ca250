"""Route-balance report for a trained opnet_moe checkpoint, the counterpart
of `scripts/moe_balance.py`.

Loads the best sweep checkpoint, recomputes the MoE head's router decisions
over the held-out test split, and prints the expert usage histogram +
mean gate probability — evidence the Switch-style top-1 router learned a
non-collapsed routing (a collapsed router sends ~100% of frames to one
expert).

    python -m objectpermanence_tpu_torch.experiments.moe_balance \
        --root data/sim4k --sweep-dir sweep_160ep_800

The forward runs on the card without gradients, so its two LSTMs run on
the forward kernel that emits h only (K4); `--device cpu` runs it on the
CPU.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from objectpermanence_tpu_torch import resolve_device
from objectpermanence_tpu_torch.config import load_model_config
from objectpermanence_tpu_torch.data.ingest import ingest_directory
from objectpermanence_tpu_torch.models.registry import init_model
from objectpermanence_tpu_torch.utils.checkpoint import best_params_checkpoint


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=Path("data/sim4k"))
    ap.add_argument("--sweep-dir", default="sweep_160ep_800")
    ap.add_argument("--ckpt-dir", type=Path, default=None,
                    help="explicit checkpoint tree (default: sweep layout)")
    ap.add_argument("--src", type=Path, default=None,
                    help="where test labels/annotations live (default: --root)")
    ap.add_argument("--perception", default="od_perception",
                    help="test perception dir name (od_real for two-stage)")
    ap.add_argument("--batch", type=int, default=300)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the forward runs (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    config = load_model_config("opnet")
    ckpt_dir = args.ckpt_dir or args.root / args.sweep_dir / "opnet_moe" / "opnet_moe"
    best = best_params_checkpoint(ckpt_dir)
    if best is None:
        sys.exit(f"no trained opnet_moe checkpoint under {ckpt_dir}")
    spec, model = init_model("opnet_moe", config, checkpoint_path=best, device=device)

    src = args.src or args.root
    ds = ingest_directory(args.root / "test" / args.perception,
                          src / "test" / "labels",
                          spec.feature_width,
                          src / "test" / "annotations" / "containment_annotations.txt",
                          str(args.root / "cache"))

    num_experts = model.box_head.w1.shape[0]
    counts = np.zeros(num_experts, np.int64)
    gate_sum = 0.0
    gate_n = 0
    with torch.no_grad():
        for i in range(0, len(ds), args.batch):
            boxes = torch.from_numpy(ds.boxes[i:i + args.batch]).to(device)
            _, _, probs = model.forward_layers(boxes, return_probs=True)
            # models/moe.py::moe_route's decision: the top-1 expert, its probability
            top1, gate = probs.argmax(dim=-1), probs.max(dim=-1).values
            counts += np.bincount(top1.cpu().numpy().ravel(), minlength=num_experts)
            gate = gate.cpu().numpy()
            gate_sum += float(gate.sum())      # token-weighted: the ragged final
            gate_n += gate.size                # batch counts by its actual size

    frac = counts / counts.sum()
    report = {
        "checkpoint": str(best),
        "videos": len(ds),
        "expert_fraction": [round(float(f), 4) for f in frac],
        "max_expert_fraction": round(float(frac.max()), 4),
        "mean_gate_prob": round(gate_sum / gate_n, 4),
    }
    out = (args.ckpt_dir.parent if args.ckpt_dir
           else args.root / args.sweep_dir) / "moe_balance.json"
    out.write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
