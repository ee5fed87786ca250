"""Export a JAX OPNet-family parameter checkpoint (orbax) to the npz that
the PyTorch port loads.

    python scripts/export_torch_weights.py \
        bench_data/checkpoints/opnet/19-08-26_0.514 \
        objectpermanence_tpu_torch/assets/opnet_19-08-26_0.514.npz

Runs on the CPU. The values cross exactly (`models/convert.py` of the port),
keyed by the port's state_dict names (`att_lstm.w_ih`, ...).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from objectpermanence_tpu.config import load_model_config  # noqa: E402
from objectpermanence_tpu.models.registry import get_model_spec  # noqa: E402
from objectpermanence_tpu.utils.checkpoint import restore_params  # noqa: E402
from objectpermanence_tpu_torch.models.convert import params_from_jax  # noqa: E402
from objectpermanence_tpu_torch.utils.checkpoint import save_params  # noqa: E402


def export(checkpoint, out, model_type: str = "opnet") -> Path:
    config = load_model_config(model_type)
    like = get_model_spec(model_type, config).init(jax.random.PRNGKey(0), config)
    params = jax.device_get(restore_params(checkpoint, like))
    return save_params(out, params_from_jax(params))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", help="orbax params checkpoint (a leaf directory)")
    parser.add_argument("out", help="npz file to write")
    parser.add_argument("--model_type", default="opnet")
    args = parser.parse_args(argv)
    print(export(args.checkpoint, args.out, args.model_type))


if __name__ == "__main__":
    main()
