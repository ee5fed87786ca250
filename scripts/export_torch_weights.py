"""Export a JAX parameter checkpoint (orbax) to the npz that the PyTorch
port loads: an OPNet-family model's, or a SiamRPN tracker's that
`train/siam_loop.py::siam_train_main` saved (`<checkpoint_dir>/final`).

    python scripts/export_torch_weights.py \
        bench_data/checkpoints/opnet/19-08-26_0.514 \
        objectpermanence_tpu_torch/assets/opnet_19-08-26_0.514.npz
    python scripts/export_torch_weights.py --model_type siam \
        <checkpoint_dir>/final <checkpoint_dir_of_the_port>/final.npz

Runs on the CPU. The values cross exactly (`models/convert.py` of the port),
keyed by the port's state_dict names (`att_lstm.w_ih`, ...; the tracker's
`featureExtract.0.weight`, ...). The port's `build_siam_reasoner` loads the
tracker's npz, or the directory that holds it as `final.npz`.
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
from objectpermanence_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, siam_params_from_jax,
)
from objectpermanence_tpu_torch.utils.checkpoint import save_params  # noqa: E402


def export(checkpoint, out, model_type: str = "opnet") -> Path:
    if model_type == "siam":
        from objectpermanence_tpu.models.siam import siam_init
        params = jax.device_get(restore_params(checkpoint, siam_init(jax.random.PRNGKey(0))))
        return save_params(out, siam_params_from_jax(params))
    config = load_model_config(model_type)
    like = get_model_spec(model_type, config).init(jax.random.PRNGKey(0), config)
    params = jax.device_get(restore_params(checkpoint, like))
    return save_params(out, params_from_jax(params))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", help="orbax params checkpoint (a leaf directory)")
    parser.add_argument("out", help="npz file to write")
    parser.add_argument("--model_type", default="opnet",
                        help="a learned model's name, or siam for the SiamRPN tracker")
    args = parser.parse_args(argv)
    print(export(args.checkpoint, args.out, args.model_type))


if __name__ == "__main__":
    main()
