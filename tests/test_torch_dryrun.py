"""The port's multi-device dry run (`parallel/dryrun.py`), the counterpart of
`__graft_entry__.py::dryrun_multichip`: at 4 gloo ranks on the CPU it runs
every strategy at OPNet's flagship width with JAX's assertions and prints
JAX's closing line, pipeline (4 stages) and expert parallel included; asked
for the card where there is none, it raises rather than run on the CPU."""

import pytest
import torch

from objectpermanence_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_on_four_cpu_ranks_prints_the_ok_line(capsys):
    line = dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip(4): mesh={'data': 2, 'model': 2} loss=")
    assert line.endswith("dp+tp+sp(iou+opnet-fwd)+pp(fwd+train,4stage)+ep(fwd+grad)+fsdp ok")
    assert line in capsys.readouterr().out


@pytest.mark.parametrize("device", [None, "cuda"])
def test_dryrun_raises_without_a_card(device):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(1, device=device)
