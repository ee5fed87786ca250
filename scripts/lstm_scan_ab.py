"""The LSTM recurrence kernels (K2, K3, K4) and the OPNet train step timed in
two checkouts of the repository on one CUDA card, in turns A, B, B, A, each
turn a process of its own that builds its checkout's kernels: in each turn,
on both flagship layers (att_lstm, H=256; video_lstm, H=512) and on the
inputs `chip_smoke.py` times them on, K2 and K3 at the training batch B=16
and K4 at the shipped eval batch B=400, with cuDNN's forward at B=400 beside
it (CUDA events, mean of 20 calls after warmup; T=300), then the checkout's
`chip_smoke.phase_train_step_profile` (the flagship's full-width train step
at B=16, its `[train_step_profile]` line).

    python3 scripts/lstm_scan_ab.py A_ROOT B_ROOT

Prints each turn's `[lstm_scan_ab]` and `[train_step_profile]` lines, with
the registers nvcc gave the kernels, after its label and checkout.
"""

import subprocess
import sys
from pathlib import Path

PREFIXES = ("[lstm_scan_ab]", "[train_step_profile]")
EVAL_BATCH = 400  # the eval step's batch at the shipped configs/training_config.json


def one_turn(root: Path) -> None:
    """In this process: K3 of `root`'s port at both widths, and its train step."""
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from objectpermanence_tpu_torch.ops import _build
    from objectpermanence_tpu_torch.ops import lstm_scan
    assert Path(chip_smoke.__file__).resolve().parent == root, chip_smoke.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    log = _build.build("lstm_scan")["lstm_scan"].log
    registers = [line.strip() for line in log.splitlines() if "registers" in line]
    weights = chip_smoke.flagship_weights(device)

    def report(kernel, layer, batch, hidden, ms):
        print(f"[lstm_scan_ab] kernel={kernel} layer={layer} batch={batch} "
              f"frames={chip_smoke.FRAMES} hidden={hidden} ms={ms}", flush=True)

    for layer in chip_smoke.LSTM_LAYERS:
        batch = chip_smoke.TRAIN_BATCH
        x, w_ih, w_hh, dout = chip_smoke.lstm_case(layer, batch, weights, device)
        xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
        hs, cs = lstm_scan.lstm_scan_forward(xproj, w_hh)
        h_prev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
        c_prev = torch.cat([torch.zeros_like(cs[:1]), cs[:-1]])
        dh_out = dout.transpose(0, 1).contiguous()
        report("K2", layer, batch, w_hh.shape[0], chip_smoke.time_ms(
            lambda: lstm_scan.lstm_scan_forward(xproj, w_hh), iters=20))
        report("K3", layer, batch, w_hh.shape[0], chip_smoke.time_ms(
            lambda: lstm_scan.lstm_scan_backward(xproj, h_prev, c_prev, cs, dh_out, w_hh),
            iters=20))
        batch = EVAL_BATCH
        x, w_ih, w_hh, _ = chip_smoke.lstm_case(layer, batch, weights, device)
        xproj = torch.matmul(x.transpose(0, 1), w_ih).contiguous()
        report("K4", layer, batch, w_hh.shape[0], chip_smoke.time_ms(
            lambda: lstm_scan.lstm_scan_hs(xproj, w_hh), iters=20))
        cudnn = torch.nn.LSTM(w_ih.shape[0], w_hh.shape[0], bias=False,
                              batch_first=True).to(device)
        with torch.no_grad():
            cudnn.weight_ih_l0.copy_(w_ih.t())
            cudnn.weight_hh_l0.copy_(w_hh.t())

            def cudnn_forward():
                cudnn(x)

            report("cudnn_forward", layer, batch, w_hh.shape[0],
                   chip_smoke.time_ms(cudnn_forward, iters=20))
    chip_smoke.phase_train_step_profile(device)
    print(f"[lstm_scan_ab] registers={registers}", flush=True)


def main() -> int:
    if sys.argv[1] == "--turn":
        one_turn(Path(sys.argv[2]).resolve())
        return 0
    roots = {"A": Path(sys.argv[1]).resolve(), "B": Path(sys.argv[2]).resolve()}
    for label in ("A", "B", "B", "A"):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--turn",
                              str(roots[label])], cwd=roots[label], capture_output=True,
                             text=True, timeout=900)
        lines = [line for line in run.stdout.splitlines() if line.startswith(PREFIXES)]
        print(f"{label} {roots[label]} rc={run.returncode}", *lines, sep="\n", flush=True)
        if run.returncode != 0 or not lines:
            print(run.stdout[-3000:], run.stderr[-3000:], sep="\n", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
