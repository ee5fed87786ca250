"""The benchmark of objectpermanence_tpu_torch on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from `BENCHMARK.json` at the checkout's root:

- `configs/<config>.json`: the configuration's widths, source and `assumed`;
- `models/<config>.py`: its adapter (the port's model with the benchmark's
  weights, the forward FLOPs a frame, its LSTMs) and `reference/<config>.py`,
  its plain PyTorch reference, which imports nothing of the port;
- `traffic/<mix>.json`: a traffic mix, whose `kind` names the driver
  `kinds/<kind>.py` that generates it, times it and judges its outputs;
- `limits/<cell>.json`: the limits of the numbers that decide `correct`;
- `metrics/<metric>.py`: one reader for each metric of the manifest.

Nothing here imports jax or the JAX package, and nothing reads the repo's
other benchmark scripts: what the benchmark took from them is a frozen copy.
"""
