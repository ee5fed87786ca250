"""The experiment drivers, the counterparts of the JAX package's scripts,
one module each under the same name: on the reasoning side
`scripts/containment_run.py`, `variant_sweep.py`, `cater_grid_run.py`,
`unbiased_eval.py`, `make_unbsub.py` and `moe_balance.py`; on the perception
and tracker side `two_stage_run.py`, `detector_800px_run.py`,
`detector_infer800.py`, `detector_transfer_demo.py`, `tracker_benchmark.py`
and `siam_run.py`:

    python -m objectpermanence_tpu_torch.experiments.<name> --help

Each keeps its script's flags, stage functions and file layout, so a
dataset root that either package generated serves both. Training and
inference run on the CUDA card; `--device cpu` runs them on the CPU.
Importing a driver does no work that needs data.
"""
