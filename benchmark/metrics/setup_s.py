"""Seconds from the process's start to the window's first call: imports,
the kernels' load (their build in a fresh checkout), weights, inputs and
warm-up (a train cell's first steps)."""


def read(run):
    return run.setup_s
