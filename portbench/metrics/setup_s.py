"""Set-up: process start to the first timed call (imports, CUDA start,
kernel build or load, the seeded state and inputs, the warm-up)."""


def read(run):
    return run.setup_s
