"""setup_s: from the process's start (procfs) to the window's first
submit: ``import torch``, the runner's build (kernel cache, CUDA context),
the pool's generation and the warm-up submits."""


def read(record):
    return record["setup_s"]
