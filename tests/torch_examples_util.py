"""The rank side of ``tests/test_torch_examples.py``: imports no JAX (the
spawned ranks must not), waits for the JAX toy state the test writes
while the ranks start, then runs the port's three demos on it."""

import os
import pickle
import time


def demos_rank(rank, world, device, path):
    """``examples.demos.run_all`` on the (variables, batches) pickled at
    ``path`` (written atomically by the test once JAX has made them)."""
    import torch

    from distributed_mnist_bnns_tpu_torch.examples import demos

    torch.set_num_threads(1)
    deadline = time.monotonic() + 300
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no toy state at {path}")
        time.sleep(0.05)
    with open(path, "rb") as f:
        variables, batches = pickle.load(f)
    return demos.run_all(rank, world, device, 0, variables, batches,
                         {"dropout_rate": 0.0})
