"""Time the port's MLP training step on the host clock in one process,
before and after each piece of work that ``chip_smoke.py`` does ahead of
its phase 8, to find what in the smoke slows the step.

    python scripts/torch_mlp_train_timing.py [--steps N] [--after LIST]

The step is ``chip_smoke.py``'s flagship (``bnn-mlp-large``, batch 64,
Adam 0.01, bf16, dropout 0.3) on seed 0's synthetic MNIST, driven
through ``Trainer.train_epoch`` on the first ``--steps`` batches, as the
smoke's epoch is (batch order, host copies and logging included).
``--after`` lists, in order, what runs between two measurements:

  * ``profiler``: one ``torch.profiler`` session over 20 train steps (the
    smoke's ``_profile_device_ms``);
  * ``gc``: ``gc.collect()`` then ``gc.freeze()``;
  * ``none``: nothing (the measurement's own spread);
  * a phase of ``chip_smoke.py`` run as its ``main`` runs it: ``xnor``,
    ``xnor_sign``, ``xnor_affine`` (``kernel_phase``), ``unpack``,
    ``paged``, ``slice``, ``lm_slice``, ``flash``, ``lm_train``.

Prints one JSON line per measurement, each with the card's name and
power limit: ``after`` (what has run so far), ``step_ms`` (host-clock
time of one step, the epoch ending in ``torch.cuda.synchronize()``),
``launch_us`` (host-clock time of one launch of an in-place add on a
one-element tensor, over 4000 launches ending in a synchronize), the
live Python threads and the objects the garbage collector tracks.

Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("xnor", "xnor_sign", "xnor_affine", "unpack", "paged", "slice",
          "lm_slice", "flash", "lm_train")


def launch_us(device: torch.device, n: int = 4000) -> float:
    x = torch.zeros(1, device=device)
    for _ in range(100):
        x.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def run_phase(cs, name: str, device: torch.device, gen: torch.Generator):
    if name in ("xnor", "xnor_sign", "xnor_affine"):
        cs.kernel_phase(name, device, gen)
    else:
        getattr(cs, f"{name}_phase")(device, gen)
    torch.cuda.synchronize()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--after", default=",".join(("profiler",) + PHASES
                                                + ("gc",)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mlp_train_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    _kernels.build()
    gen = torch.Generator().manual_seed(0)
    bs = cs.MLP_TRAIN["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=cs.MLP_SYNTH, seed=0)
    data = cs._first_steps(data, args.steps, bs)
    tr = cs._mlp_trainer(device)
    tr.train_epoch(data, 0)                          # warm-up
    done = []

    def measure():
        row = tr.train_epoch(data, 0)
        print(json.dumps({
            "after": list(done), "step_ms": row["batch_time_s"] * 1e3,
            "steps": row["steps"], "launch_us": launch_us(device),
            "threads": threading.active_count(),
            "gc_tracked": len(gc.get_objects()), "card": smi}), flush=True)

    measure()
    for what in [a for a in args.after.split(",") if a]:
        if what == "profiler":
            x = torch.from_numpy(data.train_images[:bs]).to(device)
            y = torch.from_numpy(
                data.train_labels[:bs].astype("int64")).to(device)
            cs._profile_device_ms(
                lambda: tr.train_step(tr.model, tr.optimizer, x, y),
                calls=20)
        elif what == "gc":
            gc.collect()
            gc.freeze()
        elif what == "none":
            pass
        elif what in PHASES:
            run_phase(cs, what, device, gen)
        else:
            raise SystemExit(f"unknown --after item {what!r}")
        done.append(what)
        measure()
    return 0


if __name__ == "__main__":
    sys.exit(main())
