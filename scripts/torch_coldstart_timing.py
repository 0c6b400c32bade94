"""Time cold and warm boots of each of the cold-start worker's modes
(``aot/coldstart.py``: ``serve``, ``lm``, ``train``) on one card.

    python3 scripts/torch_coldstart_timing.py [--modes serve lm train]

For each mode: one fresh process against an empty AOT store and an empty
kernel build directory (cold: the boot builds its libraries with ``nvcc``
and banks them), then one against the store it filled and another empty
build directory (warm: the libraries come from the store). The
artifacts are the smoke's widths with random weights: ``bnn-mlp-large``
served at a micro-batch of 32, phase 5's LM (4 slots, pages of 16), and
``bnn-mlp-large``'s ``pallas_xnor`` train step at batch 64. Prints each
boot's JSON record with its split and the process's seconds, then the
card's name and power limit. Exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _artifacts(tmp: str):
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model

    gen = torch.Generator().manual_seed(0)
    cls = os.path.join(tmp, "cls.msgpack")
    export_packed(get_model("bnn-mlp-large", backend="xla",
                            generator=gen).eval(), cls)
    lm, _ = cs._lm_artifact(gen, tmp)
    return cls, lm


def _boot(mode: str, argv: list, store: str, kdir: str) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.aot."
         "coldstart", "--mode", mode, "--store", store, *argv],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, JG_KERNEL_DIR=kdir))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(
            f"{mode}: exit {out.returncode}\n{out.stderr[-3000:]}")
    rows = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    split = next(r["coldstart_split"] for r in rows if "coldstart_split" in r)
    return {**rows[-1], "split": split, "process_s": wall}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--modes", nargs="+", default=["serve", "lm", "train"])
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_coldstart_timing: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as tmp:
        cls, lm = _artifacts(tmp)
        argv = {
            "serve": ["--artifact", cls, "--batch-size", "32"],
            "lm": ["--artifact", lm, "--slots", "4", "--page-size", "16"],
            "train": ["--model", "bnn-mlp-large", "--backend",
                      "pallas_xnor", "--train-batch-size", "64"],
        }
        for mode in args.modes:
            store = os.path.join(tmp, f"store_{mode}")
            for phase in ("cold", "warm"):
                row = _boot(mode, argv[mode], store,
                            os.path.join(tmp, f"k_{mode}_{phase}"))
                print(json.dumps({"boot": phase, "card": smi, **row}),
                      flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
