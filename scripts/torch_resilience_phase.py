"""Run ``chip_smoke.py``'s phases 16 (model parallelism finished) and 17
(the fault-tolerant runtime) alone on one card (``16c``: phase 16's
captured TP and PP steps only).

    python3 scripts/torch_resilience_phase.py [--phases 16 17]
    python3 scripts/torch_resilience_phase.py --phases 16c

Builds every kernel, runs the phases in the order given (with 16 and
17 both, 17's process-bound checks start beside 16, as in the smoke),
prints their rows, each phase's seconds and the card's name and power limit; exits 1
without CUDA and fails as a phase fails.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", nargs="+", default=["16", "17"],
                    choices=["16", "16c", "17"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_resilience_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    device = torch.device("cuda", 0)
    tmp = started = None
    for phase in args.phases:
        if phase == "16":
            if "17" in args.phases:
                tmp = tempfile.mkdtemp(prefix="resilience_")
                started = cs.resilience_processes(tmp)
            out = cs._timed("16", cs.mp2_phase, device, smi)
        elif phase == "16c":
            out = cs._timed("16c", cs._mp2_captured, device)
        else:
            out = cs._timed("17", cs.resilience_phase, device,
                            torch.Generator().manual_seed(17), smi, tmp,
                            started)
        print(json.dumps({"phase": phase, "launches": out}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
