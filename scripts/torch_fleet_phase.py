"""Run ``chip_smoke.py``'s phase 21 (the native loaders built and held
bitwise to numpy; a sanitized ``cli train`` and a NaN-fence trip; a
2-replica classifier ``cli fleet`` answering through its router,
replacing a killed replica, rolling a bad artifact back and draining; a
2-replica ``cli fleet --lm`` equal to one engine) alone on one card.

    python3 scripts/torch_fleet_phase.py

Builds every kernel, runs the phase, prints its rows, its seconds, the
replicas' launch counts and the card's name and power limit; exits 1
without CUDA and fails as the phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fleet_phase: no CUDA device", file=sys.stderr)
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
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    cs._time_processes()
    t0 = time.perf_counter()
    _kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    paths, _ = cs._timed("21", cs.fleet_phase, torch.device("cuda", 0),
                         torch.Generator().manual_seed(21))
    print(json.dumps({"phase": 21, "launches": paths}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
