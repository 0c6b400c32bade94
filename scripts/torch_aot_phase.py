"""Run ``chip_smoke.py``'s phase 22 (the AOT store: a cold process banks
the classifier, LM and train-step kernel libraries; a process that
cannot find ``nvcc`` boots both servers and the train step from the
store, bitwise the same without it; corrupt entries quarantined and
rebuilt; the cold-start records; the demos and the accuracy report)
alone on one card.

    python3 scripts/torch_aot_phase.py

Builds every kernel, runs the demos in ``DP_GLOO_RANKS`` gloo ranks
sharing the card (the smoke runs them in phase 9's ranks), then the
phase; prints its rows, its seconds, the launch counts of its paths and
the card's name and power limit. Exits 1 without CUDA and fails as the
phase fails.
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
        print("torch_aot_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.examples import demos
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    cs._time_processes()
    t0 = time.perf_counter()
    print(json.dumps({"build_s": _kernels.build(),
                      "s": time.perf_counter() - t0}), flush=True)
    cs.DEMO_LOSSES[:] = spawn(demos.run_all, cs.DP_GLOO_RANKS,
                              backend="gloo", device="cuda",
                              args=(0, None, None, cs.DEMO_KW))
    paths, _ = cs._timed("22", cs.aot_phase, torch.device("cuda", 0),
                         torch.Generator().manual_seed(22), smi)
    print(json.dumps({"phase": 22, "launches": paths}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
