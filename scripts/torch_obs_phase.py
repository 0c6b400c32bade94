"""Run ``chip_smoke.py``'s phase 15 (observability) in one process, alone
or after some of the smoke's earlier phases, to see whether what ran
before changes what the phase's profile captures hold.

    python scripts/torch_obs_phase.py [--after xnor,scan]

``--after`` lists, in order, what runs before phase 15: ``xnor``,
``xnor_sign``, ``xnor_affine`` (phase 1's kernel checks, each with its
``torch.profiler`` sessions) and ``scan`` (phase 12: the step captured
as CUDA graphs, their replays profiled). Prints the card's name and
power limit, the rows phase 15 prints (each with the process's age and
``capture_clock``'s reading of its profile window), and the seconds
after each part; exits 1 without CUDA and fails as phase 15 fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--after", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_obs_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from distributed_mnist_bnns_tpu_torch.obs import profile  # noqa: F401
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    print(json.dumps({"card": smi, "torch": torch.__version__,
                      "teardown_cupti": os.environ.get("TEARDOWN_CUPTI")}),
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.main
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.build()
    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    for what in [a for a in args.after.split(",") if a]:
        if what in ("xnor", "xnor_sign", "xnor_affine"):
            cs.kernel_phase(what, device, gen)
        elif what == "scan":
            cs.scan_phase(device, smi)
        else:
            raise SystemExit(f"unknown --after item {what!r}")
        torch.cuda.synchronize()
        print(json.dumps({"after": what, "s": time.perf_counter() - t0}),
              flush=True)
    counts, _ = cs.obs_phase(device, torch.Generator().manual_seed(15), smi)
    print(json.dumps({"after": "phase 15", "s": time.perf_counter() - t0,
                      "launches": counts, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
