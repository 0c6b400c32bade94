"""Run ``chip_smoke.py``'s phase 20 (the XNOR-ResNet family: K1 and K2 at
the family's shapes; xnor-resnet18 trained with augmentation, eager,
twice and captured, frozen and served; xnor-resnet50 trained, frozen and
served through K1 and K2; ``fit_stream``; ``cli train --dataset cifar10
--augment``) alone on one card.

    python3 scripts/torch_resnet_phase.py

Builds every kernel, runs the phase, prints its rows, its seconds and
the card's name and power limit; exits 1 without CUDA and fails as the
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
        print("torch_resnet_phase: no CUDA device", file=sys.stderr)
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
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = None
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "pil": pil}), flush=True)
    cs._time_processes()
    t0 = time.perf_counter()
    _kernels.build()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    paths, _ = cs._timed(
        "20", cs.resnet_phase, torch.device("cuda", 0),
        torch.Generator().manual_seed(20))
    print(json.dumps({"phase": 20, "launches": paths}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
