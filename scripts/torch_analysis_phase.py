"""Run ``chip_smoke.py``'s phase 23 (the analyses: ``cli lint`` over the
package, and the lockstep check of the collective exchanges with their
tensors on the card, its divergence mutant caught at its index) alone
on one card.

    python3 scripts/torch_analysis_phase.py

Builds no kernel (the phase launches none); prints the phase's row, its
seconds and the card's name and power limit; exits 1 without CUDA and
fails as the phase fails.
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_analysis_phase: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    cs._timed("23", cs.analysis_phase, torch.device("cuda", 0), smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
