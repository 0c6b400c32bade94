"""AverageMeter: a running val/sum/count/avg accumulator, parity with the
reference's utils.py:86-102 (used for per-batch wall-time accounting in the
flagship loop, mnist-dist2.py:115,139-140)."""

from __future__ import annotations


class AverageMeter:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __repr__(self) -> str:  # pragma: no cover
        return f"AverageMeter(val={self.val:.6g}, avg={self.avg:.6g}, n={self.count})"
