"""``run_with_recovery``: the JAX package's compat shim over
``resilience.policy.run_with_policy``.

The reference's only recovery is "checkpoint on one machine, resume by
hand on another" (mnist change node.py:85-90 -> mnist change
master.py:56-59). This loop automates it: run the training closure, and
on a failure rebuild the trainer (which, with ``TrainConfig.resume``,
restores the newest verified checkpoint generation) and retry.
"""

from __future__ import annotations

from typing import Callable, TypeVar

from ..resilience.policy import RetryPolicy, TrainingFailure, run_with_policy

T = TypeVar("T")

__all__ = ["TrainingFailure", "run_with_recovery"]


def run_with_recovery(make_trainer: Callable[[], object],
                      run: Callable[[object], T], *, max_restarts: int = 2,
                      backoff_s: float = 1.0) -> T:
    """``run(make_trainer())`` with restart-from-latest retries:
    ``backoff_s`` is the base of a jittered exponential backoff, and fatal
    failures (config or programming errors, a missing dataset) are not
    retried."""
    policy = RetryPolicy(max_restarts=max_restarts, base_backoff_s=backoff_s)
    return run_with_policy(make_trainer, run, policy=policy)
