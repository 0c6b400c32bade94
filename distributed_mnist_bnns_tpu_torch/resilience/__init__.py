from .policy import (
    CircuitBreaker,
    RetryPolicy,
    TrainingFailure,
    classify_failure,
    handle_failure,
    handle_preemption,
    run_with_policy,
)
from .preempt import PREEMPT_EXIT_CODE, Preempted, StopRequest

__all__ = [
    "CircuitBreaker",
    "PREEMPT_EXIT_CODE",
    "Preempted",
    "RetryPolicy",
    "StopRequest",
    "TrainingFailure",
    "classify_failure",
    "handle_failure",
    "handle_preemption",
    "run_with_policy",
]
