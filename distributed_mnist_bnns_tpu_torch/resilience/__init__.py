"""resilience: fault injection, preemption, retry policy and elastic
membership (the JAX package's ``resilience/``).

  chaos      scripted, seed-deterministic fault injection
  preempt    SIGTERM/SIGINT-driven graceful stop at a step boundary, with
             a distinct resumable exit code
  policy     jittered-exponential retry with transient/fatal
             classification and a restart budget, and the serving
             ``CircuitBreaker``
  elastic    data-parallel membership: chaos ``worker_lost`` /
             ``worker_restore`` respawn the ranks at the new world, state
             re-placed from the newest verified checkpoint generation
  multihost  the multihost supervisor: one process a host over the
             ``parallel.hostcomm`` TCP collective, a killed host shrinks
             the world, ``host_restore`` regrows it
"""

from .chaos import (
    HOST_KINDS,
    MEMBERSHIP_KINDS,
    ChaosController,
    ChaosFault,
    ChaosInferError,
    ChaosIOError,
    ChaosStepFault,
    FaultRule,
    parse_chaos_spec,
    reset_fire_counts,
)
from .elastic import MembershipView, run_elastic
from .multihost import (
    HostMembershipView,
    read_membership,
    run_elastic_multihost,
)
from .policy import (
    DEFAULT_FATAL_TYPES,
    CircuitBreaker,
    RetryPolicy,
    TrainingFailure,
    classify_failure,
    handle_failure,
    handle_preemption,
    run_with_policy,
    trainer_topology,
)
from .preempt import PREEMPT_EXIT_CODE, Preempted, StopRequest

__all__ = [
    "HOST_KINDS",
    "MEMBERSHIP_KINDS",
    "ChaosController",
    "ChaosFault",
    "ChaosInferError",
    "ChaosIOError",
    "ChaosStepFault",
    "CircuitBreaker",
    "DEFAULT_FATAL_TYPES",
    "FaultRule",
    "HostMembershipView",
    "MembershipView",
    "PREEMPT_EXIT_CODE",
    "Preempted",
    "RetryPolicy",
    "StopRequest",
    "TrainingFailure",
    "classify_failure",
    "handle_failure",
    "handle_preemption",
    "parse_chaos_spec",
    "read_membership",
    "reset_fire_counts",
    "run_elastic",
    "run_elastic_multihost",
    "run_with_policy",
    "trainer_topology",
]
