"""Static analysis and runtime checks of the port (the JAX package's
``analysis/``):

* ``analysis.lint`` — the AST linter (``cli lint``): the JAX package's
  rule IDs, each carried over (JG005, the concurrency pack JG007-JG011,
  the event-schema contracts JG017/JG018), given a torch counterpart
  (JG001 host syncs in a captured region, JG002 draws from torch's
  global generator, JG012/JG014 rank-dependent ``torch.distributed``
  collectives) or registered as not applicable with its reason.

* ``analysis.guards`` — the runtime sanitizers: a recompile fence over
  CUDA-graph captures and kernel builds, a transfer guard over the
  fenced dispatch's inputs, and a NaN/inf fence on the loss.
  ``TrainConfig.sanitize`` and the ``JG_SANITIZE`` environment variable
  arm them.

* ``analysis.sched`` — the concurrency pack's runtime half: the lock →
  attribute trace recorder and the seeded cooperative scheduler (the
  JAX package's, interleaving for interleaving).

* ``analysis.spmd`` — the lockstep checker over ``torch.distributed``:
  each simulated rank's collective schedule, recorded with the
  collectives stubbed, and the first divergent index when two differ;
  ``verify_shipped`` holds the port's exchanges to it (``cli lint
  --spmd``).
"""

from .guards import (
    NaNFenceError,
    RecompileFenceError,
    Sanitizer,
    SanitizerConfig,
    SanitizerError,
    TransferGuardError,
)
from .sched import (
    CoopScheduler,
    DeadlockError,
    InstrumentedCondition,
    InstrumentedLock,
    TraceRecorder,
    watch_attrs,
)
from .spmd import (
    CollectiveOp,
    LockstepError,
    check_lockstep,
    record_schedule,
    run_lockstep,
    run_lockstep_mesh,
    sim_group,
    verify_shipped,
)

__all__ = [
    "CollectiveOp",
    "CoopScheduler",
    "DeadlockError",
    "InstrumentedCondition",
    "InstrumentedLock",
    "LockstepError",
    "NaNFenceError",
    "RecompileFenceError",
    "Sanitizer",
    "SanitizerConfig",
    "SanitizerError",
    "TraceRecorder",
    "TransferGuardError",
    "check_lockstep",
    "record_schedule",
    "run_lockstep",
    "run_lockstep_mesh",
    "sim_group",
    "verify_shipped",
    "watch_attrs",
]
