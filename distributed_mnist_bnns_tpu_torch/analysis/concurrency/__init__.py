"""Concurrency lint rules (JG007-JG011) — see rules.py.

The rules plug into the ``analysis/lint`` engine through the shared
``RULES`` registry (lint/rules.py imports this package); the runtime
half — instrumented locks + the seeded interleaving scheduler — lives
in ``analysis/sched.py``.
"""

# the engine first: its registry imports these rules, and they import
# the engine's core (imported here first, the cycle is never entered
# halfway)
from .. import lint  # noqa: F401
from .rules import (
    ClassLockInfo,
    check_blocking_in_lock,
    check_callback_in_lock,
    check_check_then_act,
    check_lock_discipline,
    check_wait_predicate,
)

__all__ = [
    "ClassLockInfo",
    "check_blocking_in_lock",
    "check_callback_in_lock",
    "check_check_then_act",
    "check_lock_discipline",
    "check_wait_predicate",
]
