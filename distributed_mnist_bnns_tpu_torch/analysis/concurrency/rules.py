"""Concurrency lint rules JG007-JG011 — lock discipline for the
serving/telemetry stack (the JAX package's
``analysis/concurrency/rules.py``, rule for rule: they read only
``threading`` shapes, so they hold for the port's threaded servers,
fleet, event log and AOT store as they stand).

Every threading bug this repo has shipped (EventLog's unlocked writes,
the drain busy-flag TOCTOU, the submit-vs-``_cancel_all`` stranded
enqueue) was found by a human reviewer; these rules encode the shapes so
the linter finds the next one. Like the JG001-JG006 pack they are pure
AST analysis over one :class:`~..lint.core.LintModule` — no imports of
the code under analysis, deliberately conservative.

The unit of analysis is the **lock-owning class**: a class that binds
``self.<name> = threading.Lock() / RLock() / Condition()``. Owning a
lock is the evidence of concurrency — once a class has one, *every*
method is treated as a potentially concurrent context (a superset of
"reachable from a spawned ``threading.Thread`` target": worker ``_run``
loops, HTTP handler entry points and drain paths are all plain methods
here, and a lock-owning class whose methods were all single-threaded
would not need the lock).

Guarded-attribute inference (JG007): an attribute written at least once
while holding lock ``L`` (direct assignment, augmented/subscript store,
or a mutating method call like ``.append``/``.popleft``) is considered
guarded by ``L``. Two annotation comments extend/override inference:

    self._slots = []          # guarded-by: _cond
        declares the attribute guarded even when inference can't see a
        locked write (e.g. all writes funnel through a helper);

    def _set(self, new):      # holds-lock: _lock
        declares that every caller holds ``_lock``, so the body is
        analyzed as lock-held (the classic "lock held by caller"
        helper). Also accepted on the line directly above the ``def``.

Accesses inside nested ``def``/``lambda`` bodies are skipped entirely:
a closure may run on any thread at any time, and guessing produces
exactly the false positives that get a rule suppressed wholesale.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Set, Tuple

from ..lint.core import Finding, LintModule, dotted_name, last_segment

GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>\w+)")
HOLDS_LOCK_RE = re.compile(r"#\s*holds-lock:\s*(?P<lock>\w+)")

LOCK_FACTORIES = {"Lock", "RLock", "Condition"}

#: method calls on an attribute that mutate it in place — writes for the
#: purposes of guarded-set inference and outside-lock detection.
MUTATING_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "popitem", "remove", "discard", "add", "clear", "update",
    "setdefault", "sort", "reverse", "put", "put_nowait",
}


def _finding(module: LintModule, rule_id: str, node: ast.AST, msg: str) -> Finding:
    return Finding(
        rule=rule_id,
        path=module.path,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        message=msg,
    )


@dataclasses.dataclass
class _Access:
    """One ``self.<attr>`` touch inside a method body."""

    node: ast.AST
    attr: str
    write: bool
    held: FrozenSet[str]
    method: str


@dataclasses.dataclass
class _LockRegion:
    """One ``with self.<lock>:`` statement, with the class attributes it
    reads/writes (used by JG008's cross-release pairing)."""

    node: ast.With
    lock: str
    reads: Set[str]
    writes: Set[str]


class ClassLockInfo:
    """Lock ownership + guarded-attribute analysis of one class."""

    def __init__(self, module: LintModule, cls: ast.ClassDef):
        self.module = module
        self.cls = cls
        self.locks: Dict[str, str] = {}       # attr -> Lock|RLock|Condition
        self.annotated: Dict[str, Set[str]] = {}   # lock -> attrs
        self.holds: Dict[str, Set[str]] = {}       # method name -> locks
        self.accesses: List[_Access] = []
        self.regions: Dict[str, List[_LockRegion]] = {}  # method -> regions
        #: every Call executed with >=1 owned lock held (JG009/JG010)
        self.held_calls: List[
            Tuple[ast.FunctionDef, ast.Call, FrozenSet[str]]
        ] = []
        self._find_locks()
        if self.locks:
            self._find_annotations()
            self._collect()
            self.guarded = self._infer_guarded()

    # -- discovery ----------------------------------------------------------

    def _methods(self) -> Iterable[ast.FunctionDef]:
        for node in self.cls.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node

    def _find_locks(self) -> None:
        for node in ast.walk(self.cls):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            tgt = node.targets[0]
            if not (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
            ):
                continue
            value = node.value
            if (
                isinstance(value, ast.Call)
                and last_segment(value.func) in LOCK_FACTORIES
            ):
                self.locks[tgt.attr] = last_segment(value.func)

    def _find_annotations(self) -> None:
        lines = self.module.lines
        for node in ast.walk(self.cls):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if (
                    isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"
                    and node.lineno <= len(lines)
                ):
                    m = GUARDED_BY_RE.search(lines[node.lineno - 1])
                    if m:
                        self.annotated.setdefault(
                            m.group("lock"), set()
                        ).add(tgt.attr)
        for fn in self._methods():
            held: Set[str] = set()
            for lineno in (fn.lineno, fn.lineno - 1):
                if 1 <= lineno <= len(lines):
                    m = HOLDS_LOCK_RE.search(lines[lineno - 1])
                    if m:
                        held.add(m.group("lock"))
            if held:
                self.holds[fn.name] = held

    # -- access walk --------------------------------------------------------

    def _with_locks(self, node: ast.With) -> Set[str]:
        out: Set[str] = set()
        for item in node.items:
            expr = item.context_expr
            if (
                isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"
                and expr.attr in self.locks
            ):
                out.add(expr.attr)
        return out

    def _classify_access(self, node: ast.Attribute) -> Optional[bool]:
        """True=write, False=read, None=not a state access (the lock
        itself, or a plain ``self.method(...)`` call)."""
        if node.attr in self.locks:
            return None
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            return True
        parent = self.module.parents.get(node)
        if isinstance(parent, ast.Subscript) and parent.value is node:
            if isinstance(parent.ctx, (ast.Store, ast.Del)):
                return True
            return False
        if isinstance(parent, ast.Attribute) and parent.value is node:
            gp = self.module.parents.get(parent)
            if (
                isinstance(gp, ast.Call)
                and gp.func is parent
                and parent.attr in MUTATING_METHODS
            ):
                return True
            return False
        if isinstance(parent, ast.Call) and parent.func is node:
            # self.method(...) — a bound-method call, not state access
            return None
        return False

    def _collect(self) -> None:
        for fn in self._methods():
            base = frozenset(self.holds.get(fn.name, set()))
            regions: List[_LockRegion] = []

            def walk(node: ast.AST, held: FrozenSet[str],
                     region: Optional[_LockRegion]) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(
                        child,
                        (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda),
                    ):
                        continue  # closures: unknown thread/lock context
                    child_held, child_region = held, region
                    if isinstance(child, ast.With):
                        locks = self._with_locks(child)
                        if locks:
                            child_held = held | locks
                            child_region = _LockRegion(
                                child, sorted(locks)[0], set(), set()
                            )
                            regions.append(child_region)
                    if (
                        isinstance(child, ast.Attribute)
                        and isinstance(child.value, ast.Name)
                        and child.value.id == "self"
                    ):
                        write = self._classify_access(child)
                        if write is not None:
                            self.accesses.append(_Access(
                                child, child.attr, write, child_held,
                                fn.name,
                            ))
                            if child_region is not None:
                                (child_region.writes if write
                                 else child_region.reads).add(child.attr)
                    if isinstance(child, ast.Call) and child_held:
                        self.held_calls.append((fn, child, child_held))
                    walk(child, child_held, child_region)

            walk(fn, base, None)
            self.regions[fn.name] = regions

    def _infer_guarded(self) -> Dict[str, Set[str]]:
        guarded: Dict[str, Set[str]] = {
            lock: set(attrs) for lock, attrs in self.annotated.items()
        }
        for acc in self.accesses:
            if acc.write and acc.method != "__init__":
                for lock in acc.held:
                    guarded.setdefault(lock, set()).add(acc.attr)
        return guarded


def _lock_classes(module: LintModule) -> List[ClassLockInfo]:
    """Lock-owning classes of ``module``, analyzed once and cached on
    the module (five rules consume the same per-class analysis)."""
    cached = getattr(module, "_concurrency_lock_classes", None)
    if cached is None:
        cached = [
            info
            for node in ast.walk(module.tree)
            if isinstance(node, ast.ClassDef)
            for info in [ClassLockInfo(module, node)]
            if info.locks
        ]
        module._concurrency_lock_classes = cached  # type: ignore[attr-defined]
    return cached


# --------------------------------------------------------------------------
# JG007 — guarded attribute accessed outside its lock
# --------------------------------------------------------------------------


def check_lock_discipline(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    for info in _lock_classes(module):
        for acc in info.accesses:
            if acc.method == "__init__":
                continue
            owners = sorted(
                lock for lock, attrs in info.guarded.items()
                if acc.attr in attrs
            )
            if not owners:
                continue
            if any(lock in acc.held for lock in owners):
                continue
            what = "write to" if acc.write else "read of"
            out.append(_finding(
                module, "JG007", acc.node,
                f"{what} {info.cls.name}.{acc.attr} outside "
                f"'with self.{owners[0]}:' — the attribute is guarded by "
                f"{'/'.join(owners)} (locked writes elsewhere, or a "
                "'# guarded-by:' annotation); hold the lock, or mark the "
                "helper '# holds-lock: <lock>' if every caller already "
                "does",
            ))
    return out


# --------------------------------------------------------------------------
# JG008 — check-then-act across a lock release (TOCTOU)
# --------------------------------------------------------------------------


def check_check_then_act(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    for info in _lock_classes(module):
        for method, regions in info.regions.items():
            for i, first in enumerate(regions):
                if first.writes or not first.reads:
                    continue  # the check region must be read-only
                for later in regions[i + 1:]:
                    if later.lock != first.lock:
                        continue
                    if later.node.lineno <= first.node.lineno:
                        continue
                    if not later.writes:
                        continue
                    racy = sorted(first.reads & later.writes)
                    if racy:
                        out.append(_finding(
                            module, "JG008", later.node,
                            f"{info.cls.name}.{method} checks "
                            f"{', '.join(racy)} under self.{first.lock} "
                            f"(line {first.node.lineno}) but acts on it "
                            "here after the lock was released and "
                            "re-acquired — another thread can invalidate "
                            "the check in between; do the check and the "
                            "act under ONE acquisition",
                        ))
                        continue
                    # cross-attribute TOCTOU (the PR 4 drain busy-flag
                    # and PR 6 stranded-enqueue shape): the act region
                    # mutates OTHER state without re-reading any of the
                    # checked attributes — the check it is predicated
                    # on was stale by acquisition time. A region that
                    # re-reads (or rewrites) the checked attrs is the
                    # shipped recheck-in-the-acting-acquisition fix.
                    unchecked = sorted(
                        first.reads - later.reads - later.writes
                    )
                    if len(unchecked) == len(first.reads):
                        out.append(_finding(
                            module, "JG008", later.node,
                            f"{info.cls.name}.{method} checks "
                            f"{', '.join(unchecked)} under "
                            f"self.{first.lock} (line "
                            f"{first.node.lineno}) but writes "
                            f"{', '.join(sorted(later.writes))} here in "
                            "a LATER acquisition without re-checking — "
                            "another thread can invalidate the check "
                            "between the two critical sections; "
                            "re-check the predicate in the acquisition "
                            "that acts on it",
                        ))
    return out


# --------------------------------------------------------------------------
# JG009 — blocking call while holding a lock
# --------------------------------------------------------------------------

_SOCKET_METHODS = {"recv", "recv_into", "sendall", "accept", "connect"}
_FILE_METHODS = {"read", "readline", "readlines", "write", "writelines",
                 "flush"}
_FILE_RECEIVERS = {"_fh", "fh", "f", "fp", "file", "wfile", "rfile",
                   "sock", "conn"}
_DEVICE_SYNCS = {"block_until_ready", "device_get"}


def _blocking_reason(node: ast.Call) -> Optional[str]:
    func = node.func
    dn = dotted_name(func) or ""
    seg = last_segment(func)
    if dn == "time.sleep" or dn == "sleep":
        return "time.sleep blocks every thread contending for the lock"
    if isinstance(func, ast.Name) and func.id == "open":
        return "file open is blocking IO"
    if dn.startswith("subprocess."):
        return "subprocess calls block on the child"
    if seg in _DEVICE_SYNCS:
        return f".{seg}() is a device sync — an unbounded stall under " \
               "a contended lock"
    if not isinstance(func, ast.Attribute):
        return None
    recv = last_segment(func.value) or ""
    recv_chain = (dotted_name(func.value) or recv).lower()
    if seg in _SOCKET_METHODS:
        return f"socket .{seg}() blocks on the peer"
    if seg == "join" and ("thread" in recv_chain or "proc" in recv_chain):
        return "joining a thread while holding a lock deadlocks if that " \
               "thread needs the lock to exit"
    if seg in _FILE_METHODS and (
        recv in _FILE_RECEIVERS or "sock" in recv_chain
    ):
        return f"file/socket .{seg}() is blocking IO"
    if seg == "emit" and (
        "telemetry" in recv_chain or "log" in recv_chain
        or "event" in recv_chain
    ):
        return "EventLog.emit does file IO under its own lock — " \
               "IO latency and lock nesting leak into every waiter"
    if seg in ("decode", "prefill") and "decoder" in recv_chain:
        return f"jitted .{seg}() dispatch can stall on XLA/device time"
    if seg.endswith("_fn"):
        return f"{seg}() looks like a jitted dispatch — device time " \
               "under a lock stalls every waiter"
    return None


def check_blocking_in_lock(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    for info in _lock_classes(module):
        for _fn, node, held in info.held_calls:
            reason = _blocking_reason(node)
            if reason is not None:
                out.append(_finding(
                    module, "JG009", node,
                    f"blocking call while holding self.{sorted(held)[0]}: "
                    f"{reason}; move it outside the critical section "
                    "(snapshot under the lock, act after release)",
                ))
    return out


# --------------------------------------------------------------------------
# JG010 — user callback invoked under a held lock
# --------------------------------------------------------------------------

_CALLBACK_NAMES = {"callback", "cb", "hook"}


def _callback_reason(
    node: ast.Call, params: Set[str]
) -> Optional[str]:
    func = node.func
    seg = last_segment(func) or ""
    if seg.startswith(("on_", "_on_")):
        return f"{seg} is a transition/user callback"
    if seg in _CALLBACK_NAMES or seg.endswith(("_callback", "_hook")):
        return f"{seg} is a callback"
    if isinstance(func, ast.Name) and func.id in params:
        return f"{func.id} is a caller-supplied callable (parameter)"
    return None


def check_callback_in_lock(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    for info in _lock_classes(module):
        params_by_fn: Dict[str, Set[str]] = {}
        for fn, node, held in info.held_calls:
            params = params_by_fn.get(fn.name)
            if params is None:
                params = {a.arg for a in fn.args.args} - {"self"}
                params |= {a.arg for a in fn.args.kwonlyargs}
                params_by_fn[fn.name] = params
            reason = _callback_reason(node, params)
            if reason is not None:
                out.append(_finding(
                    module, "JG010", node,
                    f"{reason}, invoked while holding "
                    f"self.{sorted(held)[0]} — a "
                    "callback that re-enters this object "
                    "deadlocks (non-reentrant lock) or sees "
                    "half-updated state; capture it under "
                    "the lock, call it after release (see "
                    "CircuitBreaker._set's deferred-notify "
                    "pattern)",
                ))
    return out


# --------------------------------------------------------------------------
# JG011 — untimed Condition.wait outside a while-predicate loop
# --------------------------------------------------------------------------


def _wait_is_untimed(node: ast.Call) -> bool:
    """Bare ``wait()``, ``wait(None)`` and ``wait(timeout=None)`` are
    all untimed; anything else (a real timeout expression) is treated
    as a bounded poll and exempted."""
    if not node.args and not node.keywords:
        return True
    timeout: Optional[ast.expr] = node.args[0] if node.args else None
    for kw in node.keywords:
        if kw.arg == "timeout":
            timeout = kw.value
    return isinstance(timeout, ast.Constant) and timeout.value is None


def check_wait_predicate(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    # condition attrs per class (receiver ``self.<c>``); plus any
    # receiver whose name says "cond".
    cond_attrs: Set[Tuple[ast.ClassDef, str]] = set()
    for info in _lock_classes(module):
        for attr, kind in info.locks.items():
            if kind == "Condition":
                cond_attrs.add((info.cls, attr))
    for node in ast.walk(module.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "wait"
            and _wait_is_untimed(node)
        ):
            continue
        recv = node.func.value
        recv_name = (last_segment(recv) or "").lower()
        is_cond = "cond" in recv_name
        if (
            not is_cond
            and isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
        ):
            is_cond = any(attr == recv.attr for _, attr in cond_attrs)
        if not is_cond:
            continue
        # walk up: a While between the call and the enclosing function
        # means the predicate is (presumably) rechecked after wakeup
        cur = module.parents.get(node)
        in_while = False
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
        ):
            if isinstance(cur, ast.While):
                in_while = True
                break
            cur = module.parents.get(cur)
        if not in_while:
            out.append(_finding(
                module, "JG011", node,
                "untimed Condition.wait() outside a while-predicate "
                "loop — spurious wakeups and missed notifies are legal, "
                "so the state must be rechecked: "
                "`while not pred: cond.wait()` or cond.wait_for(pred). "
                "(Timed waits are exempt: they are bounded polls.)",
            ))
    return out
