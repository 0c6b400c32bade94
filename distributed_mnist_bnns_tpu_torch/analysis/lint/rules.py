"""The port's lint rules: the JAX package's registry (``JG001``-``JG018``),
each ID decided for PyTorch.

Each ID is one of three kinds:

* **carried over**: the JAX rule itself, message for message
  (``JG005``, the concurrency pack ``JG007``-``JG011``, the event-schema
  contracts ``JG017``/``JG018``, the last checked against the port's own
  ``obs/events.py``);
* **counterpart**: the same hazard in torch's terms, under the same ID
  (``JG001`` host syncs in a captured region, ``JG002`` draws from
  torch's global generator, ``JG012``/``JG014`` rank-dependent
  ``torch.distributed`` collectives);
* **not applicable**: registered with the reason, so that ``cli lint
  --rule <id>`` says why instead of reporting "0 findings".

Each rule is pure AST analysis over one ``LintModule``; none of them
import torch. They are deliberately conservative — a rule that cries
wolf gets suppressed wholesale and teaches nothing — so each encodes the
narrow shape of a fault this codebase (or its reference) actually hit.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

from .core import Finding, LintModule, dotted_name, last_segment


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    description: str
    check: Optional[Callable[[LintModule], List[Finding]]]
    kind: str = "carried"     # carried | counterpart | not_applicable
    reason: Optional[str] = None   # why a not-applicable rule is


class RuleNotApplicable(ValueError):
    """A rule ID that the port registers as not applicable (or does not
    know); the message is the reason."""


def check_rule_ids(rule_ids: Sequence[str]) -> None:
    """Raise ``RuleNotApplicable`` for an ID that is not one of the
    port's rules or that the port registers as not applicable."""
    for rid in rule_ids:
        rule = RULES.get(rid.upper())
        if rule is None:
            raise RuleNotApplicable(
                f"{rid}: no such rule (have: {', '.join(RULES)})")
        if rule.check is None:
            raise RuleNotApplicable(
                f"{rule.id} ({rule.name}) is not applicable to the port: "
                f"{rule.reason}")


def _nodes(module: LintModule) -> List[ast.AST]:
    """Every node of the module, walked once and cached on it (the
    counterparts below read the tree several times)."""
    cached = getattr(module, "_all_nodes", None)
    if cached is None:
        cached = list(ast.walk(module.tree))
        module._all_nodes = cached  # type: ignore[attr-defined]
    return cached


def _finding(module: LintModule, rule_id: str, node: ast.AST, msg: str) -> Finding:
    return Finding(
        rule=rule_id,
        path=module.path,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        message=msg,
    )


# --------------------------------------------------------------------------
# JG001 — host sync inside a captured region (counterpart)
# --------------------------------------------------------------------------

_NUMPY_ALIASES = {"np", "numpy", "onp"}
_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}


def check_host_sync(module: LintModule) -> List[Finding]:
    """A host sync inside a captured region: on the card the call fails
    the capture, or reads a value frozen at capture time that every
    replay then repeats."""
    out: List[Finding] = []
    if not (module.captured or module.capture_blocks):
        return out
    for node in _nodes(module):
        if not isinstance(node, ast.Call) or not module.is_captured(node):
            continue
        func = node.func
        if isinstance(func, ast.Name) and func.id == "float" and node.args:
            out.append(
                _finding(
                    module, "JG001", node,
                    "float() on a tensor inside a captured region — a "
                    "device->host sync that fails the capture or freezes "
                    "the value read at capture time into every replay",
                )
            )
        elif isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
            out.append(
                _finding(
                    module, "JG001", node,
                    f".{func.attr}() inside a captured region forces a "
                    "device->host sync (the capture fails, or the value "
                    "is the one read at capture time)",
                )
            )
        elif (
            isinstance(func, ast.Attribute)
            and func.attr in ("asarray", "array")
            and isinstance(func.value, ast.Name)
            and func.value.id in _NUMPY_ALIASES
        ):
            out.append(
                _finding(
                    module, "JG001", node,
                    f"{func.value.id}.{func.attr}() inside a captured "
                    "region pulls the value to host numpy — keep it a "
                    "tensor on the device",
                )
            )
    return out


# --------------------------------------------------------------------------
# JG002 — draws from torch's global generator (counterpart)
# --------------------------------------------------------------------------

#: torch functions that draw and take ``generator=``
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "bernoulli", "multinomial",
    "normal", "poisson", "binomial", "rand_like", "randn_like",
    "randint_like",
}
#: in-place draws (``Tensor.uniform_`` ... and the ``torch.nn.init``
#: samplers), all of which take ``generator=``
_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "bernoulli_", "random_", "exponential_",
    "cauchy_", "log_normal_", "geometric_", "xavier_uniform_",
    "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
    "trunc_normal_", "orthogonal_", "sparse_",
}
#: dropout draws from the global generator and takes none
_DROPOUT_FUNCTIONS = {
    "dropout", "dropout1d", "dropout2d", "dropout3d", "alpha_dropout",
    "feature_alpha_dropout",
}
_DROPOUT_MODULES = {
    "Dropout", "Dropout1d", "Dropout2d", "Dropout3d", "AlphaDropout",
    "FeatureAlphaDropout",
}
_GLOBAL_SEEDS = {
    "torch.manual_seed", "torch.random.manual_seed",
    "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
}


def _in_test_function(module: LintModule, node: ast.AST) -> bool:
    cur = module.nearest_def(node)
    while cur is not None:
        if getattr(cur, "name", "").startswith("test"):
            return True
        cur = module.nearest_def(cur)
    return False


def _torch_names(module: LintModule):
    """(dotted prefixes that mean ``torch``, ``torch.nn`` and
    ``torch.nn.functional``, bare names imported from them), so that a
    helper of the repo's own named ``dropout`` or ``rand`` is never
    mistaken for torch's."""
    prefixes = {"torch": {"torch"}, "nn": {"torch.nn", "nn"},
                "functional": {"torch.nn.functional", "F"}}
    bare: Dict[str, Set[str]] = {"torch": set(), "nn": set(),
                                 "functional": set()}
    which = {"torch": "torch", "torch.nn": "nn",
             "torch.nn.functional": "functional"}
    for node in _nodes(module):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name in which and a.asname:
                    prefixes[which[a.name]].add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module in which:
                for a in node.names:
                    bare[which[node.module]].add(a.asname or a.name)
            if node.module in ("torch", "torch.nn"):
                for a in node.names:
                    sub = f"{node.module}.{a.name}"
                    if sub in which:
                        prefixes[which[sub]].add(a.asname or a.name)
    return prefixes, bare


def _from(dn: str, seg: str, group: str, prefixes, bare) -> bool:
    """``dn`` is ``<a prefix of group>.<seg>`` or the bare name ``seg``
    imported from it."""
    return (
        any(dn == f"{p}.{seg}" for p in prefixes[group])
        or (dn == seg and seg in bare[group])
    )


def check_prng_hygiene(module: LintModule) -> List[Finding]:
    if module.is_test_file():
        return []
    prefixes, bare = _torch_names(module)
    out: List[Finding] = []
    for node in _nodes(module):
        if not isinstance(node, ast.Call):
            continue
        seg = last_segment(node.func) or ""
        dn = dotted_name(node.func) or ""
        has_gen = any(k.arg == "generator" for k in node.keywords)
        if dn in _GLOBAL_SEEDS and not _in_test_function(module, node):
            out.append(
                _finding(
                    module, "JG002", node,
                    f"{dn}() in library code seeds torch's global "
                    "generator for every caller — take a seed and draw "
                    "from a torch.Generator of your own",
                )
            )
        elif seg in _TORCH_SAMPLERS and not has_gen and _from(
            dn, seg, "torch", prefixes, bare
        ):
            out.append(
                _finding(
                    module, "JG002", node,
                    f"torch.{seg}() without generator= draws from torch's "
                    "global generator — the draws then depend on every "
                    "other user of it; pass the caller's generator",
                )
            )
        elif seg in _INPLACE_SAMPLERS and not has_gen and isinstance(
            node.func, ast.Attribute
        ):
            out.append(
                _finding(
                    module, "JG002", node,
                    f".{seg}() without generator= draws from torch's "
                    "global generator — pass the caller's generator",
                )
            )
        elif seg in _DROPOUT_FUNCTIONS and (
            _from(dn, seg, "functional", prefixes, bare)
            or _from(dn, seg, "torch", prefixes, bare)
        ):
            out.append(
                _finding(
                    module, "JG002", node,
                    f"{dn}() draws its mask from torch's global generator "
                    "and cannot take another — draw the mask from the "
                    "model's generator (torch.rand(..., generator=g))",
                )
            )
        elif seg in _DROPOUT_MODULES and _from(
            dn, seg, "nn", prefixes, bare
        ):
            out.append(
                _finding(
                    module, "JG002", node,
                    f"{dn}() draws its mask from torch's global generator "
                    "and cannot take another — draw the mask from the "
                    "model's generator (torch.rand(..., generator=g))",
                )
            )
    return out


# --------------------------------------------------------------------------
# JG005 — silent broad except (carried over)
# --------------------------------------------------------------------------

_LOG_METHODS = {
    "debug", "info", "warning", "warn", "error", "exception", "critical",
}


def check_silent_except(module: LintModule) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None or (
            last_segment(node.type) in ("Exception", "BaseException")
        )
        if not broad:
            continue
        body_nodes = [n for stmt in node.body for n in ast.walk(stmt)]
        reraises = any(isinstance(n, ast.Raise) for n in body_nodes)
        logs = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _LOG_METHODS
            for n in body_nodes
        )
        uses_exc = node.name is not None and any(
            isinstance(n, ast.Name) and n.id == node.name
            for n in body_nodes
        )
        if not (reraises or logs or uses_exc):
            what = (
                "bare except" if node.type is None
                else f"except {last_segment(node.type)}"
            )
            out.append(
                _finding(
                    module, "JG005", node,
                    f"{what} swallows the error (no re-raise, no logging, "
                    "exception unused) — narrow the type or log why "
                    "ignoring is safe",
                )
            )
    return out


# --------------------------------------------------------------------------
# JG012 / JG014 — rank-dependent torch.distributed collectives
# (counterparts). The bug class: a group collective that some ranks
# issue and others skip does not error, it hangs the world.
# analysis/spmd.py is the runtime half (the lockstep checker).
# --------------------------------------------------------------------------

#: group collectives: every rank of the group must issue them, in the
#: same order. Point-to-point send/recv/isend/irecv are not here: a
#: pipeline's stage-dependent sends are paired by design.
_COLLECTIVES = {
    "all_reduce", "all_reduce_coalesced", "all_gather",
    "all_gather_into_tensor", "all_gather_object", "all_gather_coalesced",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "barrier",
}
_RANK_NAMES = {"rank", "local_rank", "node_rank"}


def _dist_names(module: LintModule):
    """(dotted prefixes that mean ``torch.distributed``, bare collective
    names imported from it)."""
    prefixes = {"torch.distributed"}
    bare: Set[str] = set()
    for node in _nodes(module):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    prefixes.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module == "torch":
                for a in node.names:
                    if a.name == "distributed":
                        prefixes.add(a.asname or "distributed")
            elif node.module == "torch.distributed":
                for a in node.names:
                    bare.add(a.asname or a.name)
    return prefixes, bare


def _is_collective(node: ast.AST, dist_names) -> bool:
    if not isinstance(node, ast.Call):
        return False
    seg = last_segment(node.func)
    if seg not in _COLLECTIVES:
        return False
    prefixes, bare = dist_names
    dn = dotted_name(node.func) or ""
    return any(dn == f"{p}.{seg}" for p in prefixes) or (
        dn == seg and seg in bare
    )


def _group_repr(call: ast.Call) -> str:
    for kw in call.keywords:
        if kw.arg == "group":
            try:
                return ast.unparse(kw.value)
            except (ValueError, RecursionError):  # pragma: no cover
                return "?"
    return "default"


def _reads_rank(test: ast.AST) -> bool:
    """The test reads this process's rank: ``dist.get_rank(...)``, or a
    name or attribute ``rank`` / ``local_rank`` / ``node_rank``."""
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and last_segment(n.func) == "get_rank":
            return True
        if isinstance(n, (ast.Name, ast.Attribute)) and (
            last_segment(n) in _RANK_NAMES
        ):
            return True
    return False


def _branch_collectives(module: LintModule, stmts: List[ast.stmt],
                        dist_names) -> List[ast.Call]:
    """The collectives a branch issues, in lexical order, following
    same-module function calls one hop (a branch that delegates to a
    helper still shows its schedule)."""
    out: List[ast.Call] = []
    for stmt in stmts:
        for n in ast.walk(stmt):
            if _is_collective(n, dist_names):
                out.append(n)
            elif isinstance(n, ast.Call):
                inner = module.resolve_callable(n.func)
                if isinstance(inner, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    out.extend(
                        c for s in inner.body for c in ast.walk(s)
                        if _is_collective(c, dist_names)
                    )
    return out


def _rank_branches(module: LintModule) -> List[tuple]:
    """(node, [body collectives, else collectives]) for each ``if`` /
    ``while`` whose test reads the rank (cached on the module: JG012 and
    JG014 read the same)."""
    cached = getattr(module, "_rank_branches", None)
    if cached is None:
        dist_names = _dist_names(module)
        cached = module._rank_branches = [  # type: ignore[attr-defined]
            (node, [_branch_collectives(module, part, dist_names)
                    for part in (node.body, node.orelse)])
            for node in _nodes(module)
            if isinstance(node, (ast.If, ast.While))
            and _reads_rank(node.test)
        ]
    return cached


def check_collective_divergence(module: LintModule) -> List[Finding]:
    """JG012: a group collective reachable from only one side of a
    branch on the rank. The ranks that skip it leave the others blocked
    in it (a hang, not an error)."""
    out: List[Finding] = []
    for _node, branch_colls in _rank_branches(module):
        have = [bc for bc in branch_colls if bc]
        if len(have) == 1 and not all(branch_colls):
            for c in have[0]:
                op = last_segment(c.func)
                out.append(
                    _finding(
                        module, "JG012", c,
                        f"collective `{op}` under a rank-dependent "
                        "`if`/`while` with no matching collective on the "
                        "other path — the ranks that skip it leave the "
                        "rest of the group hung in the collective",
                    )
                )
    return out


def check_collective_order(module: LintModule) -> List[Finding]:
    """JG014: the branches of one rank-dependent conditional issue
    *different* sequences of group collectives (both non-empty). The
    ranks then pair mismatched collectives: wrong results or a hang."""
    out: List[Finding] = []
    for node, seqs in _rank_branches(module):
        nonempty = [s for s in seqs if s]
        if len(nonempty) < 2:
            continue  # one-sided is JG012's finding
        sigs = [[(last_segment(c.func), _group_repr(c)) for c in s]
                for s in nonempty]
        if any(sig != sigs[0] for sig in sigs[1:]):
            out.append(
                _finding(
                    module, "JG014", node,
                    "branches of the same rank-dependent conditional "
                    "issue different collective sequences "
                    f"({' vs '.join(str(s) for s in sigs)}) — the ranks "
                    "pair mismatched collectives (wrong results or a "
                    "hang)",
                )
            )
    return out


# --------------------------------------------------------------------------
# Event-schema contracts (JG017/JG018, carried over) — emit() call sites
# checked against obs/events.py's EVENT_KINDS registry and envelope fields.
# --------------------------------------------------------------------------

_events_registry_cache: Optional[tuple] = None


def _event_registry() -> tuple:
    """(EVENT_KINDS dict, ENVELOPE_FIELDS tuple) parsed out of the
    port's own obs/events.py with ``ast.literal_eval`` — the linter
    stays import-free (no torch, no package import). Returns (None,
    fallback-envelope) when the module can't be read, in which case
    JG017 stays silent rather than flagging everything unknown."""
    global _events_registry_cache
    if _events_registry_cache is not None:
        return _events_registry_cache
    import os

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        os.pardir, os.pardir, "obs", "events.py",
    )
    kinds: Optional[dict] = None
    envelope = ("v", "kind", "ts")
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            if "EVENT_KINDS" in names and node.value is not None:
                kinds = ast.literal_eval(node.value)
            elif "ENVELOPE_FIELDS" in names and node.value is not None:
                envelope = tuple(ast.literal_eval(node.value))
    except (OSError, SyntaxError, ValueError):
        kinds = None
    _events_registry_cache = (kinds, envelope)
    return _events_registry_cache


def check_event_kinds(module: LintModule) -> List[Finding]:
    """JG017: an ``emit("<kind>", ...)`` call site whose kind literal is
    missing from obs/events.py's EVENT_KINDS registry. Readers
    (``summarize``, ``cli trace``, SLO monitors) key on kind strings —
    an unregistered kind is invisible to all of them."""
    if module.is_test_file():
        return []
    kinds, _ = _event_registry()
    if not kinds:
        return []
    out: List[Finding] = []
    for node in ast.walk(module.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "emit"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            continue
        kind = node.args[0].value
        if kind not in kinds:
            out.append(
                _finding(
                    module, "JG017", node,
                    f"emit of unregistered event kind {kind!r} — add it "
                    "to obs/events.py EVENT_KINDS (and the "
                    "OBSERVABILITY.md event table) or use a registered "
                    "kind; unregistered kinds are invisible to every "
                    "reader",
                )
            )
    return out


def check_event_envelope(module: LintModule) -> List[Finding]:
    """JG018: an ``emit()`` payload key that collides with the event
    envelope (``v``/``kind``/``ts``) — as an explicit keyword or inside
    a ``**{...}`` literal. The collision silently clobbers the
    envelope's field."""
    _, envelope = _event_registry()
    out: List[Finding] = []
    for node in ast.walk(module.tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "emit"
        ):
            continue
        for kw in node.keywords:
            if kw.arg in envelope:
                out.append(
                    _finding(
                        module, "JG018", kw.value,
                        f"emit payload key {kw.arg!r} collides with the "
                        "event envelope — it would clobber the "
                        f"record's own {kw.arg!r} field; nest it "
                        "(e.g. under `info`) or rename it",
                    )
                )
            elif kw.arg is None and isinstance(kw.value, ast.Dict):
                for k in kw.value.keys:
                    if isinstance(k, ast.Constant) and k.value in envelope:
                        out.append(
                            _finding(
                                module, "JG018", k,
                                f"emit **payload key {k.value!r} collides "
                                "with the event envelope — nest or "
                                "rename it",
                            )
                        )
    return out


from ..concurrency.rules import (  # noqa: E402 — after Rule is defined
    check_blocking_in_lock,
    check_callback_in_lock,
    check_check_then_act,
    check_lock_discipline,
    check_wait_predicate,
)


def _na(rule_id: str, name: str, reason: str) -> Rule:
    return Rule(rule_id, name, f"not applicable to the port: {reason}",
                None, kind="not_applicable", reason=reason)


RULES: Dict[str, Rule] = {
    r.id: r
    for r in [
        Rule(
            "JG001", "host-sync-in-capture",
            ".item()/.tolist()/.cpu()/.numpy()/float()/.synchronize()/"
            "np.asarray inside a captured region (a torch.cuda.graph "
            "block, or a step body passed to train.capture.TrainScan)",
            check_host_sync, kind="counterpart",
        ),
        Rule(
            "JG002", "prng-hygiene",
            "draws from torch's global generator in library code: a "
            "sampler without generator=, dropout (which takes none), or "
            "seeding the global generator",
            check_prng_hygiene, kind="counterpart",
        ),
        _na(
            "JG003", "jit-boundary",
            "the port has no jit, no buffer donation and no static "
            "arguments; a captured step's in-place state is the CUDA "
            "graph's own contract (train.capture)",
        ),
        _na(
            "JG004", "tracer-control-flow",
            "eager torch has no tracers: a Python branch on a tensor "
            "runs on its value; reading a tensor's value inside a "
            "capture is a host sync, which JG001 covers",
        ),
        Rule(
            "JG005", "silent-except",
            "broad except that neither re-raises, logs, nor uses the "
            "exception",
            check_silent_except,
        ),
        _na(
            "JG006", "shard-map-compat",
            "the port has no shard_map and no version shim "
            "(parallel/compat.py is not ported)",
        ),
        # Concurrency pack (analysis/concurrency/rules.py): lock
        # discipline for the threaded serving/telemetry stack.
        Rule(
            "JG007", "lock-discipline",
            "guarded attribute (locked writes or '# guarded-by:') read "
            "or written outside its lock in a lock-owning class",
            check_lock_discipline,
        ),
        Rule(
            "JG008", "check-then-act",
            "state checked under a lock but acted on after release and "
            "re-acquisition (TOCTOU window)",
            check_check_then_act,
        ),
        Rule(
            "JG009", "blocking-in-lock",
            "blocking call (IO, sleep, thread join, a decoder's kernel "
            "dispatch, EventLog.emit) while holding a lock",
            check_blocking_in_lock,
        ),
        Rule(
            "JG010", "callback-in-lock",
            "user/transition callback invoked under a held lock "
            "(reentrancy deadlock hazard)",
            check_callback_in_lock,
        ),
        Rule(
            "JG011", "wait-needs-predicate",
            "untimed Condition.wait() outside a while-predicate loop",
            check_wait_predicate,
        ),
        # Collective pack (this module, above): rank-dependent
        # torch.distributed collectives — the hang class.
        # analysis/spmd.py is the runtime half (lockstep checker).
        Rule(
            "JG012", "collective-divergence",
            "torch.distributed group collective (all_reduce, all_gather*, "
            "reduce_scatter*, all_to_all*, broadcast, barrier) reachable "
            "from only one side of a branch on the rank; point-to-point "
            "send/recv/isend/irecv are excluded (a pipeline's "
            "stage-dependent sends are paired by design)",
            check_collective_divergence, kind="counterpart",
        ),
        _na(
            "JG013", "collective-axis-validity",
            "a torch collective takes a process-group object, not an "
            "axis name; a group this rank is not in fails at call time",
        ),
        Rule(
            "JG014", "collective-order-consistency",
            "branches of the same rank-dependent conditional issue "
            "different sequences of torch.distributed group collectives",
            check_collective_order, kind="counterpart",
        ),
        _na(
            "JG015", "donation-use-after-donate",
            "torch has no buffer donation",
        ),
        _na(
            "JG016", "shard-map-spec-arity",
            "the port has no shard_map (and so no in_specs/out_specs)",
        ),
        # Event-schema contracts (this module, above): emit() call
        # sites vs obs/events.py's EVENT_KINDS registry + envelope.
        Rule(
            "JG017", "event-kind-registry",
            "emit() of an event kind missing from obs/events.py's "
            "EVENT_KINDS registry",
            check_event_kinds,
        ),
        Rule(
            "JG018", "event-envelope-collision",
            "emit() payload key colliding with the event envelope "
            "(v/kind/ts)",
            check_event_envelope,
        ),
    ]
}
