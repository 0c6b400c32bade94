"""Fault injection: named, seed-deterministic chaos (a copy of the JAX
package's ``resilience/chaos.py``).

Recovery code that is never exercised does not work. This module
scripts exact failure sequences against a live run, so that tests and
the chip smoke can hold the resilient path end to end.

Spec grammar (``TrainConfig.chaos`` / ``--chaos`` / the ``JG_CHAOS``
environment variable)::

    spec     := entry (";" entry)*
    entry    := kind ["@" arg ("," arg)*]
    arg      := key "=" value
    kind     := step_fault | data_io | preempt | slow_host
              | ckpt_corrupt | ckpt_truncate
              | infer_slow | infer_error
              | worker_lost | worker_restore
              | host_lost | host_restore
    key      := step | epoch | p | times | delay_s | world | hosts

``step``/``epoch`` trigger a rule the first time the run reaches that
global optimizer step / epoch (``>=``, so a chunked dispatch that jumps
several steps at once still fires). ``p`` is a per-opportunity
probability drawn from a rule-local ``random.Random(f"{seed}:{key}")``,
the JAX module's, so a spec fires at the same steps as there. ``times``
caps the fires (default 1; ``-1`` unlimited); ``delay_s`` is a stall's
length.

Fault points:

  step_fault     transient exception before a train-step dispatch
                 (``ChaosStepFault``, classified transient)
  data_io        batch-IO error at the same point (``ChaosIOError``)
  preempt        a graceful stop, as a SIGTERM would request it (the
                 trainer wires ``on_preempt`` to its ``StopRequest``;
                 without a callback a real SIGTERM is sent)
  slow_host      stalls the host ``delay_s`` seconds
  ckpt_corrupt   flips bytes in the checkpoint just written
  ckpt_truncate  truncates it to half its length
  infer_slow     stalls the serving predictor call ``delay_s`` seconds
  infer_error    raises ``ChaosInferError`` at the predictor call
  worker_lost    data-parallel workers lost: a membership change to
                 ``world=N`` (mandatory) reported to the elastic
                 supervisor (``resilience.elastic``); a trainer without
                 ``elastic=True`` rejects the spec
  worker_restore the workers came back: a change back to ``world=N``
                 (default: the launch world)
  host_lost      a real host loss in the multihost runtime (``hosts=N``
                 mandatory): every rank process whose rank is >= N
                 SIGKILLs itself at the step boundary; the survivors see
                 the dead world in the host collective
                 (``parallel.hostcomm``), vacate without saving, and the
                 supervisor (``resilience.multihost``) relaunches the
                 world at the shrunken count; a trainer without a host
                 channel rejects the spec
  host_restore   the hosts came back: every rank saves and vacates
                 (exit 75) and the supervisor relaunches at ``hosts=N``
                 (default: the launch count)

Serving rules trigger on ``step`` = the serving engine's micro-batch
sequence number (or ``p``); ``epoch`` never fires there.

Fire counts live in a process-global ledger keyed by spec entry, so a
``times=1`` fault does not refire when the retry loop rebuilds the
trainer and replays the step (``reset_fire_counts`` isolates tests).
Every fire increments ``faults_injected_total{kind}`` and, with a
telemetry sink, emits a ``fault_injected`` event before the fault takes
effect; with tracing on it is also an instant ``chaos.<kind>`` span
(the stalls a ``chaos.stall`` span around the sleep).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

log = logging.getLogger(__name__)

ENV_SPEC = "JG_CHAOS"

FAULT_KINDS = frozenset({
    "step_fault", "data_io", "preempt", "slow_host",
    "ckpt_corrupt", "ckpt_truncate",
    "infer_slow", "infer_error",
    "worker_lost", "worker_restore",
    "host_lost", "host_restore",
})

# Which kinds each fault point dispatches — a rule only evaluates its
# trigger (and, for p=, draws its RNG) at its own point, so a mixed
# training+serving spec keeps per-rule probabilistic replay
# deterministic at every point.
_STEP_KINDS = frozenset({"step_fault", "data_io", "preempt", "slow_host"})
_CKPT_KINDS = frozenset({"ckpt_corrupt", "ckpt_truncate"})
_INFER_KINDS = frozenset({"infer_slow", "infer_error"})
# Membership kinds fire at the trainer step boundary like _STEP_KINDS
# but are dispatched to the elastic supervisor's hook, not the trainer —
# exported so the Trainer can reject them loudly without --elastic.
MEMBERSHIP_KINDS = frozenset({"worker_lost", "worker_restore"})
# Host-level membership kinds (the multi-host elastic runtime): fire at
# the trainer step boundary and dispatch to the multihost hook — which
# may SIGKILL THIS PROCESS (host_lost on a doomed rank). Exported so the
# Trainer can reject them loudly outside the multihost runtime.
HOST_KINDS = frozenset({"host_lost", "host_restore"})

FAULTS_TOTAL = "faults_injected_total"

# Process-global fire ledger (see module docstring): rule key -> fires.
_FIRE_LEDGER: Dict[str, int] = {}


def reset_fire_counts() -> None:
    """Forget all fires — call between independent chaos scenarios."""
    _FIRE_LEDGER.clear()


class ChaosFault(RuntimeError):
    """Base marker for injected faults (classified transient by
    resilience.policy)."""


class ChaosStepFault(ChaosFault):
    """Injected transient train-step exception."""


class ChaosIOError(ChaosFault, OSError):
    """Injected data-batch IO error."""


class ChaosInferError(ChaosFault):
    """Injected transient serving-backend error (predictor call)."""


@dataclass
class FaultRule:
    """One parsed spec entry. ``key`` identifies the entry in the
    process-global fire ledger (spec text + position)."""

    kind: str
    step: Optional[int] = None
    epoch: Optional[int] = None
    p: float = 0.0
    times: int = 1
    delay_s: float = 1.0
    world: Optional[int] = None  # membership kinds: post-change world
    hosts: Optional[int] = None  # host kinds: post-change host count
    key: str = ""


def parse_chaos_spec(spec: str) -> List[FaultRule]:
    """Parse the chaos spec grammar (module docstring); raises
    ``ValueError`` with the offending entry on any malformed input so a
    typo'd CI spec fails loudly, not silently-no-chaos."""
    rules: List[FaultRule] = []
    for i, raw in enumerate(e.strip() for e in spec.split(";")):
        if not raw:
            continue
        kind, _, argstr = raw.partition("@")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos fault kind {kind!r} in {raw!r} "
                f"(have: {', '.join(sorted(FAULT_KINDS))})"
            )
        rule = FaultRule(kind=kind, key=f"{raw}#{i}")
        casts = {"step": int, "epoch": int, "p": float, "times": int,
                 "delay_s": float, "world": int, "hosts": int}
        for arg in (a.strip() for a in argstr.split(",")):
            if not arg:
                continue
            k, sep, v = arg.partition("=")
            if not sep:
                raise ValueError(f"chaos arg {arg!r} in {raw!r} is not k=v")
            if k not in casts:
                raise ValueError(
                    f"unknown chaos key {k!r} in {raw!r} "
                    "(have: step, epoch, p, times, delay_s, world, hosts)"
                )
            try:
                setattr(rule, k, casts[k](v))
            except ValueError as e:
                raise ValueError(
                    f"bad chaos value {v!r} for {k!r} in {raw!r}"
                ) from e
        if rule.step is None and rule.epoch is None and rule.p <= 0:
            raise ValueError(
                f"chaos entry {raw!r} needs a trigger: step=, epoch= or p="
            )
        if rule.world is not None and kind not in MEMBERSHIP_KINDS:
            raise ValueError(
                f"chaos key 'world' in {raw!r} only applies to "
                "worker_lost/worker_restore"
            )
        if kind == "worker_lost" and (rule.world is None or rule.world < 1):
            raise ValueError(
                f"chaos entry {raw!r} needs world=N >= 1 (the post-loss "
                "data-parallel world size)"
            )
        if rule.world is not None and rule.world < 1:
            raise ValueError(
                f"chaos entry {raw!r}: world must be >= 1, "
                f"got {rule.world}"
            )
        if rule.hosts is not None and kind not in HOST_KINDS:
            raise ValueError(
                f"chaos key 'hosts' in {raw!r} only applies to "
                "host_lost/host_restore"
            )
        if kind == "host_lost" and (rule.hosts is None or rule.hosts < 1):
            raise ValueError(
                f"chaos entry {raw!r} needs hosts=N >= 1 (the post-loss "
                "host count)"
            )
        if rule.hosts is not None and rule.hosts < 1:
            raise ValueError(
                f"chaos entry {raw!r}: hosts must be >= 1, "
                f"got {rule.hosts}"
            )
        rules.append(rule)
    return rules


class ChaosController:
    """Evaluates the parsed rules at the instrumented fault points.

    Hooks (all cheap no-ops when ``active`` is False):
      * ``on_step(step=, epoch=)`` — called by the trainer before each
        dispatch; stalls (slow_host), raises (data_io/step_fault) or
        requests preemption (preempt), in spec order.
      * ``on_checkpoint_written(path, step=, epoch=)`` — called by the
        checkpoint writers after the artifact lands; corrupts or
        truncates it in place (a directory artifact has its largest
        file hit).
    """

    def __init__(
        self,
        rules: List[FaultRule],
        *,
        seed: int = 0,
        telemetry: Any = None,
        spec: str = "",
    ):
        self.rules = rules
        self.seed = seed
        self.telemetry = telemetry
        self.spec = spec
        # Wired by the trainer to StopRequest.request; the fallback
        # exercises the real signal path.
        self.on_preempt: Optional[Callable[[str], None]] = None
        # Wired by the elastic supervisor (resilience/elastic): called
        # as on_membership(event, world=, step=, epoch=) with event
        # "lost"|"restored" when a membership kind fires. Without a
        # supervisor a fired membership rule raises — silently dropping
        # a scripted worker loss would make the chaos test vacuous.
        self.on_membership: Optional[Callable[..., None]] = None
        # Wired by the multihost trainer: called as
        # on_host_membership(event, hosts=, step=, epoch=) with event
        # "lost"|"restored". The "lost" handler SIGKILLs the process
        # when its own rank is doomed — control may never return.
        self.on_host_membership: Optional[Callable[..., None]] = None
        self._rngs = {
            r.key: random.Random(f"{seed}:{r.key}") for r in rules
        }

    @classmethod
    def from_config(
        cls, spec: Optional[str], *, seed: int = 0, telemetry: Any = None
    ) -> "ChaosController":
        """Build from an explicit spec, falling back to the ``JG_CHAOS``
        env var when ``spec`` is None (how CI arms chaos without
        touching call sites); empty/unset -> inactive controller."""
        if spec is None:
            spec = os.environ.get(ENV_SPEC, "")
        rules = parse_chaos_spec(spec) if spec else []
        return cls(rules, seed=seed, telemetry=telemetry, spec=spec or "")

    @property
    def active(self) -> bool:
        return bool(self.rules)

    def _span_tracer(self):
        """The telemetry sink's tracer when tracing is armed, else
        None — chaos must stay importable/usable with a bare telemetry
        stub (tests pass all kinds of fakes)."""
        tr = getattr(self.telemetry, "tracer", None)
        return tr if tr is not None and getattr(tr, "enabled", False) \
            else None

    def _stall(self, rule: FaultRule, point: str,
               step: Optional[int]) -> None:
        """The scripted sleep, wrapped in a duration ``stall`` span so
        the stalled window itself is visible in the trace (and in tail
        attribution) — not just the instant fire marker."""
        tr = self._span_tracer()
        if tr is None:
            time.sleep(rule.delay_s)
            return
        with tr.start(
            "chaos.stall", kind="stall", fault=rule.kind, point=point,
            step=step, delay_s=rule.delay_s,
        ):
            time.sleep(rule.delay_s)

    # -- trigger evaluation --------------------------------------------------

    def _should_fire(
        self, rule: FaultRule, step: Optional[int], epoch: Optional[int]
    ) -> bool:
        if 0 <= rule.times <= _FIRE_LEDGER.get(rule.key, 0):
            return False
        if rule.step is not None:
            return step is not None and step >= rule.step
        if rule.epoch is not None:
            return epoch is not None and epoch >= rule.epoch
        return self._rngs[rule.key].random() < rule.p

    def _record(
        self, rule: FaultRule, point: str,
        step: Optional[int], epoch: Optional[int], detail: str = "",
    ) -> None:
        _FIRE_LEDGER[rule.key] = _FIRE_LEDGER.get(rule.key, 0) + 1
        from ..obs import default_registry

        registry = (
            self.telemetry.registry if self.telemetry is not None
            else default_registry()
        )
        registry.counter(
            FAULTS_TOTAL, "chaos faults fired by kind"
        ).inc(kind=rule.kind)
        if self.telemetry is not None:
            # "fault" not "kind": the envelope already owns the kind
            # field (= "fault_injected").
            self.telemetry.emit(
                "fault_injected", fault=rule.kind, point=point,
                step=step, epoch=epoch, detail=detail, rule=rule.key,
            )
        tr = self._span_tracer()
        if tr is not None:
            # Instant marker span at the fault point; parenting to the
            # firing thread's current span (serve batch / LM decode
            # iteration) makes fault->latency causality first-class.
            now = time.monotonic()
            tr.record(
                f"chaos.{rule.kind}", kind="chaos", t0=now, t1=now,
                fault=rule.kind, point=point, step=step, epoch=epoch,
                **({"detail": detail} if detail else {}),
            )
        log.warning(
            "chaos: injected %s at step=%s epoch=%s%s",
            rule.kind, step, epoch, f" ({detail})" if detail else "",
        )

    def mark_reached(
        self, *, step: Optional[int] = None, epoch: Optional[int] = None
    ) -> None:
        """Resume bookkeeping across PROCESS restarts: the in-memory
        fire ledger dies with the process, but a run that restored to
        ``step``/``epoch`` only got there because the faults scripted at
        or before that position already fired in the previous process.
        Counting them as fired here keeps the exit-75 ``--resume``
        contract live — without it, ``preempt@step=K`` would refire on
        the first post-restore step (``>=`` semantics) and the job could
        never progress past K. Called by the trainer after a successful
        restore. Step rules at ``<= step`` are exhausted up to their
        ``times`` cap. Epoch rules depend on the fault point: step-
        boundary kinds (step_fault/data_io/preempt/slow_host, and the
        membership kinds worker_lost/worker_restore, which fire at the
        same point) fire at
        the START of their epoch, so being resumed AT epoch E means an
        epoch-``<= E`` rule fired (``preempt@epoch=E`` produced this
        very resume — it must not refire and relaunch-loop); checkpoint-
        write kinds fire at the END of their epoch, whose save has only
        happened for epochs strictly before the resumed one."""
        for rule in self.rules:
            fired = _FIRE_LEDGER.get(rule.key, 0)
            if rule.times < 0 or fired >= rule.times:
                continue
            if rule.kind in _INFER_KINDS:
                # serving rules count micro-batches, not optimizer
                # steps — a training resume says nothing about them.
                continue
            at_save = rule.kind in ("ckpt_corrupt", "ckpt_truncate")
            hit = (
                rule.step is not None
                and step is not None
                and rule.step <= step
            ) or (
                rule.step is None
                and rule.epoch is not None
                and epoch is not None
                and (rule.epoch < epoch if at_save else rule.epoch <= epoch)
            )
            if hit:
                _FIRE_LEDGER[rule.key] = rule.times
                log.info(
                    "chaos: rule %s counted as already fired before the "
                    "restored position (step=%s epoch=%s)",
                    rule.key, step, epoch,
                )

    # -- fault points --------------------------------------------------------

    def on_step(
        self, *, step: Optional[int] = None, epoch: Optional[int] = None
    ) -> None:
        """Pre-dispatch fault point (raises for data_io/step_fault)."""
        for rule in self.rules:
            if (
                rule.kind not in _STEP_KINDS
                and rule.kind not in MEMBERSHIP_KINDS
                and rule.kind not in HOST_KINDS
            ):
                continue
            if not self._should_fire(rule, step, epoch):
                continue
            if rule.kind in HOST_KINDS:
                if self.on_host_membership is None:
                    raise ValueError(
                        f"chaos {rule.kind} fired with no multihost "
                        "runtime attached — host faults need the "
                        "multihost elastic loop (resilience.multihost."
                        "run_elastic_multihost with JG_MH_* ranks)"
                    )
                self._record(
                    rule, "step", step, epoch,
                    f"hosts={rule.hosts}" if rule.hosts is not None
                    else "hosts=launch",
                )
                # May SIGKILL this process (host_lost on a doomed rank).
                self.on_host_membership(
                    "lost" if rule.kind == "host_lost" else "restored",
                    hosts=rule.hosts, step=step, epoch=epoch,
                )
            elif rule.kind in MEMBERSHIP_KINDS:
                if self.on_membership is None:
                    raise ValueError(
                        f"chaos {rule.kind} fired with no elastic "
                        "supervisor attached — membership faults need "
                        "the elastic training loop (cli train --elastic "
                        "/ resilience.elastic.run_elastic)"
                    )
                self._record(
                    rule, "step", step, epoch,
                    f"world={rule.world}" if rule.world is not None
                    else "world=launch",
                )
                self.on_membership(
                    "lost" if rule.kind == "worker_lost" else "restored",
                    world=rule.world, step=step, epoch=epoch,
                )
            elif rule.kind == "slow_host":
                self._record(
                    rule, "step", step, epoch, f"stall {rule.delay_s}s"
                )
                self._stall(rule, "step", step)
            elif rule.kind == "data_io":
                self._record(rule, "step", step, epoch)
                raise ChaosIOError(
                    f"chaos: injected batch-IO failure at step {step}"
                )
            elif rule.kind == "step_fault":
                self._record(rule, "step", step, epoch)
                raise ChaosStepFault(
                    f"chaos: injected transient step fault at step {step}"
                )
            elif rule.kind == "preempt":
                self._record(rule, "step", step, epoch)
                if self.on_preempt is not None:
                    self.on_preempt(f"chaos preempt at step {step}")
                else:
                    os.kill(os.getpid(), signal.SIGTERM)

    def on_infer(self, *, step: Optional[int] = None) -> None:
        """Serving predictor-call fault point (serve/ engine): stalls
        the call (``infer_slow``) or raises :class:`ChaosInferError`
        (``infer_error``). ``step`` is the engine's micro-batch
        sequence number — the serving analogue of the optimizer step,
        so the ``@step=`` trigger grammar carries over unchanged."""
        for rule in self.rules:
            if rule.kind not in _INFER_KINDS:
                continue
            if not self._should_fire(rule, step, None):
                continue
            if rule.kind == "infer_slow":
                self._record(
                    rule, "infer", step, None, f"stall {rule.delay_s}s"
                )
                self._stall(rule, "infer", step)
            else:
                self._record(rule, "infer", step, None)
                raise ChaosInferError(
                    f"chaos: injected backend error at serve batch {step}"
                )

    def on_checkpoint_written(
        self, path: str, *,
        step: Optional[int] = None, epoch: Optional[int] = None,
    ) -> None:
        """Post-write fault point: damage the artifact in place. For a
        hardlinked latest/generation pair the in-place edit hits both —
        exactly the "this save's bytes were bad" scenario the
        generation rollback exists for."""
        for rule in self.rules:
            if rule.kind not in _CKPT_KINDS:
                continue
            if not self._should_fire(rule, step, epoch):
                continue
            victim = path
            if os.path.isdir(path):
                files = [
                    os.path.join(root, f)
                    for root, _, names in os.walk(path) for f in names
                ]
                if not files:
                    continue
                victim = max(files, key=os.path.getsize)
            size = os.path.getsize(victim)
            if rule.kind == "ckpt_truncate":
                os.truncate(victim, size // 2)
                detail = f"{victim}: {size} -> {size // 2} bytes"
            else:
                with open(victim, "r+b") as f:
                    f.seek(size // 2)
                    chunk = f.read(64) or b"\x00"
                    f.seek(size // 2)
                    f.write(bytes(b ^ 0xFF for b in chunk))
                detail = f"{victim}: flipped {min(64, size)} bytes"
            self._record(rule, "checkpoint_write", step, epoch, detail)
