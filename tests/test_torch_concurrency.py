"""The port's concurrency pack at runtime (``analysis/sched.py``): the
seeded cooperative scheduler gives the JAX package's interleavings for
the same threads and seeds, the lock, condition, timeout and deadlock
behaviour of the JAX tests (tests/test_concurrency.py), and the race
regressions: the EventLog chunked write and submit-vs-``_cancel_all``
reproduced on their mutants and absent from the port's shipped shapes
(``obs/events.py``, ``serve/lm/engine.py``, ``serve/core.py``); and the
classifier server's ``/healthz``, which read the serving artifact's
family and its AOT status as two attributes that a hot reload wrote in
two stores (a torn pair), and now reads one tuple swapped in one store.
"""

import functools
import json
import os
import threading
import time

import pytest

from distributed_mnist_bnns_tpu.analysis import sched as jsched
from distributed_mnist_bnns_tpu_torch.analysis import sched as psched
from distributed_mnist_bnns_tpu_torch.analysis.lint import run_paths
from distributed_mnist_bnns_tpu_torch.analysis.sched import (
    CoopScheduler,
    DeadlockError,
    InstrumentedCondition,
    InstrumentedLock,
    TraceRecorder,
    watch_attrs,
)

PORT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "distributed_mnist_bnns_tpu_torch")
CONCURRENCY_RULES = ("JG007", "JG008", "JG009", "JG010", "JG011")


def active(findings):
    return [f for f in findings if not f.suppressed]


# --------------------------------------------------------------------------
# the scheduler: JAX's interleavings, seed for seed
# --------------------------------------------------------------------------


def _interleave_trace(scheduler_cls, seed):
    sched = scheduler_cls(seed=seed)
    order = []

    def worker(tag):
        def run():
            for i in range(3):
                order.append(f"{tag}{i}")
                sched.yield_point()
        return run

    sched.spawn(worker("a"), name="a")
    sched.spawn(worker("b"), name="b")
    sched.spawn(worker("c"), name="c")
    schedule = sched.run(timeout=10.0)
    return order, schedule


def test_coop_scheduler_interleavings_equal_jax_for_seeds_0_to_15():
    got = [_interleave_trace(CoopScheduler, s) for s in range(16)]
    want = [_interleave_trace(jsched.CoopScheduler, s) for s in range(16)]
    assert got == want
    assert len({tuple(order) for order, _ in got}) > 1   # adversarial
    assert got == [_interleave_trace(CoopScheduler, s) for s in range(16)]


def _lock_trace(mod, seed):
    """Two threads contending for one instrumented lock and condition:
    the recorded (thread, kind, name) trace."""
    sched = mod.CoopScheduler(seed=seed)
    rec = mod.TraceRecorder()
    lock = mod.InstrumentedLock("_lock", recorder=rec, scheduler=sched)
    cond = mod.InstrumentedCondition("_cond", recorder=rec, scheduler=sched)
    state = {"n": 0, "ready": False}

    def producer():
        for _ in range(2):
            with lock:
                state["n"] += 1
        with cond:
            state["ready"] = True
            cond.notify_all()

    def consumer():
        with cond:
            while not state["ready"]:
                cond.wait()
        with lock:
            state["n"] += 10

    sched.spawn(producer, name="producer")
    sched.spawn(consumer, name="consumer")
    sched.run(timeout=10.0)
    return state["n"], [(e.thread, e.kind, e.name) for e in rec.events]


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_instrumented_lock_and_condition_traces_equal_jax(seed):
    assert _lock_trace(psched, seed) == _lock_trace(jsched, seed)


# --------------------------------------------------------------------------
# the runtime behaviour of the JAX tests (test_concurrency.py:413-604)
# --------------------------------------------------------------------------


class _Tally:
    def __init__(self, lock):
        self._lock = lock
        self.n = 0

    def inc(self):
        with self._lock:
            self.n = self.n + 1

    def peek(self):
        return self.n

    def reset(self):
        self.n = 0


def test_trace_recorder_corroborates_guarded_attr_violation():
    rec = TraceRecorder()
    tally = _Tally(InstrumentedLock("_lock", recorder=rec))
    watch_attrs(tally, ["n"], rec)
    threads = [threading.Thread(target=tally.inc) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert rec.inferred_guards() == {"n": {"_lock"}}
    assert rec.guarded_violations() == []
    tally.peek()
    violations = rec.guarded_violations()
    assert len(violations) == 1
    assert violations[0].kind == "read" and violations[0].name == "n"
    tally.reset()
    assert "n" not in rec.inferred_guards()
    kinds = {v.kind for v in rec.guarded_violations({"n": {"_lock"}})}
    assert kinds == {"read", "write"}


def test_coop_scheduler_duplicate_name_raises():
    sched = CoopScheduler(seed=0)
    sched.spawn(lambda: None, name="w")
    with pytest.raises(ValueError, match="duplicate"):
        sched.spawn(lambda: None, name="w")


def test_instrumented_lock_timeout_under_scheduler_returns_false():
    sched = CoopScheduler(seed=0)
    lock = InstrumentedLock("l", scheduler=sched)
    lock._inner.acquire()
    got = {}

    def waiter():
        got["ok"] = lock.acquire(timeout=0.003)

    sched.spawn(waiter)
    sched.run(timeout=10.0)
    assert got["ok"] is False
    lock._inner.release()


def test_coop_scheduler_reraises_thread_exception():
    sched = CoopScheduler(seed=0)

    def boom():
        raise ValueError("managed thread failure")

    sched.spawn(boom)
    with pytest.raises(ValueError, match="managed thread failure"):
        sched.run(timeout=10.0)


def test_coop_scheduler_wedge_raises_deadlock_error():
    sched = CoopScheduler(seed=0)
    wall = threading.Lock()
    wall.acquire()

    def stuck():
        wall.acquire()

    sched.spawn(stuck)
    with pytest.raises(DeadlockError):
        sched.run(timeout=0.5)
    wall.release()


def test_instrumented_condition_wait_for_fails_fast_untimed():
    sched = CoopScheduler(seed=0)
    cond = InstrumentedCondition("_cond", scheduler=sched)
    got = {}

    def never_satisfied():
        with cond:
            got["ok"] = cond.wait_for(lambda: False)

    sched.spawn(never_satisfied)
    sched.run(timeout=30.0)
    assert got["ok"] is False


def test_instrumented_condition_wait_for_single_deadline():
    cond = InstrumentedCondition("_cond")
    stop = threading.Event()

    def nagger():
        for _ in range(600):
            if stop.is_set():
                return
            with cond:
                cond.notify_all()
            time.sleep(0.005)

    t = threading.Thread(target=nagger, daemon=True)
    t.start()
    try:
        start = time.monotonic()
        with cond:
            ok = cond.wait_for(lambda: False, timeout=0.2)
        elapsed = time.monotonic() - start
    finally:
        stop.set()
        t.join(10.0)
    assert ok is False
    assert elapsed < 2.0


# --------------------------------------------------------------------------
# race #1: EventLog's unlocked chunked write
# --------------------------------------------------------------------------


class _ChunkedWriteLog:
    """EventLog.emit's write path, reduced to the racy essential."""

    def __init__(self, path, lock=None, sched=None):
        self._fh = open(path, "a")
        self._lock = lock
        self._sched = sched

    def _write(self, line):
        half = len(line) // 2
        self._fh.write(line[:half])
        if self._sched is not None:
            self._sched.yield_point("between-chunks")
        self._fh.write(line[half:])
        self._fh.flush()

    def emit(self, record_json):
        if self._lock is None:      # the mutant: no lock
            self._write(record_json + "\n")
        else:                       # the shipped shape
            with self._lock:
                self._write(record_json + "\n")

    def close(self):
        self._fh.close()


_RACE_RUN_IDS = iter(range(10_000))


def _run_eventlog_race(tmp_path, seed, *, fixed):
    from distributed_mnist_bnns_tpu_torch.obs.events import read_events

    path = tmp_path / f"events_{seed}_{next(_RACE_RUN_IDS)}.jsonl"
    sched = CoopScheduler(seed=seed)
    lock = InstrumentedLock("_lock", scheduler=sched) if fixed else None
    log = _ChunkedWriteLog(str(path), lock=lock, sched=sched)

    def writer(tag):
        def run():
            for i in range(4):
                log.emit(json.dumps({"kind": "step", "who": tag, "i": i}))
        return run

    sched.spawn(writer("a"), name="writer-a")
    sched.spawn(writer("b"), name="writer-b")
    schedule = sched.run(timeout=10.0)
    log.close()
    return len(list(read_events(str(path)))), 8, schedule


def test_race_eventlog_unlocked_write_reproduced_and_fixed(tmp_path):
    runs = {s: _run_eventlog_race(tmp_path, s, fixed=False)
            for s in range(16)}
    losing = [s for s, (parsed, emitted, _) in runs.items()
              if parsed < emitted]
    assert losing, "no seed in 0..15 reproduced the interleaved write"
    first = _run_eventlog_race(tmp_path, losing[0], fixed=False)
    assert first == _run_eventlog_race(tmp_path, losing[0], fixed=False)
    assert first[0] < first[1]
    for seed in range(16):
        parsed, emitted, _ = _run_eventlog_race(tmp_path, seed, fixed=True)
        assert parsed == emitted, f"fixed log lost records at seed {seed}"


def test_shipped_eventlog_parses_clean_under_free_threading(tmp_path):
    from distributed_mnist_bnns_tpu_torch.obs.events import (
        EventLog,
        read_events,
    )

    path = tmp_path / "events.jsonl"
    log = EventLog(str(path), primary_only=False, flush_every=4)

    def worker(tag):
        for i in range(25):
            log.emit("step", who=tag, i=i)

    threads = [threading.Thread(target=functools.partial(worker, t))
               for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    log.close()
    records = [e for e in read_events(str(path)) if e["kind"] == "step"]
    assert len(records) == 100


# --------------------------------------------------------------------------
# race #2: submit vs _cancel_all stranded enqueue
# --------------------------------------------------------------------------


class _MiniEngine:
    """The submit/_cancel_all state machine of serve/lm/engine.py with
    the prefill/decode machinery stripped."""

    def __init__(self, lock, sched=None):
        self._lock = lock
        self._sched = sched
        self._queue = []
        self._closed = False
        self.shed = []

    def _yield(self, tag):
        if self._sched is not None:
            self._sched.yield_point(tag)

    def submit_mutant(self, req):
        with self._lock:
            closed = self._closed
        if closed:
            self.shed.append(req)
            return "engine_failed"
        self._yield("submit-window")
        with self._lock:
            self._queue.append(req)
        return req

    def submit_fixed(self, req):
        with self._lock:
            if self._closed:
                shed = True
            else:
                self._queue.append(req)
                shed = False
        if shed:
            self.shed.append(req)
            return "engine_failed"
        return req

    def cancel_all(self):
        with self._lock:
            self._closed = True
        self._yield("cancel-drain")
        while True:
            with self._lock:
                if not self._queue:
                    return
                req = self._queue.pop(0)
            self.shed.append(req)


def _run_submit_cancel_race(seed, *, fixed):
    sched = CoopScheduler(seed=seed)
    engine = _MiniEngine(InstrumentedLock("_lock", scheduler=sched), sched)
    submit = engine.submit_fixed if fixed else engine.submit_mutant
    sched.spawn(lambda: submit("req-1"), name="handler")
    sched.spawn(engine.cancel_all, name="drain")
    schedule = sched.run(timeout=10.0)
    return list(engine._queue), schedule


def test_race_submit_vs_cancel_all_reproduced_and_fixed():
    losing = [s for s in range(16)
              if _run_submit_cancel_race(s, fixed=False)[0]]
    assert losing, "no seed in 0..15 reproduced the stranded enqueue"
    first = _run_submit_cancel_race(losing[0], fixed=False)
    assert first == _run_submit_cancel_race(losing[0], fixed=False)
    assert first[0] == ["req-1"]
    for seed in range(16):
        stranded, _ = _run_submit_cancel_race(seed, fixed=True)
        assert stranded == [], f"fixed submit stranded a request, seed {seed}"


def test_shipped_submit_and_event_shapes_are_lint_clean():
    """The static half: the port's engine, queue and event log lint
    clean on every concurrency rule, and the engine keeps the fixed
    shape (``_cancel_all`` closes under the queue lock; ``submit``
    re-checks ``_closed`` in the acquisition that appends)."""
    import ast

    findings = run_paths(
        [os.path.join(PORT, "serve", "lm", "engine.py"),
         os.path.join(PORT, "serve", "core.py"),
         os.path.join(PORT, "obs", "events.py")],
        rule_ids=CONCURRENCY_RULES)
    assert not active(findings), [
        f"{f.path}:{f.line}: {f.rule}" for f in active(findings)]
    with open(os.path.join(PORT, "serve", "lm", "engine.py")) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}

    def closed_reads_under_lock(fn):
        return [w for w in ast.walk(fn) if isinstance(w, ast.With)
                and any(isinstance(a, ast.Attribute) and a.attr == "_closed"
                        for a in ast.walk(w))]

    assert closed_reads_under_lock(fns["_cancel_all"])
    assert closed_reads_under_lock(fns["submit"])


# --------------------------------------------------------------------------
# race #3: the classifier server's /healthz against a hot reload
# --------------------------------------------------------------------------


class _YieldOnWrite(TraceRecorder):
    """A recorder that hands the scheduler a decision before each watched
    write lands (``watch_attrs`` records a write before it stores)."""

    def __init__(self, sched):
        super().__init__()
        self.sched = sched

    def record(self, kind, name):
        ev = super().record(kind, name)
        if kind == "write":
            self.sched.yield_point(f"write:{name}")
        return ev


class _Engine:
    """What ``health`` and ``reload_artifact`` read of the engine."""

    fence_error = None
    draining = False

    def __init__(self, registry):
        self.requests_ctr = registry.counter("t_requests")
        self.shed_ctr = registry.counter("t_sheds")
        self.batches_ctr = registry.counter("t_batches")

    def swap_predictor(self, fn):
        self.fn = fn


def _healthz_during_reload(seed):
    from distributed_mnist_bnns_tpu_torch.serve.server import (
        PackedInferenceServer,
        ServeConfig,
    )

    sched = CoopScheduler(seed=seed)
    srv = PackedInferenceServer(ServeConfig(artifact="old.msgpack",
                                            device="cpu"))
    srv.engine = _Engine(srv.telemetry.registry)
    srv._load_and_warm = lambda path: (None, {"family": "old"},
                                       {"status": "hit"})
    srv.reload_artifact("old.msgpack")       # the boot's pair
    srv._load_and_warm = lambda path: (None, {"family": "new"},
                                       {"status": "miss"})
    watch_attrs(srv, ["_artifact", "artifact_info", "aot_status"],
                _YieldOnWrite(sched))
    seen = []
    sched.spawn(lambda: srv.reload_artifact("new.msgpack"), name="admin")

    def healthz():
        h = srv.health()
        seen.append((h["family"], h["aot"]))

    sched.spawn(healthz, name="healthz")
    sched.run(timeout=10.0)
    return seen[0]


def test_healthz_never_reads_a_torn_artifact_pair():
    pairs = {_healthz_during_reload(seed) for seed in range(16)}
    assert pairs <= {("old", "hit"), ("new", "miss")}, pairs
