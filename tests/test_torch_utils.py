"""The port's utilities and retry policy against the JAX package's:
``AverageMeter``, ``ResultsLog`` (the same CSV and HTML for the same rows),
``accuracy`` (JAX's on the same logits, ties included), the logging set-up,
``StepTimer`` / ``trace`` / ``annotate``, ``classify_failure`` and
``RetryPolicy`` (the same classes, the same seeded backoff), and
``run_with_policy`` / ``run_with_recovery`` (preemptions resume without
using the failure budget, transient failures retry, fatal ones do not)."""

import logging
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.resilience import policy as jpolicy
from distributed_mnist_bnns_tpu.utils import meters as jmeters
from distributed_mnist_bnns_tpu.utils import metrics as jmetrics
from distributed_mnist_bnns_tpu.utils import results as jresults
from distributed_mnist_bnns_tpu_torch.resilience import (
    PREEMPT_EXIT_CODE,
    Preempted,
    RetryPolicy,
    StopRequest,
    TrainingFailure,
    classify_failure,
    run_with_policy,
)
from distributed_mnist_bnns_tpu_torch.utils import (
    AverageMeter,
    ResultsLog,
    StepTimer,
    accuracy,
    annotate,
    is_primary_host,
    run_with_recovery,
    setup_logging,
    trace,
)


def test_average_meter_matches_jax():
    a, b = AverageMeter(), jmeters.AverageMeter()
    for v, n in ((1.0, 1), (2.5, 3), (-0.25, 2)):
        a.update(v, n)
        b.update(v, n)
        assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count,
                                                  b.avg)


def test_results_log_writes_jax_bytes(tmp_path):
    rows = [{"epoch": 0, "train_loss": 2.5, "test_acc": 11.0},
            {"epoch": 1, "train_loss": 1.25, "test_acc": 52.5, "note": "x"}]
    ours = ResultsLog(str(tmp_path / "a" / "r.csv"))
    theirs = jresults.ResultsLog(str(tmp_path / "b" / "r.csv"))
    for row in rows:
        ours.add(**row)
        theirs.add(**row)
    ours.save("run")
    theirs.save("run")
    for name in ("r.csv", "r.html"):
        assert (tmp_path / "a" / name).read_bytes() == \
            (tmp_path / "b" / name).read_bytes()
    assert "<svg" in (tmp_path / "a" / "r.html").read_text()
    assert ResultsLog(str(tmp_path / "a" / "r.csv")).load()[1]["note"] == "x"


def test_accuracy_matches_jax_ties_included():
    rng = np.random.RandomState(0)
    logits = rng.randint(0, 4, (64, 10)).astype(np.float32)   # many ties
    target = rng.randint(0, 10, 64)
    got = accuracy(torch.from_numpy(logits), torch.from_numpy(target),
                   (1, 3, 5))
    want = jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(target),
                             (1, 3, 5))
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), abs=1e-5)


def test_logging_setup_primary_writes_the_file(tmp_path):
    root = logging.getLogger()
    saved = list(root.handlers), root.level
    try:
        assert is_primary_host()
        path = tmp_path / "logs" / "log.txt"
        setup_logging(str(path))
        logging.getLogger("x").debug("debug line")
        for h in root.handlers:
            h.flush()
        assert "debug line" in path.read_text()
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            h.close()
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])


def test_step_timer_and_trace(tmp_path):
    timer = StepTimer()
    for _ in range(3):
        timer.start()
        torch.ones(8).sum()
        assert timer.stop(sync_on="cpu") >= 0.0
    assert timer.meter.count == 3 and timer.avg >= 0.0
    with trace(None):
        pass
    log_dir = tmp_path / "trace"
    with trace(str(log_dir)):
        with annotate("region"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert any(f.endswith(".json") for f in os.listdir(log_dir))


EXCEPTIONS = [FileNotFoundError("x"), ValueError("x"), KeyError("x"),
              NotImplementedError(), KeyboardInterrupt(), SystemExit(),
              OSError("io"), RuntimeError("boom"), ConnectionError("c"),
              TimeoutError("t")]


@pytest.mark.parametrize("exc", EXCEPTIONS,
                         ids=[type(e).__name__ for e in EXCEPTIONS])
def test_classify_failure_matches_jax(exc):
    assert classify_failure(exc) == jpolicy.classify_failure(exc)
    assert classify_failure(Preempted(1, 2)) == "preempt"
    assert classify_failure(FileNotFoundError(),
                            transient_types=(FileNotFoundError,)) == \
        "transient"


def test_retry_policy_backoff_matches_jax_for_a_seed():
    ours = RetryPolicy(base_backoff_s=0.5, max_backoff_s=5.0, seed=3)
    theirs = jpolicy.RetryPolicy(base_backoff_s=0.5, max_backoff_s=5.0,
                                 seed=3)
    got = [ours.backoff(a) for a in range(1, 8)]
    assert got == [theirs.backoff(a) for a in range(1, 8)]
    assert got[-1] <= 5.0 and got[0] >= 0.25


class _Flaky:
    def __init__(self, outcomes):
        self.outcomes = list(outcomes)
        self.built = 0

    def make(self):
        self.built += 1
        return self

    def run(self, _):
        out = self.outcomes.pop(0)
        if isinstance(out, BaseException):
            raise out
        return out


def test_run_with_policy_resumes_retries_and_fails_fast():
    sleeps = []
    f = _Flaky([Preempted(0, 3), RuntimeError("io"), Preempted(1, 5), "done"])
    policy = RetryPolicy(max_restarts=1, base_backoff_s=0.1, seed=0)
    assert run_with_policy(f.make, f.run, policy=policy,
                           sleep=sleeps.append) == "done"
    assert f.built == 4 and len(sleeps) == 1   # preemptions do not sleep
    f = _Flaky([RuntimeError("a"), RuntimeError("b")])
    with pytest.raises(TrainingFailure, match="2 times"):
        run_with_policy(f.make, f.run, policy=policy, sleep=sleeps.append)
    f = _Flaky([ValueError("bad config"), "never"])
    with pytest.raises(ValueError, match="bad config"):
        run_with_policy(f.make, f.run, policy=policy, sleep=sleeps.append)
    assert f.built == 1
    f = _Flaky([Preempted(0, 1)] * 3)
    with pytest.raises(TrainingFailure, match="preempted 3 times"):
        run_with_policy(f.make, f.run,
                        policy=RetryPolicy(max_preemptions=2))


def test_run_with_recovery_shim(monkeypatch):
    monkeypatch.setattr("time.sleep", lambda s: None)
    f = _Flaky([OSError("disk"), 7])
    assert run_with_recovery(f.make, f.run, max_restarts=2,
                             backoff_s=0.0) == 7
    assert f.built == 2


def test_stop_request_signals_and_preempted_exit_code():
    assert PREEMPT_EXIT_CODE == 75 and Preempted(2, 9).exit_code == 75
    stop = StopRequest()
    with stop.install():
        os.kill(os.getpid(), signal.SIGTERM)
        assert stop.requested and "SIGTERM" in stop.reason
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)   # a second signal
    assert signal.getsignal(signal.SIGTERM) != stop._handler
