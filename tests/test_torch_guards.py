"""The port's runtime sanitizers (``analysis/guards.py``) against the
JAX package's: the counterparts of the nine sanitizer tests of
``tests/test_analysis.py``, run on the port's trainer and engines.

The recompile fence counts what ``obs/recompile`` records after the
warm-up: CUDA-graph captures (``kind="capture"``) and kernel builds
(``kind="kernel_build"``). On the CPU nothing is captured or built, so
the cases record those kinds themselves, as ``TrainScan`` and
``ops._kernels`` do on a card; a library load and the tracker's
latency-spike guesses never count. Where both sanitizers see the same
sequence of steps, they trip at the same step. The transfer guard's
torch analogue raises on a numpy array, or on a tensor off the device,
that reaches the fenced dispatch, and passes placed tensors. An armed
LM engine (budget 0 after its warm-up) fails on a build while serving
and reports ``fence_error`` on ``/healthz``.
"""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.analysis.guards import (
    NaNFenceError as JNaNFenceError,
)
from distributed_mnist_bnns_tpu.analysis.guards import Sanitizer as JSanitizer
from distributed_mnist_bnns_tpu.analysis.guards import (
    SanitizerConfig as JSanitizerConfig,
)
from distributed_mnist_bnns_tpu_torch.analysis import (
    NaNFenceError,
    RecompileFenceError,
    Sanitizer,
    SanitizerConfig,
    TransferGuardError,
)
from distributed_mnist_bnns_tpu_torch.data import ImageClassData
from distributed_mnist_bnns_tpu_torch.obs import get_tracker
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer


class _EventCapture:
    def __init__(self):
        self.events = []

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, **fields})


class _ShapeCache:
    """A per-shape capture cache, as ``TrainScan`` keys its graphs: each
    new shape is one capture reported to the tracker."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x):
        if x.shape not in self.shapes:
            self.shapes.add(x.shape)
            get_tracker().record("capture")
        return x.sum()


def test_recompile_fence_trips_on_shape_polymorphic_capture():
    cap = _EventCapture()
    s = Sanitizer(
        SanitizerConfig(recompile_fence=True, recompile_budget=2,
                        warmup_steps=1),
        telemetry=cap,
    )
    f = _ShapeCache()
    with pytest.raises(RecompileFenceError, match="exceed the budget"):
        for n in range(2, 12):   # every call a fresh shape: a capture
            f(torch.ones(n))
            s.after_step()
    # the baseline is taken after the first step's capture; the fourth
    # shape is the third build after it, one over the budget of 2
    assert len(f.shapes) == 4
    assert cap.events and cap.events[0]["kind"] == "sanitizer_trip"
    assert cap.events[0]["fence"] == "recompile"


def test_recompile_fence_quiet_on_stable_shapes_and_other_kinds():
    """One capture, then hits: never over budget 0. Library loads and
    the tracker's spike guesses are no builds of the fence's."""
    s = Sanitizer(SanitizerConfig(recompile_fence=True, recompile_budget=0,
                                  warmup_steps=1))
    f = _ShapeCache()
    tracker = get_tracker()
    for _ in range(10):
        f(torch.ones(4))
        tracker.record("kernel_load")
        s.after_step()
    tracker.record("kernel_build")
    with pytest.raises(RecompileFenceError):
        s.after_step()


def test_transfer_guard_trips_on_host_batch_and_allows_device():
    s = Sanitizer(SanitizerConfig(transfer_guard=True))
    host_batch = np.ones((4,), np.float32)
    with pytest.raises(TransferGuardError, match="[Dd]isallowed"):
        with s.guard_transfers(host_batch, device="cpu"):
            pass
    placed = torch.from_numpy(host_batch)
    with s.guard_transfers(placed, device="cpu"):
        (placed * 2).sum()
    with pytest.raises(TransferGuardError, match="tensor on cpu"):
        with s.guard_transfers(placed, device="meta"):
            pass
    # a disabled guard is a transparent no-op
    off = Sanitizer(SanitizerConfig())
    with off.guard_transfers(host_batch, device="cpu"):
        pass


def test_nan_fence_trips_and_emits_event():
    cap = _EventCapture()
    s = Sanitizer(SanitizerConfig(nan_fence=True, nan_check_every=1),
                  telemetry=cap)
    s.after_step(1, {"loss": torch.tensor(1.0), "accuracy": 50.0})
    with pytest.raises(NaNFenceError, match="loss"):
        s.after_step(2, {"loss": torch.tensor(float("nan")),
                         "accuracy": 50.0})
    assert cap.events[-1]["fence"] == "nan"
    # off-stride steps skip the (syncing) check entirely
    s2 = Sanitizer(SanitizerConfig(nan_fence=True, nan_check_every=10))
    s2.after_step(3, {"loss": torch.tensor(float("nan"))})


@pytest.mark.parametrize("chunk,stride", [(7, 50), (4, 6), (1, 3), (8, 8)])
def test_nan_fence_stride_crosses_boundary_under_scan_chunks(chunk, stride):
    """A dispatch advancing by a chunk that never lands on the stride
    still checks when it crosses a stride boundary (7-step chunks,
    stride 50: steps 49 -> 56 cross 50), at the step JAX's fence does."""
    seen = {}
    for name, san, err, nan in (
            ("port", Sanitizer(SanitizerConfig(
                nan_fence=True, nan_check_every=stride)), NaNFenceError,
             torch.tensor(float("nan"))),
            ("jax", JSanitizer(JSanitizerConfig(
                nan_fence=True, nan_check_every=stride)), JNaNFenceError,
             np.float32(np.nan))):
        step = 0
        with pytest.raises(err):
            for _ in range(100):
                step += chunk
                san.after_step(step, {"loss": nan}, n_steps=chunk)
        seen[name] = step
    assert seen["port"] == seen["jax"] == -(-stride // chunk) * chunk


def test_sanitizer_config_from_env(monkeypatch):
    monkeypatch.setenv("JG_SANITIZE", "recompile,nan")
    monkeypatch.setenv("JG_RECOMPILE_BUDGET", "7")
    monkeypatch.setenv("JG_NAN_EVERY", "5")
    cfg = SanitizerConfig.from_env()
    assert cfg.recompile_fence and cfg.nan_fence
    assert not cfg.transfer_guard
    assert cfg.recompile_budget == 7 and cfg.nan_check_every == 5
    assert vars(cfg) == vars(JSanitizerConfig.from_env())
    monkeypatch.delenv("JG_SANITIZE")
    assert not SanitizerConfig.from_env().enabled
    with pytest.raises(ValueError, match="unknown sanitizer"):
        SanitizerConfig.from_spec("bogus")


def _data(n_train, seed):
    rng = np.random.default_rng(seed)
    return ImageClassData(
        rng.standard_normal((n_train, 28, 28, 1)).astype(np.float32),
        rng.integers(0, 10, n_train).astype(np.int32),
        rng.standard_normal((32, 28, 28, 1)).astype(np.float32),
        rng.integers(0, 10, 32).astype(np.int32),
        source="synthetic", name="mnist", n_classes=10,
    )


def test_trainer_nan_fence_trips_on_poisoned_loss(tmp_path):
    """A poisoned run (NaN learning rate -> NaN parameters -> NaN loss on
    the next step) is killed by the fence, and the event log carries the
    sanitizer_trip and error trail."""
    cfg = TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=1,
        batch_size=32, learning_rate=float("nan"), sanitize="nan",
        nan_check_every=1, telemetry_dir=str(tmp_path), log_interval=1,
        device="cpu",
    )
    with pytest.raises(NaNFenceError):
        Trainer(cfg).fit(_data(128, 0))
    events = [json.loads(line) for line in
              (tmp_path / "events.jsonl").read_text().splitlines()]
    kinds = [e["kind"] for e in events]
    assert "sanitizer_trip" in kinds and "error" in kinds
    trip = next(e for e in events if e["kind"] == "sanitizer_trip")
    assert trip["fence"] == "nan" and trip["step"] == 2


@pytest.mark.parametrize("mode", [{}, {"scan_steps": 2},
                                  {"device_data": True}],
                         ids=["step", "scan", "device_data"])
def test_trainer_runs_clean_with_all_fences(mode):
    """Every dispatch mode runs under all three fences: the step's inputs
    are placed before the guarded dispatch, and nothing builds."""
    cfg = TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=2,
        batch_size=32, sanitize="recompile,transfer,nan",
        nan_check_every=2, device="cpu", **mode,
    )
    trainer = Trainer(cfg)
    history = trainer.fit(_data(96, 1))
    assert np.isfinite(history[-1]["train_loss"])
    assert trainer.sanitizer.config.transfer_guard


def test_env_armed_fences_respect_config_budgets(monkeypatch):
    """JG_SANITIZE arms the fence, but explicit per-run budgets
    (--recompile-budget / --nan-check-every) still win."""
    monkeypatch.setenv("JG_SANITIZE", "recompile,nan")
    t = Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
        recompile_budget=2, nan_check_every=7, device="cpu",
    ))
    assert t.sanitizer.config.recompile_fence
    assert t.sanitizer.config.recompile_budget == 2
    assert t.sanitizer.config.nan_check_every == 7


def test_serve_engine_fence_fails_the_engine_after_delivery():
    """The classifier engine with a budget-0 fence: a build after the
    baseline trips at the batch's end, after its clients got their
    answers; then ``fence_error`` is set and ``submit`` sheds."""
    from distributed_mnist_bnns_tpu_torch.resilience.policy import (
        CircuitBreaker,
    )
    from distributed_mnist_bnns_tpu_torch.serve.core import (
        AdmissionQueue,
        Request,
        ServeEngine,
    )

    san = Sanitizer(SanitizerConfig(recompile_fence=True,
                                    recompile_budget=0, warmup_steps=0))
    san.pin_baseline(san.build_count())

    def predict(x):
        get_tracker().record("capture")   # a shape leak, say
        return np.zeros((x.shape[0], 10), np.float32)

    engine = ServeEngine(predict, batch_size=4, queue=AdmissionQueue(8),
                         breaker=CircuitBreaker(failure_threshold=100),
                         sanitizer=san).start()
    try:
        req = engine.submit(np.zeros((1, 4), np.float32),
                            time.monotonic() + 10)
        assert isinstance(req, Request)
        assert req.event.wait(10) and req.status == "ok"
        deadline = time.monotonic() + 10
        while engine.fence_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "exceed the budget of 0" in engine.fence_error
        assert engine.submit(np.zeros((1, 4), np.float32),
                             time.monotonic() + 10) == "engine_failed"
    finally:
        engine.stop()


def test_armed_lm_engine_reports_fence_error_on_healthz(tmp_path):
    """The LM server's engine is fenced at budget 0 after its warm-up:
    streams pass while nothing builds; a capture while serving fails
    the engine, ``/healthz`` says ``failed`` with the ``fence_error``,
    and new requests shed ``engine_failed``."""
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    path = tmp_path / "lm.msgpack"
    export_packed(BinarizedLM(
        vocab=32, max_len=32, embed_dim=32, depth=1, num_heads=2,
        mlp_ratio=2, generator=torch.Generator().manual_seed(0)).eval(),
        str(path))
    srv = LMServer(LMServeConfig(artifact=str(path), device="cpu", port=0,
                                 slots=2, page_size=4, prefill_chunk=8))
    host, port = srv.start()
    base = f"http://{host}:{port}"

    def health():
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            return json.loads(r.read())

    try:
        assert health()["fence_error"] is None
        code, events = lc.generate(base, [1, 2, 3], max_new_tokens=3)
        assert code == 200 and events[-1]["status"] == "ok"
        decode = srv.engine.decoder.decode

        def leaky(*args):   # a recapture on the serving path
            get_tracker().record("capture")
            return decode(*args)

        srv.engine.decoder = srv.engine.decoder._replace(decode=leaky)
        lc.generate(base, [4, 5, 6], max_new_tokens=3)
        deadline = time.monotonic() + 10
        while health()["fence_error"] is None:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        h = health()
        assert h["status"] == "failed"
        assert "exceed the budget of 0" in h["fence_error"]
        assert srv.engine.submit([1, 2], 2, time.monotonic() + 10) == (
            "engine_failed")
    finally:
        srv.request_stop("test over")
        srv.drain_and_stop()
