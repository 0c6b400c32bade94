"""Importable classifier-serving saturation harness.

The port's counterpart of the JAX package's ``serve/harness.py``: the
engine's latency under load, measured in-process (no HTTP, no
subprocess) through the real admission queue, micro-batcher and deadline
machinery, at saturation. ``make_tiny_packed_predictor`` builds the
cheapest real thing the engine can dispatch: a seeded ``bnn-mlp-small``
frozen through ``infer.freeze_bnn_mlp`` (K2 and K3 on a card, their
plain versions on the CPU). ``saturation_probe`` drives a
``ServeEngine`` with it and reports exact request percentiles, shed
accounting and the batch count; the fleet's availability probe
(``serve.fleet.harness``) runs the same engines behind the router.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List

import numpy as np

from ..obs.trace import percentile as _percentile
from ..resilience.policy import CircuitBreaker
from .core import AdmissionQueue, ServeEngine


def make_tiny_packed_predictor(
    batch_size: int = 8, *, device="cuda", seed: int = 0,
):
    """A small packed bnn-mlp predictor built in-process (no disk
    artifact) on ``device``: ``bnn-mlp-small`` with weights from a
    ``torch.Generator`` seeded with ``seed``, frozen. Returns
    ``(predict_fn, input_shape)``; the warm-up call at the batch shape
    has been paid (and any kernel build with it)."""
    import torch

    from ..infer import freeze_bnn_mlp
    from ..models import get_model

    model = get_model("bnn-mlp-small", backend="xla",
                      generator=torch.Generator().manual_seed(seed))
    fn, _info = freeze_bnn_mlp(model.eval(), device=device)
    fn(np.zeros((batch_size, 28, 28, 1), np.float32)).cpu()
    return fn, (28, 28, 1)


def saturation_probe(
    predict_fn,
    *,
    batch_size: int = 8,
    input_shape=(28, 28, 1),
    n_threads: int = 8,
    duration_s: float = 2.0,
    deadline_ms: float = 2000.0,
    queue_depth: int = 16,
    linger_ms: float = 1.0,
    chaos: Any = None,
    telemetry: Any = None,
) -> Dict[str, Any]:
    """Drive a :class:`~.core.ServeEngine` at saturation and measure
    request-level latency percentiles.

    ``n_threads`` submitter threads each keep one single-example
    request in flight back to back for ``duration_s`` — with
    ``n_threads >= batch_size`` the queue never runs dry, so the
    reported p99 covers queue wait + batch assembly + dispatch, i.e.
    the number a client actually experiences under load (the
    Tail-at-Scale quantity, not the predictor's solo latency)."""
    breaker = CircuitBreaker(
        failure_threshold=1 << 30,  # measurement, not resilience
        reset_timeout_s=3600.0,
    )
    queue = AdmissionQueue(queue_depth)
    engine = ServeEngine(
        predict_fn,
        batch_size=batch_size,
        queue=queue,
        breaker=breaker,
        chaos=chaos,
        telemetry=telemetry,
        stall_timeout_s=3600.0,
        linger_s=linger_ms / 1e3,
    ).start()
    latencies: List[float] = []
    outcomes: Dict[str, int] = {}
    lock = threading.Lock()
    stop_at = time.monotonic() + duration_s

    def hammer(tid: int) -> None:
        rng = np.random.RandomState(tid)
        images = rng.randn(1, *input_shape).astype(np.float32)
        while time.monotonic() < stop_at:
            t0 = time.monotonic()
            req = engine.submit(
                images, time.monotonic() + deadline_ms / 1e3
            )
            if isinstance(req, str):   # shed
                with lock:
                    outcomes[req] = outcomes.get(req, 0) + 1
                time.sleep(0.001)      # back off a hair, stay saturated
                continue
            req.event.wait(deadline_ms / 1e3 + 1.0)
            dt = time.monotonic() - t0
            with lock:
                outcomes[req.status or "lost"] = (
                    outcomes.get(req.status or "lost", 0) + 1
                )
                if req.status == "ok":
                    latencies.append(dt)

    threads = [
        threading.Thread(target=hammer, args=(i,), daemon=True)
        for i in range(n_threads)
    ]
    t_start = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=duration_s + deadline_ms / 1e3 + 30.0)
    wall = time.monotonic() - t_start
    engine.begin_drain()
    engine.drain(timeout=10.0)
    engine.stop()
    latencies.sort()
    ok = len(latencies)
    return {
        "n_threads": n_threads,
        "batch_size": batch_size,
        "queue_depth": queue_depth,
        "duration_s": round(wall, 3),
        "requests_ok": ok,
        "outcomes": outcomes,
        "throughput_rps": round(ok / wall, 1) if wall > 0 else None,
        "p50_ms": (
            round(_percentile(latencies, 50.0) * 1e3, 3) if ok else None
        ),
        "p90_ms": (
            round(_percentile(latencies, 90.0) * 1e3, 3) if ok else None
        ),
        "p99_ms": (
            round(_percentile(latencies, 99.0) * 1e3, 3) if ok else None
        ),
        "batches": engine.batch_seq,
    }
