"""The port's fault injection (``resilience/chaos.py``) and its hooks,
against the JAX package's.

* The spec grammar: every rule of a set of specs parsed field for field
  as JAX's ``parse_chaos_spec`` parses it, and the malformed specs of
  the JAX tests (tests/test_resilience.py) rejected with JAX's messages.
* Replay: for seeded ``p`` rules the fire steps (and the ledger,
  ``mark_reached``, the infer point) equal JAX's controller's on the
  same calls: the rule-local ``random.Random(f"{seed}:{key}")`` is the
  JAX module's.
* The policy classifies injected faults as transient.
* ``Trainer.fit`` under ``run_with_policy`` with ``step_fault``,
  ``preempt`` and ``ckpt_corrupt`` (the preempt's save corrupted, so the
  resume rolls back a generation) ends bitwise the uninterrupted run,
  and its ``fault_injected`` events are the fires, one each.
* Both servers: the classifier's breaker trips on ``infer_error`` and
  closes again; the LM engine retries an injected error before the
  dispatch and its streams stay equal to ``generate``.
* The trainer refuses membership rules without ``elastic`` and host
  rules outside the multihost runtime, with JAX's messages.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.resilience import chaos as jchaos
from distributed_mnist_bnns_tpu.resilience import policy as jpolicy
from distributed_mnist_bnns_tpu_torch.resilience import (
    ChaosController,
    ChaosFault,
    ChaosInferError,
    ChaosStepFault,
    RetryPolicy,
    classify_failure,
    parse_chaos_spec,
    reset_fire_counts,
    run_with_policy,
)
from distributed_mnist_bnns_tpu_torch.resilience import chaos as pchaos

SPECS = [
    "step_fault@step=3; data_io@epoch=1,times=2 ;"
    "slow_host@p=0.5,delay_s=0.01,times=-1;preempt@step=9",
    "ckpt_corrupt@epoch=0;ckpt_truncate@step=4,times=3",
    "infer_error@step=4,times=3;infer_slow@p=0.1,delay_s=0.5",
    "worker_lost@step=2,world=1;worker_restore@step=5",
    "worker_restore@step=5,world=4;host_lost@step=2,hosts=1;"
    "host_restore@epoch=1,hosts=2",
    "preempt@p=0.25,times=-1;step_fault@p=0.125,times=4",
    "",
    ";;step_fault@step=0;",
]
MALFORMED = [
    "explode@step=1",          # unknown kind
    "step_fault@when=3",       # unknown key
    "step_fault@step=x",       # bad value
    "step_fault",              # no trigger
    "step_fault@step",         # not k=v
    "worker_lost@step=2",      # no world
    "worker_lost@step=2,world=0",
    "preempt@step=2,world=1",  # world on a non-membership kind
    "host_lost@step=5",        # no hosts
    "host_lost@step=5,hosts=0",
    "preempt@step=5,hosts=1",  # hosts on a non-host kind
    "worker_restore@step=1,world=-1",
]


@pytest.fixture(autouse=True)
def _fresh_ledgers():
    reset_fire_counts()
    jchaos.reset_fire_counts()
    yield
    reset_fire_counts()
    jchaos.reset_fire_counts()


@pytest.mark.parametrize("spec", SPECS)
def test_parse_equals_jax(spec):
    got = [dataclasses.asdict(r) for r in parse_chaos_spec(spec)]
    want = [dataclasses.asdict(r) for r in jchaos.parse_chaos_spec(spec)]
    assert got == want


@pytest.mark.parametrize("bad", MALFORMED)
def test_malformed_specs_raise_as_jax(bad):
    with pytest.raises(ValueError) as j:
        jchaos.parse_chaos_spec(bad)
    with pytest.raises(ValueError) as e:
        parse_chaos_spec(bad)
    assert str(e.value) == str(j.value)


def test_kind_sets_equal_jax():
    assert pchaos.FAULT_KINDS == jchaos.FAULT_KINDS
    assert pchaos.MEMBERSHIP_KINDS == jchaos.MEMBERSHIP_KINDS
    assert pchaos.HOST_KINDS == jchaos.HOST_KINDS
    assert pchaos.ENV_SPEC == jchaos.ENV_SPEC


def _drive(mod, spec, seed, steps, epochs_of=lambda s: s // 10):
    """The fire log of a controller of ``mod`` over ``steps`` step points
    and infer points: (point, step, kind) in order."""
    ctl = mod.ChaosController.from_config(spec, seed=seed)
    fired = []
    ctl.on_preempt = lambda reason: fired.append(("preempt", reason))
    ctl.on_membership = lambda ev, **k: fired.append(("member", ev, k))
    ctl.on_host_membership = lambda ev, **k: fired.append(("host", ev, k))
    log = []
    for s in range(steps):
        n = len(fired)
        try:
            ctl.on_step(step=s, epoch=epochs_of(s))
        except mod.ChaosFault as e:
            log.append(("step", s, type(e).__name__))
        log += [("step", s, f[0]) for f in fired[n:]]
        try:
            ctl.on_infer(step=s)
        except mod.ChaosFault as e:
            log.append(("infer", s, type(e).__name__))
    return log


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("spec", [
    "preempt@p=0.25,times=-1;step_fault@p=0.125,times=4",
    "data_io@p=0.3,times=3;infer_error@p=0.2,times=-1",
    "preempt@step=5;step_fault@epoch=2;worker_lost@p=0.1,world=1,times=2;"
    "host_restore@p=0.05,times=-1",
])
def test_fire_steps_equal_jax(spec, seed):
    got = _drive(pchaos, spec, seed, 60)
    want = _drive(jchaos, spec, seed, 60)
    assert got == want and got


@pytest.mark.parametrize("step,epoch", [(4, 0), (9, 1), (30, 3), (None, 2)])
def test_mark_reached_equals_jax(step, epoch):
    spec = ("preempt@step=5;step_fault@epoch=1;ckpt_corrupt@epoch=2;"
            "ckpt_truncate@step=9;infer_error@step=1;worker_lost@step=3,"
            "world=1")
    ports, jaxs = (m.ChaosController.from_config(spec, seed=0)
                   for m in (pchaos, jchaos))
    ports.mark_reached(step=step, epoch=epoch)
    jaxs.mark_reached(step=step, epoch=epoch)
    assert pchaos._FIRE_LEDGER == jchaos._FIRE_LEDGER


def test_slow_host_and_ledger_across_rebuilds():
    ctl = ChaosController.from_config("slow_host@step=1,delay_s=0.05",
                                      seed=0)
    t0 = time.monotonic()
    ctl.on_step(step=1, epoch=0)
    assert time.monotonic() - t0 >= 0.05
    again = ChaosController.from_config("slow_host@step=1,delay_s=0.05",
                                        seed=0)
    t0 = time.monotonic()
    again.on_step(step=2, epoch=0)      # exhausted in the ledger
    assert time.monotonic() - t0 < 0.05


def test_env_var_and_membership_without_supervisor(monkeypatch):
    monkeypatch.setenv("JG_CHAOS", "step_fault@step=0")
    ctl = ChaosController.from_config(None, seed=0)
    with pytest.raises(ChaosStepFault):
        ctl.on_step(step=0, epoch=0)
    assert not ChaosController.from_config("", seed=0).active
    lost = ChaosController.from_config("worker_lost@step=0,world=1")
    with pytest.raises(ValueError) as e:
        lost.on_step(step=0, epoch=0)
    jlost = jchaos.ChaosController.from_config("worker_lost@step=1,world=1")
    with pytest.raises(ValueError) as j:
        jlost.on_step(step=1, epoch=0)
    assert str(e.value) == str(j.value)


def test_checkpoint_write_faults(tmp_path):
    path = tmp_path / "ck.bin"
    data = bytes(range(256)) * 4
    path.write_bytes(data)
    ChaosController.from_config("ckpt_corrupt@epoch=0").on_checkpoint_written(
        str(path), epoch=0)
    got = path.read_bytes()
    assert len(got) == len(data) and got != data
    assert got[512:576] == bytes(b ^ 0xFF for b in data[512:576])
    path.write_bytes(data)
    ChaosController.from_config("ckpt_truncate@step=3").on_checkpoint_written(
        str(path), step=3)
    assert path.read_bytes() == data[:512]


def test_policy_classifies_chaos_as_transient():
    for exc in (ChaosStepFault("x"), pchaos.ChaosIOError("x"),
                ChaosInferError("x")):
        assert classify_failure(exc) == "transient"
        assert jpolicy.classify_failure(
            getattr(jchaos, type(exc).__name__)("x")) == "transient"
    assert isinstance(pchaos.ChaosIOError("x"), OSError)
    assert classify_failure(ValueError("x")) == "fatal"


# -- the trainer ---------------------------------------------------------------


def _data():
    from distributed_mnist_bnns_tpu_torch.data.common import ImageClassData

    rng = np.random.RandomState(0)
    return ImageClassData(
        train_images=rng.rand(256, 28, 28, 1).astype(np.float32),
        train_labels=rng.randint(0, 10, 256).astype(np.int32),
        test_images=rng.rand(64, 28, 28, 1).astype(np.float32),
        test_labels=rng.randint(0, 10, 64).astype(np.int32))


def _cfg(tmp, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig

    cfg = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1,
                                                    "dropout_rate": 0.0},
               backend="xla", optimizer="adam", learning_rate=0.003,
               batch_size=32, epochs=3, seed=0, device="cpu",
               log_interval=1, checkpoint_dir=str(tmp / "ck"),
               handle_preemption=False)
    cfg.update(kw)
    return TrainConfig(**cfg)


def _params(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


def test_fit_recovers_bitwise_and_events_match_fires(tmp_path):
    """step_fault at step 3 (the run restarts from scratch), preempt at
    step 13 whose checkpoint is corrupted (the resume rolls back to the
    epoch-0 generation): the final state is the uninterrupted run's."""
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    data = _data()
    plain = Trainer(_cfg(tmp_path / "plain"))
    plain.fit(data)
    spec = "step_fault@step=3;preempt@step=13;ckpt_corrupt@step=13"
    tel = tmp_path / "tel"
    made = []

    def make():
        made.append(Trainer(_cfg(tmp_path, resume=True, chaos=spec,
                                 telemetry_dir=str(tel))))
        return made[-1]

    run_with_policy(make, lambda t: t.fit(data),
                    policy=RetryPolicy(base_backoff_s=0.0), sleep=lambda s: 0)
    assert len(made) == 3
    last = made[-1]
    assert last.step == plain.step == 24
    want, got = _params(plain), _params(last)
    assert all(torch.equal(want[k], got[k]) for k in want)
    events = [json.loads(line) for line in open(tel / "events.jsonl")]
    faults = [e for e in events if e["kind"] == "fault_injected"]
    assert [(e["fault"], e["step"]) for e in faults] == [
        ("step_fault", 3), ("preempt", 13), ("ckpt_corrupt", 13)]
    rollbacks = [e for e in events if e["kind"] == "rollback"]
    assert len(rollbacks) == 1 and rollbacks[0]["outcome"] == "generation"
    assert [t.telemetry.registry.counter("faults_injected_total").value(
        kind="preempt") for t in made] == [0, 1, 0]


def test_trainer_rejects_membership_and_host_rules_as_jax(tmp_path):
    from distributed_mnist_bnns_tpu.train import trainer as jtrainer
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    for spec in ("worker_lost@step=1,world=1", "host_lost@step=1,hosts=1"):
        with pytest.raises(ValueError) as e:
            Trainer(_cfg(tmp_path, chaos=spec))
        with pytest.raises(ValueError) as j:
            jtrainer.Trainer(jtrainer.TrainConfig(
                model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
                batch_size=32, chaos=spec))
        assert str(e.value) == str(j.value)


def test_cli_train_chaos_preempt_exits_75_and_resumes(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    common = ["--model", "bnn-mlp-small", "--infl-ratio", "1",
              "--backend", "xla", "--device", "cpu", "--batch-size", "32",
              "--epochs", "1", "--data-dir", str(tmp_path / "none"),
              "--synthetic-sizes", "256", "64", "--no-preemption",
              "--checkpoint-dir", str(tmp_path / "ck")]
    assert main(["train", *common, "--chaos", "preempt@step=3"]) == 75
    assert main(["train", *common, "--resume",
                 "--chaos", "preempt@step=3"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["total_steps"] == 8


# -- serving -------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp_artifact(tmp_path_factory):
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import bnn_mlp_small

    model = bnn_mlp_small(infl_ratio=1,
                          generator=torch.Generator().manual_seed(0)).eval()
    path = tmp_path_factory.mktemp("chaos_serve") / "m.msgpack"
    export_packed(model, str(path))
    return str(path)


def test_classifier_breaker_trips_on_infer_error_and_recovers(mlp_artifact):
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc
    from distributed_mnist_bnns_tpu_torch.serve.core import labeled

    srv = PackedInferenceServer(ServeConfig(
        artifact=mlp_artifact, device="cpu", port=0, batch_size=4,
        breaker_threshold=3, breaker_reset_s=0.3,
        chaos="infer_error@step=0,times=3"))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    imgs = np.random.RandomState(0).rand(1, 28, 28, 1).tolist()
    try:
        for _ in range(3):
            assert sc.predict(base, imgs)[0] == 502
        assert json.loads(sc.healthz(base)[1])["breaker"] == "open"
        assert sc.predict(base, imgs)[0] == 503
        time.sleep(0.35)
        assert sc.predict(base, imgs)[0] == 200
        assert json.loads(sc.healthz(base)[1])["breaker"] == "closed"
    finally:
        srv.request_stop("test over")
        srv.drain_and_stop()
    assert labeled(srv.breaker_transitions) == {
        "to=open": 1, "to=half_open": 1, "to=closed": 1}
    assert srv.telemetry.registry.counter(
        "faults_injected_total").value(kind="infer_error") == 3


def test_lm_engine_retries_an_injected_error():
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        generate,
        make_lm_decoder,
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine
    from tests.torch_lm_util import frozen_pair, tokens

    frozen = frozen_pair(seed=0)[1]
    dec = make_paged_lm_decoder(frozen, slots=2, page_size=4,
                                prefill_chunk=8, device="cpu")
    ctl = ChaosController.from_config("infer_error@step=2,times=2", seed=0)
    eng = LMEngine(dec, queue_depth=4, chaos=ctl).start()
    prompt = tokens(3, 6)
    try:
        req = eng.submit(prompt, 5, time.monotonic() + 60)
        events = []
        while not events or events[-1]["kind"] != "done":
            events.append(req.events.get(timeout=60))
    finally:
        eng.stop()
    assert events[-1]["status"] == "ok"
    want = generate(frozen, np.asarray(prompt)[None], 5,
                    decoder=make_lm_decoder(frozen, device="cpu"))
    assert [e["token"] for e in events[:-1]] == want[0, len(prompt):].tolist()
    assert eng.errors_ctr.value(kind="ChaosInferError") == 2
    assert isinstance(ChaosInferError("x"), ChaosFault)
    assert os.environ.get("JG_CHAOS") is None
