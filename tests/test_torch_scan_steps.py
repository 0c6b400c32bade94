"""The port's multi-step dispatch (``TrainConfig.scan_steps``,
``device_data``; ``train.capture.TrainScan``) against the JAX package's
(``tests/test_scan_steps.py``), on the CPU, where a chunk of S steps
runs eagerly (its plain version; on a card it is one CUDA graph).

``bnn-mlp-small`` at ``infl_ratio=1``, batch 16, 96/32 examples, seed
7, dropout 0, backend xla, SGD at lr 0.01 (the update linear in the
gradient, as in ``test_torch_train``'s sgd case: Adam turns the
rounding noise of exact-zero gradients into moves of up to lr), the
JAX trainer's initial variables carried across with
``interop.params_from_jax``. The port's epoch is held to the JAX
trainer's within ``test_torch_train``'s tolerances: latents and
BatchNorm statistics atol 1e-5 (statistics also rtol 1e-5), the
epoch's mean loss and accuracy rtol 1e-5. Inside the port, with dropout
on, every dispatch mode is bitwise the per-step path: parameters,
statistics, optimizer state and the train generator.
"""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from distributed_mnist_bnns_tpu.data.common import ImageClassData as JData
from distributed_mnist_bnns_tpu.train import TrainConfig as JConfig
from distributed_mnist_bnns_tpu.train import Trainer as JTrainer
from distributed_mnist_bnns_tpu_torch.data import ImageClassData
from distributed_mnist_bnns_tpu_torch.interop import params_from_jax
from distributed_mnist_bnns_tpu_torch.models import latent_clamp_mask
from distributed_mnist_bnns_tpu_torch.resilience import Preempted
from distributed_mnist_bnns_tpu_torch.train import (
    OPTIMIZER_REGISTRY,
    TrainConfig,
    Trainer,
    make_optimizer,
    make_step_body,
    make_train_scan,
)
from distributed_mnist_bnns_tpu_torch.train.capture import optimizer_key
from distributed_mnist_bnns_tpu_torch.utils.checkpoint import read_meta

ATOL, STAT_RTOL, METRIC_RTOL = 1e-5, 1e-5, 1e-5
COMMON = dict(model="bnn-mlp-small", batch_size=16, epochs=1,
              optimizer="sgd", learning_rate=0.01, seed=7, backend="xla")
SMALL = {"infl_ratio": 1, "dropout_rate": 0.0}


def _arrays(n_train=96, n_test=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n_train, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n_train).astype(np.int32),
            rng.rand(n_test, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n_test).astype(np.int32))


def _data():
    return ImageClassData(*_arrays(), source="synthetic")


def _pair(**kw):
    """A JAX trainer and a port trainer (CPU) of the same config, the
    port starting from the JAX trainer's variables."""
    jt = JTrainer(JConfig(model_kwargs=SMALL, **COMMON, **kw))
    pt = Trainer(TrainConfig(model_kwargs=SMALL, device="cpu", **COMMON,
                             **kw))
    variables = jax.tree.map(np.asarray, {"params": jt.state.params,
                                          "batch_stats": jt.state.batch_stats})
    pt.model.load_state_dict(
        params_from_jax(variables, dropout_rate=0.0, backend="xla")
        .state_dict())
    return jt, pt


def _assert_state_close(jt, pt):
    want = params_from_jax(jax.tree.map(np.asarray, {
        "params": jt.state.params, "batch_stats": jt.state.batch_stats}),
        dropout_rate=0.0, backend="xla").state_dict()
    got = pt.model.state_dict()
    for k, v in want.items():
        if "num_batches" in k:
            continue
        torch.testing.assert_close(
            got[k], v, atol=ATOL, rtol=STAT_RTOL if "running" in k else 0.0,
            msg=lambda m: f"{k}: {m}")
    assert int(jt.state.step) == pt.step


@pytest.mark.parametrize("scan_steps,log_interval", [(3, 100), (4, 1)],
                         ids=["two-chunks", "leftover-weighted"])
def test_scan_epoch_matches_the_jax_trainer(scan_steps, log_interval):
    """scan_steps=3 (two chunks over 6 batches) and scan_steps=4 (one
    chunk and two leftover single steps, every dispatch logged, so the
    epoch's means weight the chunk by its 4 batches and each leftover by
    one) against the JAX trainer's epoch."""
    jt, pt = _pair(scan_steps=scan_steps, log_interval=log_interval)
    jdata = JData(*_arrays(), source="synthetic")
    want = jt.train_epoch(jdata, epoch=0)
    got = pt.train_epoch(_data(), epoch=0)
    assert got["steps"] == 6 == pt.step
    _assert_state_close(jt, pt)
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL)


def test_leftover_batches_all_run():
    """scan_steps=4 over 6 batches: one 4-step chunk, then two 1-step
    dispatches; all 6 steps advance the step and the optimizer."""
    pt = Trainer(TrainConfig(model_kwargs=SMALL, device="cpu", **COMMON,
                             scan_steps=4))
    pt.train_epoch(_data(), epoch=0)
    assert pt.step == 6 == pt.optimizer.steps


def test_weighted_epoch_means():
    """The epoch's loss weights each logged dispatch by its examples
    (n * batch_size), the JAX ``AverageMeter``: with every dispatch
    logged, it is the mean of the per-step losses."""
    per_step = Trainer(TrainConfig(model_kwargs=SMALL, device="cpu",
                                   log_interval=1, **COMMON))
    per_step.train_epoch(_data(), epoch=0)
    scan = Trainer(TrainConfig(model_kwargs=SMALL, device="cpu",
                               log_interval=1, scan_steps=4, **COMMON))
    row = scan.train_epoch(_data(), epoch=0)
    losses = np.asarray(per_step.loss_history, np.float64)
    assert len(scan.loss_history) == 3   # one chunk of 4, two leftovers
    assert scan.loss_history[1:] == per_step.loss_history[4:]
    np.testing.assert_allclose(
        scan.loss_history[0], np.float32(losses[:4].astype(np.float32)
                                         .mean()), rtol=1e-7)
    np.testing.assert_allclose(row["train_loss"], losses.mean(), rtol=1e-6)


def test_device_data_epoch_and_eval_match_the_jax_trainer():
    """device_data: the epoch over the dataset on the device (one gather,
    chunked dispatches, the metrics the means over every step) and the
    evaluation on the device (float32 totals over padded, masked chunks:
    batch 16 exact, batch 24 one padded chunk) against JAX's."""
    jt, pt = _pair(device_data=True)
    jdata = JData(*_arrays(), source="synthetic")
    want = jt.train_epoch(jdata, epoch=0)
    got = pt.train_epoch(_data(), epoch=0)
    assert got["steps"] == 6 and got["dispatches"] == 1
    _assert_state_close(jt, pt)
    for k in ("train_loss", "train_acc"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL)
    for bs in (16, 24):
        ev_want = jt.evaluate(jdata, batch_size=bs)
        ev_got = pt.evaluate(_data(), batch_size=bs)
        for k in ev_want:
            np.testing.assert_allclose(ev_got[k], ev_want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"{bs} {k}")


def _full_state(trainer):
    out = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    for i, st in enumerate(trainer.optimizer.state.values()):
        for k, v in st.items():
            out[f"opt{i}.{k}"] = v.clone() if torch.is_tensor(v) else v
    out["generator"] = trainer.model.train_generator("cpu").get_state()
    out["step"] = trainer.step
    return out


def _assert_bitwise(a, b):
    sa, sb = _full_state(a), _full_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        if torch.is_tensor(sa[k]):
            assert torch.equal(sa[k], sb[k]), k
        else:
            assert sa[k] == sb[k], k


DROPOUT = dict(COMMON, optimizer="adam", model_kwargs={"infl_ratio": 1},
               device="cpu")


@pytest.mark.parametrize("mode", [dict(scan_steps=2), dict(scan_steps=4),
                                  dict(device_data=True),
                                  dict(device_data=True, scan_steps=4)],
                         ids=["scan2", "scan4", "device", "device-scan4"])
def test_dispatch_modes_are_bitwise_the_per_step_path(mode):
    """Dropout 0.3 and stochastic signs on, Adam: the dispatch modes give
    the per-step path's parameters, statistics, Adam state and generator
    state exactly, over two epochs (the device-resident dataset is
    uploaded once and reused)."""
    kw = dict(DROPOUT, epochs=2,
              model_kwargs={"infl_ratio": 1, "stochastic": True})
    ref = Trainer(TrainConfig(**kw))
    other = Trainer(TrainConfig(**kw, **mode))
    data = _data()
    for epoch in range(2):
        ref.train_epoch(data, epoch)
        other.train_epoch(data, epoch)
    _assert_bitwise(ref, other)
    if mode.get("device_data"):
        assert other._device_train[0]() is data


def test_train_scan_chunk_is_its_steps():
    """``make_train_scan`` over an (S, B, ...) chunk is the per-step body S
    times, bitwise: ``scan`` gives the mean of the chunk's losses and
    ``scan.run`` the per-step ones."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(2, 3, 16, 28, 28, 1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (2, 3, 16)))
    a, b = Trainer(TrainConfig(**DROPOUT)), Trainer(TrainConfig(**DROPOUT))
    body = make_step_body(a.clamp_mask, loss_fn=a._loss_fn)
    per = torch.stack([body(a.model, a.optimizer, x[c, i], y[c, i])[0]
                       for c in range(2) for i in range(3)])
    scan = make_train_scan(b.clamp_mask, loss_fn=b._loss_fn)
    mean, _ = scan(b.model, b.optimizer, x[0], y[0])
    losses, _ = scan.run(b.model, b.optimizer, x[1], y[1])
    assert torch.equal(mean, per[:3].mean()) and torch.equal(losses, per[3:])
    assert a.optimizer.steps == b.optimizer.steps == 6
    _assert_bitwise(a, b)


def test_stop_and_resume_at_a_chunk_boundary(tmp_path):
    """A stop requested during a scan_steps=2 epoch is taken before the
    next dispatch: the mid-epoch checkpoint says batch 4, and the resume
    (scan_steps=2) ends on the uninterrupted run's state, generator
    included."""
    def trainer(ckpt, **kw):
        return Trainer(TrainConfig(**DROPOUT, scan_steps=2,
                                   checkpoint_dir=str(ckpt),
                                   handle_preemption=False, **kw))

    data = _data()
    whole = trainer(tmp_path / "whole")
    whole.fit(data, eval_every=0)
    cut = trainer(tmp_path / "cut")
    scan = cut._get_train_scan()
    run, calls = scan.run, []

    def stopping(*args):
        out = run(*args)
        calls.append(1)
        if len(calls) == 2:
            cut.stop.request("test")
        return out

    scan.run = stopping
    with pytest.raises(Preempted):
        cut.fit(data, eval_every=0)
    meta = read_meta(str(tmp_path / "cut"))
    assert meta["batch_in_epoch"] == 4 and meta["epoch_in_progress"] == 0
    resumed = trainer(tmp_path / "cut", resume=True)
    resumed.fit(data, eval_every=0)
    _assert_bitwise(whole, resumed)


@pytest.fixture
def one_rank_group(tmp_path):
    """A 1-rank gloo process group in this process, for the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("kw", [dict(scan_steps=2), dict(device_data=True),
                                dict(grad_accum=2), dict(remat=True)],
                         ids=["scan", "device_data", "grad_accum", "remat"])
def test_data_parallel_dispatch_is_not_ported(one_rank_group, kw):
    """The dispatch modes, grad_accum and remat under data parallelism
    (the test's name is older than their port there). In a 1-rank gloo
    group the trainer runs its data-parallel step, its collectives over
    the group, in each mode; an epoch is bitwise the single-process
    trainer's (``tests/test_torch_scan_dp.py`` runs 4 ranks)."""
    data = _data()
    dp = Trainer(TrainConfig(**DROPOUT, data_parallel=1, **kw))
    assert dp.distributed and dp.world == 1
    alone = Trainer(TrainConfig(**DROPOUT, **kw))
    assert not alone.distributed
    for t in (dp, alone):
        t.fit(data, eval_every=0)
    _assert_bitwise(dp, alone)


@pytest.mark.parametrize("kw", [dict(scan_steps=2), dict(device_data=True)],
                         ids=["scan", "device_data"])
def test_grad_compress_dispatch_is_not_ported(kw):
    """The 1-bit exchange in the dispatch modes (the test's name is older
    than their port): with ``scan_steps`` an epoch is bitwise the
    per-step one; ``device_data`` raises the JAX trainer's ValueError
    (the exchange does not run in the device-resident epoch)."""
    if kw.get("device_data"):
        with pytest.raises(ValueError, match="requires device_data=False"):
            Trainer(TrainConfig(**DROPOUT, grad_compress="sign", **kw))
        with pytest.raises(ValueError, match="requires device_data=False"):
            JTrainer(JConfig(model_kwargs=SMALL, grad_compress="sign",
                             **COMMON, **kw))
        return
    data = _data()
    scan = Trainer(TrainConfig(**DROPOUT, grad_compress="sign", **kw))
    step = Trainer(TrainConfig(**DROPOUT, grad_compress="sign"))
    for t in (scan, step):
        t.fit(data, eval_every=0)
    _assert_bitwise(scan, step)


@pytest.mark.parametrize("kw", [dict(scan_steps=2), dict(device_data=True)],
                         ids=["scan", "device_data"])
def test_augment_dispatch_is_bitwise_the_per_step_path(kw):
    """``augment`` (the crop and flip drawn from the model's generator
    before the forward) in the dispatch modes: bitwise the per-step path
    (parameters, statistics, Adam state, generator), and not the path
    without augment."""
    data = _data()
    scan = Trainer(TrainConfig(**DROPOUT, augment=True, **kw))
    step = Trainer(TrainConfig(**DROPOUT, augment=True))
    plain = Trainer(TrainConfig(**DROPOUT))
    for t in (scan, step, plain):
        t.fit(data, eval_every=0)
    _assert_bitwise(scan, step)
    assert not torch.equal(step.model.fc1.weight, plain.model.fc1.weight)


def test_per_epoch_learning_rates_keep_the_captured_step():
    """A captured step reads the learning rate from its scalar rows; the
    other hyperparameters are its constants, so only they key a new
    capture."""
    model = Trainer(TrainConfig(**DROPOUT)).model
    opt = make_optimizer("sgd", model.parameters(), 0.1, momentum=0.9)
    key = optimizer_key(opt)
    opt.param_groups[0]["learning_rate"] = 0.01
    assert optimizer_key(opt) == key
    opt.param_groups[0]["momentum"] = 0.5
    assert optimizer_key(opt) != key


@pytest.mark.parametrize("name", sorted(OPTIMIZER_REGISTRY))
def test_scalar_rows_step_as_step_does(name):
    """Every optimizer: three steps reading the host-filled scalar rows
    (``scalar_rows(3)``, ``step(scalars=row)``, one ``advance(3)``) are
    bitwise three plain ``step()`` calls, counters included."""
    rng = np.random.RandomState(0)
    init = [rng.randn(5, 4).astype(np.float32), rng.randn(7).astype(
        np.float32)]
    grads = [[rng.randn(*a.shape).astype(np.float32) for a in init]
             for _ in range(3)]
    out = []
    for rows in (False, True):
        ps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
        opt = make_optimizer(name, ps, 0.01)
        table = torch.from_numpy(opt.scalar_rows(3)) if rows else None
        for s in range(3):
            for p, g in zip(ps, grads[s]):
                p.grad = torch.from_numpy(g)
            if rows:
                opt.step(scalars=table[s])
            else:
                opt.step()
        if rows:
            opt.advance(3)
        out.append((ps, opt))
    (pa, oa), (pb, ob) = out
    assert oa.steps == ob.steps == 3
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)
        for k, v in oa.state[a].items():
            w = ob.state[b][k]
            assert torch.equal(v, w) if torch.is_tensor(v) else v == w, k
