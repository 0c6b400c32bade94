"""Gradient accumulation and activation recomputation in the port's step
body (``make_step_body(grad_accum=N, remat=...)``) against the JAX
package's (``tests/test_grad_accum.py``), on the CPU.

The JAX step splits the batch into N microbatches, runs them one after
another, takes the mean of their gradients for one update, moves the
BatchNorm statistics once per microbatch and reports the microbatch
means of the loss and accuracy; ``remat`` wraps the forward in
``jax.checkpoint``. The port is held to the JAX ``Trainer`` on
``bnn-mlp-small`` (``infl_ratio=1``, batch 16, dropout 0, backend xla,
SGD at lr 0.01, the JAX trainer's variables carried across), within
``test_torch_train``'s tolerances: latents and statistics atol 1e-5
(statistics also rtol 1e-5), loss rtol 1e-5, accuracy equal. Inside the
port ``remat`` is bitwise the plain step with dropout and stochastic
signs on: the recompute takes back the forward's draws (the generator
ends where the plain step leaves it) and moves no statistic again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.data.common import ImageClassData as JData
from distributed_mnist_bnns_tpu.train import TrainConfig as JConfig
from distributed_mnist_bnns_tpu.train import Trainer as JTrainer
from distributed_mnist_bnns_tpu_torch.data import ImageClassData
from distributed_mnist_bnns_tpu_torch.interop import params_from_jax
from distributed_mnist_bnns_tpu_torch.ops import remat as tremat
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

ATOL, STAT_RTOL = 1e-5, 1e-5
COMMON = dict(model="bnn-mlp-small", batch_size=16, epochs=1,
              optimizer="sgd", learning_rate=0.01, seed=7, backend="xla")
SMALL = {"infl_ratio": 1, "dropout_rate": 0.0}


def _arrays(n_train=96, n_test=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n_train, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n_train).astype(np.int32),
            rng.rand(n_test, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, n_test).astype(np.int32))


def _variables(jt):
    return jax.tree.map(np.asarray, {"params": jt.state.params,
                                     "batch_stats": jt.state.batch_stats})


def _pair(**kw):
    jt = JTrainer(JConfig(model_kwargs=SMALL, **COMMON, **kw))
    pt = Trainer(TrainConfig(model_kwargs=SMALL, device="cpu", **COMMON,
                             **kw))
    pt.model.load_state_dict(params_from_jax(
        _variables(jt), dropout_rate=0.0, backend="xla").state_dict())
    return jt, pt


def _assert_state_close(jt, pt):
    want = params_from_jax(_variables(jt), dropout_rate=0.0,
                           backend="xla").state_dict()
    got = pt.model.state_dict()
    for k, v in want.items():
        if "num_batches" in k:
            continue
        torch.testing.assert_close(
            got[k], v, atol=ATOL, rtol=STAT_RTOL if "running" in k else 0.0,
            msg=lambda m: f"{k}: {m}")


@pytest.mark.parametrize("grad_accum,remat", [(4, False), (2, True),
                                              (1, True)],
                         ids=["accum4", "accum2-remat", "remat"])
def test_step_matches_the_jax_trainer(grad_accum, remat):
    """Two steps of the port's body against the JAX trainer's jitted
    step: microbatch-mean loss and accuracy, the mean-gradient update,
    the statistics moved once per microbatch."""
    jt, pt = _pair(grad_accum=grad_accum, remat=remat)
    rng = np.random.RandomState(3)
    for _ in range(2):
        x = rng.rand(16, 28, 28, 1).astype(np.float32)
        y = rng.randint(0, 10, 16).astype(np.int32)
        jt.state, m = jt.train_step(jt.state, jnp.asarray(x),
                                    jnp.asarray(y), jt.rng)
        loss, acc = pt.train_step(pt.model, pt.optimizer,
                                  torch.from_numpy(x),
                                  torch.from_numpy(y).long())
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=1e-5)
        assert acc.item() == pytest.approx(float(m["accuracy"]), abs=1e-4)
    _assert_state_close(jt, pt)
    bn = pt.model.bn1.num_batches_tracked.item()
    assert bn == 2 * grad_accum


def test_accum_with_scan_and_epoch_matches_the_jax_trainer():
    """grad_accum=2 under scan_steps=3: accumulation leaves the step count
    alone (6 steps), and the epoch ends where JAX's does."""
    jt, pt = _pair(grad_accum=2, scan_steps=3)
    want = jt.train_epoch(JData(*_arrays(), source="synthetic"), epoch=0)
    got = pt.train_epoch(ImageClassData(*_arrays()), epoch=0)
    assert got["steps"] == 6 == pt.step == int(jt.state.step)
    _assert_state_close(jt, pt)
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-5)


def test_accum_bn_model_converges():
    """The JAX test's BatchNorm model: per-microbatch normalisation still
    trains."""
    t = Trainer(TrainConfig(model_kwargs={"infl_ratio": 1}, device="cpu",
                            grad_accum=4, **dict(COMMON, epochs=2,
                                                 optimizer="adam")))
    history = t.fit(ImageClassData(*_arrays()))
    assert history[-1]["train_loss"] < history[0]["train_loss"] * 1.5
    assert np.isfinite(history[-1]["test_loss"])


def test_accum_rejects_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible"):
        Trainer(TrainConfig(model_kwargs=SMALL, device="cpu", grad_accum=3,
                            **COMMON))


def _full_state(t):
    out = {k: v.clone() for k, v in t.model.state_dict().items()}
    for i, st in enumerate(t.optimizer.state.values()):
        out.update({f"opt{i}.{k}": v.clone() for k, v in st.items()
                    if torch.is_tensor(v)})
    out["generator"] = t.model.train_generator("cpu").get_state()
    return out


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["step", "accum2"])
@pytest.mark.parametrize("model,mk", [
    ("bnn-mlp-small", {"infl_ratio": 1, "stochastic": True}),
    ("bnn-cnn", {"stochastic": True})], ids=["mlp", "cnn"])
def test_remat_is_bitwise_the_plain_step(model, mk, grad_accum):
    """Dropout (the MLP's 0.3) and stochastic signs on, Adam: three steps
    with ``remat`` give the plain step's parameters, running statistics
    (moved once a step or microbatch: ``num_batches_tracked`` counts
    them), Adam state and generator state exactly."""
    cfg = dict(COMMON, model=model, optimizer="adam", model_kwargs=mk,
               device="cpu", grad_accum=grad_accum)
    plain = Trainer(TrainConfig(**cfg))
    rematted = Trainer(TrainConfig(**cfg, remat=True))
    rng = np.random.RandomState(5)
    for _ in range(3):
        x = torch.from_numpy(rng.rand(16, 28, 28, 1).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 10, 16))
        a = plain.train_step(plain.model, plain.optimizer, x, y)
        b = rematted.train_step(rematted.model, rematted.optimizer, x, y)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    sa, sb = _full_state(plain), _full_state(rematted)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    tracked = [v.item() for k, v in sb.items() if "num_batches" in k]
    assert tracked and set(tracked) == {3 * grad_accum}


def test_recompute_replays_the_forwards_draws():
    """Inside ``ops.remat.checkpoint`` the backward's recompute gets the
    forward's draws back and draws nothing; outside, ``rand`` draws."""
    gen = torch.Generator().manual_seed(0)
    seen = []

    def fn(x):
        noise = tremat.rand(x.shape, generator=gen)
        seen.append((noise, tremat.recomputing()))
        return (x * noise).sum()

    x = torch.ones(5, requires_grad=True)
    tremat.checkpoint(fn, x).backward()
    after = gen.get_state()
    (n1, r1), (n2, r2) = seen
    assert (r1, r2) == (False, True) and n1 is n2
    assert torch.equal(x.grad, n1)
    gen2 = torch.Generator().manual_seed(0)   # one draw of 5, not two
    torch.rand(5, generator=gen2)
    assert torch.equal(after, gen2.get_state())
    assert not tremat.recomputing()
