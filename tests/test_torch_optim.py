"""The port's optimizers (``train/optim.py``) against the JAX package's
optax ones: each of the ten registry names, three steps on the same
parameter tree and gradients, at rtol 1e-5 and atol 1e-7 (float32 update
arithmetic in two frameworks; the norms of lars and lamb sum in other
orders); global-norm clipping against ``optax.clip_by_global_norm``;
sticky regimes, in-place retunes that keep the moments and optimizer
switches that reset them (the JAX package's ``tests/test_train.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_mnist_bnns_tpu.train import optim as jopt
from distributed_mnist_bnns_tpu_torch.train import optim as topt

RTOL, ATOL = 1e-5, 1e-7
SHAPES = {"a": (5, 4), "b": (7,), "c": (3, 2, 2)}
STEPS = 3


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step):
    """Gradients whose signs flip and repeat across steps (rprop's
    three cases) with exact zeros in places."""
    g = _tree(100 + step)
    g["b"][:2] = 0.0
    if step == 1:
        g["a"][0] = -g["a"][0]
    return g


def _run_jax(name, lr, kwargs, clip=None, params=None):
    tx = jopt.make_optimizer(name, lr, clip_grad_norm=clip, **kwargs)
    params = {k: jnp.asarray(v) for k, v in (params or _tree(0)).items()}
    state = tx.init(params)
    out = []
    for s in range(STEPS):
        grads = {k: jnp.asarray(v) for k, v in _grads(s).items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out, state


def _run_port(name, lr, kwargs, clip=None, params=None):
    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in (params or _tree(0)).items()}
    opt = topt.make_optimizer(name, list(ps.values()), lr,
                              clip_grad_norm=clip, **kwargs)
    out = []
    for s in range(STEPS):
        for k, g in _grads(s).items():
            ps[k].grad = torch.from_numpy(g)
        opt.step()
        out.append({k: p.detach().numpy().copy() for k, p in ps.items()})
    return out, opt, ps


CASES = [
    ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("asgd", {}), ("adam", {}), ("adam", {"b1": 0.8, "eps": 1e-6}),
    ("adamax", {}), ("adagrad", {}), ("adadelta", {}),
    ("adadelta", {"weight_decay": 0.01}), ("rprop", {}), ("rmsprop", {}),
    ("rmsprop", {"momentum": 0.5}), ("lars", {}),
    ("lars", {"weight_decay": 0.01, "momentum": 0.8}), ("lamb", {}),
    ("lamb", {"weight_decay": 0.01}),
]


def test_the_registry_holds_the_ten_jax_names():
    assert sorted(topt.OPTIMIZER_REGISTRY) == sorted(jopt.OPTIMIZER_REGISTRY)
    assert len(topt.OPTIMIZER_REGISTRY) == 10
    for name, _ in CASES:
        assert name in topt.OPTIMIZER_REGISTRY
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("nope", [torch.nn.Parameter(torch.ones(2))], 0.1)


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{'-'.join(k) or 'default'}"
                              for n, k in CASES])
def test_three_steps_match_optax(name, kwargs):
    want, _ = _run_jax(name, 0.05, kwargs)
    got, _, _ = _run_port(name, 0.05, kwargs)
    for s in range(STEPS):
        for k in SHAPES:
            np.testing.assert_allclose(
                got[s][k], want[s][k], rtol=RTOL, atol=ATOL,
                err_msg=f"{name} {kwargs} step {s} leaf {k}")


def test_asgd_keeps_the_polyak_average():
    """The JAX package's asgd check: three steps of -0.5 from 0, and the
    average over the three visited points."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = topt.make_optimizer("asgd", [p], 0.5)
    for _ in range(3):
        p.grad = torch.ones(2)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -1.5)
    np.testing.assert_allclose(opt.state[p]["avg"].numpy(), -1.0, rtol=1e-6)
    _, state = _run_jax("asgd", 0.05, {})
    _, opt, ps = _run_port("asgd", 0.05, {})
    for k, prm in ps.items():
        np.testing.assert_allclose(opt.state[prm]["avg"].numpy(),
                                   np.asarray(state.inner_state.avg[k]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    """Scaled by max_norm / norm only when norm >= max_norm (torch's
    clip_grad_norm_ divides by norm + 1e-6 always)."""
    grads = _grads(0)
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = topt.clip_by_global_norm(
        [torch.from_numpy(grads[k]) for k in SHAPES], max_norm)
    for k, g in zip(SHAPES, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=RTOL, atol=ATOL)
    if max_norm > 10:
        for k, g in zip(SHAPES, got):
            assert np.array_equal(g.numpy(), grads[k])


@pytest.mark.parametrize("name", ["sgd", "adam", "lamb"])
def test_clipped_steps_match_optax(name):
    want, _ = _run_jax(name, 0.05, {}, clip=0.5)
    got, _, _ = _run_port(name, 0.05, {}, clip=0.5)
    for s in range(STEPS):
        for k in SHAPES:
            np.testing.assert_allclose(got[s][k], want[s][k], rtol=RTOL,
                                       atol=ATOL)
    with pytest.raises(ValueError, match="clip_grad_norm"):
        topt.make_optimizer(name, [torch.nn.Parameter(torch.ones(1))], 0.1,
                            clip_grad_norm=0.0)


def test_regime_sticky_merge():
    sched = topt.RegimeSchedule({0: {"optimizer": "adam",
                                     "learning_rate": 0.01},
                                 10: {"learning_rate": 0.001},
                                 20: {"optimizer": "sgd"}})
    assert sched.config_at(5) == {"optimizer": "adam", "learning_rate": 0.01}
    assert sched.config_at(15)["learning_rate"] == 0.001
    assert sched.config_at(25)["optimizer"] == "sgd"
    assert not sched.optimizer_changed(15)
    assert sched.optimizer_changed(20)
    calls = topt.RegimeSchedule(lambda e: {"momentum": 0.5} if e == 2 else {})
    assert calls.config_at(1) == {} and calls.config_at(4) == {
        "momentum": 0.5}
    assert topt.regime_hp_kwargs("sgd", {"momentum": 0.8, "b1": 0.99,
                                         "learning_rate": 1.0}) == {
        "momentum": 0.8}
    assert topt.regime_hp_kwargs("adam", {"momentum": 0.8, "b1": 0.99}) == {
        "b1": 0.99}


def test_in_place_momentum_retune_keeps_the_moments():
    """momentum materialised as 0.0 and retuned to 0.9 in the param
    group, as the JAX package writes the injected hyperparameter: step 1
    moves -0.1, step 2 -(1 + 0.9) * 0.1, from the kept trace."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = topt.make_optimizer("sgd", [p], 0.1)
    assert opt.param_groups[0]["momentum"] == 0.0
    p.grad = torch.ones(2)
    opt.step()
    trace = opt.state[p]["trace"]
    topt.RegimeSchedule({0: {"momentum": 0.9}}).apply_hyperparams(opt, 0)
    assert opt.param_groups[0]["momentum"] == 0.9
    assert torch.equal(opt.state[p]["trace"], trace)
    p.grad = torch.ones(2)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -0.29, rtol=1e-6)
    # and optax, retuned the same way
    tx = jopt.make_optimizer("sgd", 0.1)
    params = {"w": jnp.zeros(2)}
    state = tx.init(params)
    updates, state = tx.update({"w": jnp.ones(2)}, state, params)
    params = optax.apply_updates(params, updates)
    state.hyperparams["momentum"] = jnp.asarray(0.9, jnp.float32)
    updates, state = tx.update({"w": jnp.ones(2)}, state, params)
    params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]),
                               rtol=RTOL)


def _small_trainer(**kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
               epochs=3, device="cpu")
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def test_trainer_regime_retunes_momentum_in_place():
    tr = _small_trainer(optimizer="sgd", learning_rate=0.1,
                        regime={1: {"momentum": 0.9}})
    tr._apply_epoch_regime(0)
    group = tr.optimizer.param_groups[0]
    assert group["momentum"] == pytest.approx(0.0)
    p = next(iter(tr.model.parameters()))
    tr.optimizer.state[p]["trace"].fill_(0.25)
    opt = tr.optimizer
    tr._apply_epoch_regime(1)
    assert tr.optimizer is opt
    group = tr.optimizer.param_groups[0]
    assert group["momentum"] == pytest.approx(0.9)
    assert group["learning_rate"] == pytest.approx(0.1)
    assert bool((tr.optimizer.state[p]["trace"] == 0.25).all())


def test_trainer_regime_optimizer_switch_resets_and_carries_hyperparams():
    tr = _small_trainer(optimizer="adam", learning_rate=0.01,
                        regime={2: {"optimizer": "sgd", "learning_rate": 0.05,
                                    "momentum": 0.8, "b1": 0.99}})
    p = next(iter(tr.model.parameters()))
    tr.optimizer.state[p]["mu"].fill_(1.0)
    tr._apply_epoch_regime(1)
    assert isinstance(tr.optimizer, topt.Adam)
    tr._apply_epoch_regime(2)
    assert isinstance(tr.optimizer, topt.SGD)
    assert tr.optimizer_name == "sgd"
    group = tr.optimizer.param_groups[0]
    assert group["momentum"] == pytest.approx(0.8)
    assert group["learning_rate"] == pytest.approx(0.05)
    assert "b1" not in group
    assert not bool(tr.optimizer.state[p]["trace"].any())
    assert {id(q) for q in tr.optimizer.param_groups[0]["params"]} == {
        id(q) for q in tr.model.parameters()}
