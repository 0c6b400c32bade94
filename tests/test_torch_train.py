"""The port's MLP training path (``train/trainer.py``) against the JAX
package's.

The step: ``bnn-mlp-small`` at ``infl_ratio=1`` (784-64-64-64-10),
dropout 0, deterministic signs, weights carried across with
``interop.params_from_jax``; three steps of the port's
``make_step_body`` against the JAX ``make_train_step`` on the same
batches, for sgd and adam with ce and adam with sqrt_hinge, on each of
the five backends (JAX runs the same backend for xla and bf16, and xla,
the exact oracle of every ±1 backend, for the other three). Latents and
BatchNorm statistics agree within atol 1e-5 (float32 arithmetic in two
frameworks' orders; the statistics also within rtol 1e-5, since the
first layer's running variance is ~2e2, where one float32 step is
1.5e-5) and the ±1 views are equal wherever |latent| > 1e-5. Two
exceptions are structural. A dense layer's bias
feeds a train-mode BatchNorm, which subtracts it again, so its exact
gradient is 0 and both frameworks compute rounding noise. Adam turns
that noise into moves of up to lr a step (SGD into nothing), so under
Adam those biases are held to the step bound |delta| <= 2 lr per step,
and the running means, which take the bias in, are compared with each
side's bias contribution taken out. The other is Adam's first step,
-lr g / (|g| + eps): where |g| is within a few hundred eps (here 1e-6),
the two frameworks' rounding-level gradient differences (~3e-9) become
update differences above 1e-5 (3e-5 to 9e-5 on 3 of fc1's 50176
latents on these inputs). Elements whose first gradient lies below
1e-6, at most 1% of a tensor (93 of fc1's), are held to the step bound,
the rest to atol 1e-5.

Then: the reference's STE dance against a torch oracle of it, the
learning-rate schedules against the JAX trainer's, the data order
against the JAX package's, convergence on synthetic data at the JAX
test's thresholds, two runs bitwise equal, checkpoints, and the device
rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.data import batch_iterator as jbatches
from distributed_mnist_bnns_tpu.data import shard_indices as jshard
from distributed_mnist_bnns_tpu.models import bnn_mlp_small as jax_small
from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask
from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu.train import optim as jopt
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch.data import (
    ImageClassData,
    batch_iterator,
    load_mnist,
    shard_indices,
)
from distributed_mnist_bnns_tpu_torch.interop import params_from_jax
from distributed_mnist_bnns_tpu_torch.models import latent_clamp_mask
from distributed_mnist_bnns_tpu_torch.ops import losses as tl
from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import BACKENDS
from distributed_mnist_bnns_tpu_torch.train import (
    TrainConfig,
    Trainer,
    clamp_latent,
    load_checkpoint,
    make_eval_step,
    make_optimizer,
    make_step_body,
)

ATOL = 1e-5
STAT_RTOL = 1e-5
ADAM_ILL = 100 * 1e-8   # |first gradient| below 100 Adam eps
STEPS, BATCH, LR = 3, 32, 0.01
STEP_CASES = [("sgd", "ce"), ("adam", "ce"), ("adam", "sqrt_hinge")]
BN_BIASES = ("fc1.bias", "fc2.bias", "fc3.bias")


def _np_tree(t):
    if hasattr(t, "items"):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.array(t)


def _batches():
    """MNIST-normalised pixels and labels from a numpy seed."""
    rng = np.random.RandomState(7)
    x = (rng.randint(0, 256, (STEPS, BATCH, 28, 28, 1)) / 255.0 - 0.1307)
    return (x / 0.3081).astype(np.float32), rng.randint(
        0, 10, (STEPS, BATCH)).astype(np.int32)


def _jax_model(backend):
    return jax_small(infl_ratio=1, dropout_rate=0.0, backend=backend)


@functools.lru_cache(maxsize=None)
def _jax_variables():
    model = _jax_model("xla")
    return _np_tree(model.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        jnp.zeros((2, 28, 28, 1)), train=True))


@functools.lru_cache(maxsize=None)
def _jax_run(backend, opt, loss):
    """Three JAX train steps; per step (losses, variables after it)."""
    model = _jax_model(backend)
    v = _jax_variables()
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = jopt.make_optimizer(opt, LR)
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    step = jtrainer.make_train_step(jmask(params), loss_fn=jl.make_loss(loss),
                                    donate=False)
    xs, ys = _batches()
    out = []
    for s in range(STEPS):
        state, metrics = step(state, jnp.asarray(xs[s]), jnp.asarray(ys[s]),
                              jax.random.PRNGKey(0))
        out.append((float(metrics["loss"]), float(metrics["accuracy"]),
                    _np_tree({"params": state.params,
                              "batch_stats": state.batch_stats})))
    return out


def _as_state_dict(variables):
    sd = params_from_jax(variables).state_dict()
    return {k: v for k, v in sd.items() if "num_batches" not in k}


def _port_run(backend, opt, loss):
    model = params_from_jax(_jax_variables(), dropout_rate=0.0,
                            backend=backend)
    optimizer = make_optimizer(opt, model.parameters(), LR)
    step = make_step_body(latent_clamp_mask(model),
                          loss_fn=tl.make_loss(loss))
    xs, ys = _batches()
    out = []
    for s in range(STEPS):
        lo, acc = step(model, optimizer, torch.from_numpy(xs[s]),
                       torch.from_numpy(ys[s]).long())
        sd = {k: v.detach().clone() for k, v in model.state_dict().items()
              if "num_batches" not in k}
        out.append((lo.item(), acc.item(), sd))
        if s == 0:
            first_grads = {k: p.grad.detach().clone()
                           for k, p in model.named_parameters()}
    return out, first_grads


def _bias_free_running_mean(history, name):
    """bn running mean with the dense bias's contribution taken out:
    each train step moves it by 0.1 * (batch mean of the GEMM + bias)."""
    bn = "bn" + name[2]
    rm = history[-1][2][f"{bn}.running_mean"].double()
    biases = [_as_state_dict(_jax_variables())[name].double()] + [
        h[2][name].double() for h in history[:-1]]
    for t, b in enumerate(biases):
        rm = rm - 0.1 * 0.9 ** (len(biases) - 1 - t) * b
    return rm


@pytest.mark.parametrize("opt,loss", STEP_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_three_steps_match_jax_make_train_step(backend, opt, loss):
    jax_backend = backend if backend in ("xla", "bf16") else "xla"
    want = _jax_run(jax_backend, opt, loss)
    got, first_grads = _port_run(backend, opt, loss)
    for s in range(STEPS):
        np.testing.assert_allclose(got[s][0], want[s][0], rtol=1e-5)
        assert got[s][1] == want[s][1], (s, got[s][1], want[s][1])
    w_sd = [_as_state_dict(h[2]) for h in want]
    g_sd = got[-1][2]
    adam = opt == "adam"
    step_bound = 2 * LR * STEPS
    for k, v in w_sd[-1].items():
        # BN statistics reach ~2e2 (bn1's variance), where float32's
        # spacing is 1.5e-5: held relatively as well.
        tol = dict(atol=ATOL, rtol=STAT_RTOL if "running" in k else 0.0)
        if adam and k in BN_BIASES:
            assert (g_sd[k] - v).abs().max() <= step_bound, k
        elif adam and k.endswith("running_mean"):
            fc = "fc" + k[2] + ".bias"
            torch.testing.assert_close(
                _bias_free_running_mean(got, fc),
                _bias_free_running_mean([(None, None, d) for d in w_sd], fc),
                **tol)
        elif adam and k in first_grads:
            ill = first_grads[k].abs() < ADAM_ILL
            assert ill.double().mean() <= 1e-2, (k, int(ill.sum()))
            assert bool(((g_sd[k] - v)[ill].abs() <= step_bound).all()), k
            torch.testing.assert_close(g_sd[k][~ill], v[~ill], **tol,
                                       msg=lambda m: f"{k}: {m}")
        else:
            torch.testing.assert_close(g_sd[k], v, **tol,
                                       msg=lambda m: f"{k}: {m}")
    for name in ("fc1.weight", "fc2.weight", "fc3.weight"):
        lat_w, lat_g = w_sd[-1][name], g_sd[name]
        far = lat_w.abs() > 1e-5
        assert torch.equal(torch.where(far, lat_g >= 0, True),
                           torch.where(far, lat_w >= 0, True)), name


def test_clamp_keeps_latents_in_the_unit_box():
    """A step that would push latents out of [-1, 1] clamps the binarized
    layers' weights and biases and nothing else."""
    model = params_from_jax(_jax_variables(), dropout_rate=0.0,
                            backend="xla")
    with torch.no_grad():
        model.fc2.weight[0, :4] = torch.tensor([-3.0, 0.5, 2.0, -1.0])
        model.head.weight[0, 0] = 5.0
    clamp_latent(latent_clamp_mask(model).values())
    assert model.fc2.weight[0, :4].tolist() == [-1.0, 0.5, 1.0, -1.0]
    assert model.head.weight[0, 0].item() == 5.0
    assert set(latent_clamp_mask(model)) == {
        "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias", "fc3.weight",
        "fc3.bias"}


def test_ste_dance_matches_the_reference_semantics():
    """The port's BinarizedDense + SGD + clamp against the reference's
    restore / step / clamp data-swap loop (mnist-dist2.py:131-137) as a
    plain torch oracle, step for step (the JAX package's
    ``test_ste_dance_matches_torch_semantics``)."""
    import torch.nn.functional as F

    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense

    rng = np.random.RandomState(0)
    in_dim, out_dim, bs, steps, lr = 16, 6, 8, 6, 0.2
    w0 = rng.uniform(-0.9, 0.9, size=(in_dim, out_dim)).astype(np.float32)
    b0 = rng.uniform(-0.2, 0.2, size=(out_dim,)).astype(np.float32)
    xs = rng.randn(steps, bs, in_dim).astype(np.float32)
    ys = rng.randint(0, out_dim, size=(steps, bs))

    w_t = torch.nn.Parameter(torch.tensor(w0.T.copy()))
    b_t = torch.nn.Parameter(torch.tensor(b0.copy()))
    w_org = w_t.data.clone()
    opt = torch.optim.SGD([w_t, b_t], lr=lr)

    def sign(t):
        return torch.where(t >= 0, torch.ones_like(t), -torch.ones_like(t))

    for s in range(steps):
        w_t.data = sign(w_org)
        out = F.linear(sign(torch.tensor(xs[s])), w_t) + b_t
        loss = F.cross_entropy(out, torch.tensor(ys[s]))
        opt.zero_grad()
        loss.backward()
        w_t.data.copy_(w_org)
        opt.step()
        w_org = w_t.data.clamp(-1, 1).clone()
        b_t.data.clamp_(-1, 1)

    layer = BinarizedDense(in_dim, out_dim, backend="xla")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w0.T.copy()))
        layer.bias.copy_(torch.from_numpy(b0))
    sgd = make_optimizer("sgd", layer.parameters(), lr)
    for s in range(steps):
        sgd.zero_grad()
        tl.cross_entropy_loss(layer(torch.from_numpy(xs[s])),
                              torch.from_numpy(ys[s])).backward()
        sgd.step()
        clamp_latent(latent_clamp_mask(layer).values())
    np.testing.assert_allclose(layer.weight.detach().numpy(), w_org.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(layer.bias.detach().numpy(),
                               b_t.detach().numpy(), atol=2e-5)


def _eval_inputs():
    rng = np.random.RandomState(9)
    out = rng.randn(12, 10).astype(np.float32)
    out[0, [2, 7]] = 5.0            # a tie for the top: JAX takes the last
    out[1, :] = 0.0                 # all tied
    return out, rng.randint(0, 10, 12).astype(np.int32)


def test_eval_step_sums_match_jax():
    """loss_sum, correct1, correct5 and count of the masked JAX eval on
    the same outputs, top-1 ties resolved as JAX's reversed argsort."""
    outs, labels = _eval_inputs()
    labels[0], labels[1] = 7, 9

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return x

    jloss = jl.make_loss("ce")
    state = type("S", (), {"params": {}, "batch_stats": {},
                           "apply_fn": staticmethod(
                               lambda v, x, train=False: x)})()
    valid = np.ones(12, bool)
    valid[-2:] = False
    want = jtrainer._masked_eval_body(jloss)(
        state, jnp.asarray(outs), jnp.asarray(labels), jnp.asarray(valid))
    got = make_eval_step(tl.make_loss("ce"))(
        Fixed(), torch.from_numpy(outs), torch.from_numpy(labels).long(),
        torch.from_numpy(valid))
    for k in ("correct1", "correct5", "count"):
        assert int(got[k]) == int(want[k]), k
    np.testing.assert_allclose(float(got["loss_sum"]),
                               float(want["loss_sum"]), rtol=1e-6)
    assert int(got["correct1"]) >= 2   # rows 0 and 1: the last maxima


def _jax_trainer(**kw):
    return jtrainer.Trainer(jtrainer.TrainConfig(
        model="bnn-mlp-small", backend="xla", **kw))


SCHEDULES = [
    dict(epochs=6, learning_rate=0.01, lr_decay_epochs=2),
    dict(epochs=10, learning_rate=0.1, lr_schedule="cosine"),
    dict(epochs=10, learning_rate=0.1, lr_schedule="cosine",
         warmup_epochs=3),
    dict(epochs=8, learning_rate=0.05, warmup_epochs=2, lr_decay_epochs=3,
         regime={0: {"learning_rate": 0.05}, 4: {"learning_rate": 0.2}}),
]


@pytest.mark.parametrize("sched", SCHEDULES,
                         ids=["step", "cosine", "warmup-cosine",
                              "warmup-step-regime"])
def test_lr_for_epoch_matches_the_jax_trainer(sched):
    jt = _jax_trainer(**sched)
    tt = Trainer(TrainConfig(model="bnn-mlp-small",
                             model_kwargs={"infl_ratio": 1}, device="cpu",
                             **sched))
    for e in range(sched["epochs"] + 2):
        assert tt._lr_for_epoch(e) == pytest.approx(jt._lr_for_epoch(e),
                                                    rel=1e-12), e
        tt._apply_epoch_regime(e)
        assert tt.optimizer.param_groups[0]["learning_rate"] == \
            pytest.approx(jt._lr_for_epoch(e), rel=1e-12)


@pytest.mark.parametrize("n,epoch,seed,host,hosts,shuffle", [
    (1000, 5, 9, 2, 4, True), (1001, 0, 0, 0, 1, True),
    (103, 3, 1, 1, 3, False), (60000, 1, 42, 0, 1, True)])
def test_shard_indices_match_jax(n, epoch, seed, host, hosts, shuffle):
    kw = dict(epoch=epoch, seed=seed, host_id=host, num_hosts=hosts,
              shuffle=shuffle)
    np.testing.assert_array_equal(shard_indices(n, **kw), jshard(n, **kw))


@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_matches_jax(drop_last):
    rng = np.random.RandomState(0)
    x = rng.randn(203, 4).astype(np.float32)
    y = rng.randint(0, 10, 203).astype(np.int32)
    kw = dict(epoch=2, seed=5, drop_last=drop_last)
    got = list(batch_iterator(x, y, 32, **kw))
    want = list(jbatches(x, y, 32, **kw))
    assert len(got) == len(want) == (6 if drop_last else 7)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, np.asarray(wx))
        np.testing.assert_array_equal(gy, np.asarray(wy))


def test_fit_converges_at_the_jax_tests_thresholds():
    """The JAX package's ``test_trainer_end_to_end_convergence`` on the
    port: bnn-mlp-small, one epoch of synthetic 4096/512, on the CPU."""
    data = load_mnist("/nonexistent", synthetic_sizes=(4096, 512))
    trainer = Trainer(TrainConfig(
        model="bnn-mlp-small", epochs=1, batch_size=64, learning_rate=0.01,
        log_interval=50, backend="xla", seed=0, device="cpu"))
    first = trainer.evaluate(data)
    final = trainer.fit(data)[-1]
    assert final["test_acc"] > 55.0, (data.source, final)
    assert final["test_acc"] > first["test_acc"] + 20.0
    assert final["train_loss"] < 2.0
    assert final["steps"] == 4096 // 64 == trainer.step
    assert trainer.best_acc == final["test_acc"]   # without checkpoints


def _det_run(seed=3):
    data = load_mnist("/nonexistent", synthetic_sizes=(256, 64), seed=1)
    trainer = Trainer(TrainConfig(
        model="bnn-mlp-small", epochs=1, batch_size=32, backend="xla",
        seed=seed, log_interval=1, device="cpu",
        model_kwargs={"stochastic": True}))
    trainer.fit(data, eval_every=0)
    return trainer


def test_two_runs_are_bitwise_equal():
    """Dropout (0.3) and stochastic signs on: both draw from the model's
    seeded generator, so two runs from one seed agree bitwise, and
    another seed differs."""
    a, b = _det_run(), _det_run()
    assert a.loss_history == b.loss_history and len(a.loss_history) == 8
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert _det_run(seed=4).loss_history != a.loss_history


def test_checkpoints_latest_and_best(tmp_path):
    data = load_mnist("/nonexistent", synthetic_sizes=(256, 128), seed=1)
    data = ImageClassData(data.train_images, data.train_labels,
                          data.test_images, data.test_labels)
    cfg = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
               epochs=2, batch_size=64, device="cpu",
               checkpoint_dir=str(tmp_path))
    tr = Trainer(TrainConfig(**cfg))
    hist = tr.fit(data)
    latest = load_checkpoint(str(tmp_path))
    best = load_checkpoint(str(tmp_path), best=True, model="bnn-mlp-small")
    assert latest["meta"]["epoch"] == 1 and latest["meta"]["step"] == 8
    assert int(latest["state"]["step"]) == 8
    assert latest["meta"]["best_acc"] == max(r["test_acc"] for r in hist)
    best_epoch = max(range(2), key=lambda e: hist[e]["test_acc"])
    assert int(best["state"]["step"]) == 4 * (best_epoch + 1)
    again = Trainer(TrainConfig(**cfg))
    again.restore(str(tmp_path))
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, again.model.state_dict()[k]), k
    assert again.step == 8 and again.evaluate(data) == tr.evaluate(data)
    p = next(iter(tr.model.parameters()))
    q = next(iter(again.model.parameters()))
    assert torch.equal(tr.optimizer.state[p]["mu"],
                       again.optimizer.state[q]["mu"])
    with pytest.raises(ValueError, match="holds a"):
        Trainer(TrainConfig(**dict(cfg, model="bnn-mlp-large"))).restore(
            str(tmp_path))


def test_trainer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert Trainer(TrainConfig(model="bnn-mlp-small")).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(TrainConfig(model="bnn-mlp-small"))
    assert Trainer(TrainConfig(model="bnn-mlp-small", device="cpu")
                   ).device == torch.device("cpu")


def test_trainer_leaves_the_tf32_flags_as_it_finds_them():
    """The step's fp32 products stay fp32 under PyTorch's default
    ``allow_tf32 = False``; the trainer neither needs nor writes the
    process-wide flags."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]
    assert before[0] is False
    try:
        for f in flags:
            f.allow_tf32 = True
        Trainer(TrainConfig(model="bnn-mlp-small", device="cpu"))
        assert [f.allow_tf32 for f in flags] == [True, True]
    finally:
        for f, v in zip(flags, before):
            f.allow_tf32 = v
