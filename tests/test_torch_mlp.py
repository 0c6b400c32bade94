"""BnnMLP of the PyTorch port against the JAX package's, on weights carried
across with ``interop.params_from_jax``.

The JAX model is ``bnn_mlp_small(infl_ratio=1)`` (hidden 64, 64, 64),
initialised by flax, with batch statistics and BN scales replaced by
non-trivial values: negative and exactly zero scales included.

Pixels are multiples of 1/256 in [0, 1): exact in bf16 and in fp32, and
every first-layer sum of ±pixels is a multiple of 1/256 below 2^16, so
the first GEMM is exact in any summation order on either backend. The
hidden GEMMs are exact integers. What remains is the BN arithmetic,
which rounds differently in the two frameworks, hence ``atol=1e-5``;
on these seeded inputs no threshold sign flips, so argmax is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.models import bnn_mlp_small as jax_small
from distributed_mnist_bnns_tpu_torch.interop import (
    params_from_jax,
    variables_from_npz,
)
from distributed_mnist_bnns_tpu_torch.models import (
    BnnMLP,
    bnn_mlp_large,
    bnn_mlp_small,
    get_model,
    list_models,
)


def _np_tree(t):
    if hasattr(t, "items"):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.array(t)


def jax_variables(model, seed=0):
    """flax init, then non-trivial BN scales and running statistics."""
    x = jnp.zeros((2, 28, 28, 1), jnp.float32)
    variables = _np_tree(model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        x, train=False,
    ))
    rng = np.random.RandomState(seed)
    for i in range(3):
        name = f"BatchNorm_{i}"
        c = variables["params"][name]["scale"].shape[0]
        fan_in = 784 if i == 0 else 64
        scale = rng.randn(c).astype(np.float32)
        scale[::9] = 0.0
        variables["params"][name]["scale"] = scale
        variables["params"][name]["bias"] = (rng.randn(c) * 0.5).astype(
            np.float32)
        variables["batch_stats"][name]["mean"] = (
            rng.randn(c) * fan_in ** 0.5 / 4).astype(np.float32)
        variables["batch_stats"][name]["var"] = (
            (rng.rand(c) + 0.5) * fan_in / 4).astype(np.float32)
    for i in range(3):
        name = f"BinarizedDense_{i}"
        b = variables["params"][name]["bias"]
        variables["params"][name]["bias"] = rng.randn(*b.shape).astype(
            np.float32)
    return variables


def pixels(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 28, 28, 1)) / 256.0).astype(np.float32)


@pytest.mark.parametrize("backend", ["bf16", "xla"])
def test_eval_log_probs_match_jax(backend):
    jmodel = jax_small(infl_ratio=1, backend=backend)
    variables = jax_variables(jmodel)
    x = pixels(16)
    want = np.asarray(jmodel.apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=False
    ))
    model = params_from_jax(variables, backend=backend)
    assert model.hidden == (64, 64, 64) and not model.training
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert len(np.unique(got.argmax(-1))) > 1


def test_params_from_jax_layouts_and_npz_round_trip(tmp_path):
    variables = jax_variables(jax_small(infl_ratio=1), seed=3)
    model = params_from_jax(variables)
    k0 = variables["params"]["BinarizedDense_0"]["kernel"]
    np.testing.assert_array_equal(model.fc1.weight.detach().numpy(), k0.T)
    head = variables["params"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(model.head.weight.detach().numpy(), head.T)
    np.testing.assert_array_equal(
        model.bn2.running_var.numpy(),
        variables["batch_stats"]["BatchNorm_1"]["var"],
    )
    flat = {
        f"{col}/{layer}/{leaf}": v
        for col, layers in variables.items()
        for layer, leaves in layers.items()
        for leaf, v in leaves.items()
    }
    path = tmp_path / "vars.npz"
    np.savez(path, **flat)
    again = params_from_jax(variables_from_npz(str(path)))
    for (ka, va), (kb, vb) in zip(model.state_dict().items(),
                                  again.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_structure_follows_the_reference():
    gen = torch.Generator().manual_seed(0)
    model = bnn_mlp_small(infl_ratio=1, generator=gen)
    assert isinstance(model, BnnMLP)
    assert not model.fc1.binarize_input and model.fc2.binarize_input
    for bn in (model.bn1, model.bn2, model.bn3):
        assert bn.eps == 1e-5 and bn.momentum == 0.1  # flax momentum 0.9
    # dropout sits before bn3
    names = [n for n, _ in model.named_children()]
    assert names.index("dropout") < names.index("bn3")
    bound = 1.0 / 784 ** 0.5
    assert model.fc1.weight.abs().max() <= bound
    assert bnn_mlp_large().hidden == (3072, 1536, 768)
    assert list_models() == ["bnn-cnn", "bnn-mlp-large", "bnn-mlp-small",
                             "convnet", "deep-cnn", "fp32-mlp-large"]
    assert get_model("bnn-mlp-small", infl_ratio=1).hidden == (64, 64, 64)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("xnor-resnet18")


def test_seeded_init_is_reproducible():
    a = bnn_mlp_small(infl_ratio=1, generator=torch.Generator().manual_seed(5))
    b = bnn_mlp_small(infl_ratio=1, generator=torch.Generator().manual_seed(5))
    for va, vb in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(va, vb)


def test_weight_gradient_is_straight_through():
    """Training-mode forward + backward runs, and the latent weights get
    the identity-STE gradient of the ±1 GEMM."""
    model = bnn_mlp_small(infl_ratio=1,
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(pixels(8))
    model.train()(x).sum().backward()
    assert model.fc2.weight.grad is not None
    assert torch.isfinite(model.fc2.weight.grad).all()
    assert model.fc2.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("backend", ["bf16", "xla"])
def test_train_mode_batch_norm_matches_flax(backend):
    """Train mode: flax's BatchNorm normalises with the fast variance and
    moves the running variance towards the biased one. The new running
    statistics equal flax's ``batch_stats`` and the log-probs agree
    (dropout off on both sides: it draws from different generators)."""
    jmodel = jax_small(infl_ratio=1, backend=backend, dropout_rate=0.0)
    variables = jax_variables(jmodel, seed=2)
    x = pixels(32, seed=2)
    want, upd = jmodel.apply(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(x), train=True,
        mutable=["batch_stats"],
    )
    model = params_from_jax(variables, backend=backend,
                            dropout_rate=0.0).train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    for i, bn in enumerate((model.bn1, model.bn2, model.bn3)):
        stats = upd["batch_stats"][f"BatchNorm_{i}"]
        old = variables["batch_stats"][f"BatchNorm_{i}"]
        assert not np.array_equal(bn.running_var.numpy(), old["var"])
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   np.asarray(stats["mean"]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   np.asarray(stats["var"]), rtol=1e-6)
        assert int(bn.num_batches_tracked) == 1


def test_train_mode_variance_is_the_biased_fast_one():
    """The stored statistic is the biased batch variance (torch's
    ``BatchNorm1d`` stores the unbiased one), computed as
    ``max(0, mean(x^2) - mean(x)^2)``."""
    from distributed_mnist_bnns_tpu_torch.models.mlp import BatchNorm

    bn = BatchNorm(3, eps=1e-5, momentum=0.1).train()
    x = torch.tensor([[1.0, 2.0, 5.0], [3.0, 2.0, -1.0]])
    y = bn(x)
    var = torch.clamp((x * x).mean(0) - x.mean(0) ** 2, min=0.0)
    assert torch.equal(bn.running_var, 0.9 * torch.ones(3) + 0.1 * var)
    assert torch.equal(bn.running_mean, 0.1 * x.mean(0))
    assert torch.equal(y[:, 1], torch.zeros(2))  # a constant column
    assert isinstance(bn, torch.nn.BatchNorm1d)
    assert list(bn.state_dict()) == list(
        torch.nn.BatchNorm1d(3).state_dict())


def _exact_unit_preactivations(variables, x0, backend):
    """Make sample ``x0``'s pre-activations exactly +-1 on 8 channels of
    each BatchNorm: the dense bias there cancels the ±1 sum exactly (an
    integer, or a multiple of 1/256 in the first layer), the running
    mean is 0 and the BN bias +-1, with non-zero scales. Any order of BN
    arithmetic then gives exactly the bias."""
    ch = np.arange(8) * 7
    for i in range(3):
        model = params_from_jax(variables, backend=backend)
        with torch.no_grad():
            h = torch.from_numpy(x0).reshape(1, -1)
            for j, (fc, bn) in enumerate(((model.fc1, model.bn1),
                                          (model.fc2, model.bn2),
                                          (model.fc3, model.bn3))):
                if j == i:
                    fc.bias.zero_()
                    sums = fc(h)[0].numpy()
                    break
                h = torch.clamp(bn(fc(h)), -1.0, 1.0)
        variables["params"][f"BinarizedDense_{i}"]["bias"][ch] = -sums[ch]
        name = f"BatchNorm_{i}"
        variables["batch_stats"][name]["mean"][ch] = 0.0
        variables["params"][name]["scale"][ch] = np.float32(0.75)
        variables["params"][name]["bias"][ch] = np.where(
            ch % 2 == 0, 1.0, -1.0).astype(np.float32)
    return variables


@pytest.mark.parametrize("backend", ["bf16", "xla"])
def test_input_gradient_at_exact_unit_preactivations(backend, monkeypatch):
    """flax's hard_tanh passes the gradient at exactly +-1; the port's
    activation does too, so its input gradient equals ``jax.grad``'s.
    With ``F.hardtanh`` (gradient 0 there) it would not."""
    import distributed_mnist_bnns_tpu_torch.models.mlp as tmlp

    jmodel = jax_small(infl_ratio=1, backend=backend)
    x = pixels(4, seed=5)
    variables = _exact_unit_preactivations(
        jax_variables(jmodel, seed=5), x[:1], backend)
    gw = np.random.RandomState(6).randn(4, 10).astype(np.float32)
    jv = jax.tree.map(jnp.asarray, variables)

    def jloss(xx):
        return (jmodel.apply(jv, xx, train=False) * gw).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    model = params_from_jax(variables, backend=backend)
    hidden = {}
    for name in ("bn1", "bn2", "bn3"):
        getattr(model, name).register_forward_hook(
            lambda mod, inp, out, name=name: hidden.__setitem__(name, out))

    def grad():
        xt = torch.from_numpy(x).requires_grad_()
        (model(xt) * torch.from_numpy(gw)).sum().backward()
        return xt.grad.numpy()

    got = grad()
    for name in ("bn1", "bn2", "bn3"):
        pre = hidden[name][0, np.arange(8) * 7]
        assert torch.equal(pre.abs(), torch.ones(8)), (name, pre)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    monkeypatch.setattr(tmlp, "hard_tanh", torch.nn.functional.hardtanh)
    assert not np.allclose(grad(), want, rtol=1e-5, atol=1e-6)


def _dropout_io(rng_seed, calls=1):
    """(input, output) of the MLP's dropout on its last train forward."""
    model = bnn_mlp_small(infl_ratio=1, rng_seed=rng_seed,
                          generator=torch.Generator().manual_seed(0))
    seen = {}
    model.dropout.register_forward_hook(
        lambda mod, args, out: seen.update(x=args[0], y=out))
    x = torch.from_numpy(pixels(16))
    for _ in range(calls):
        torch.manual_seed(np.random.randint(1 << 30))  # the global RNG
        model.train()(x)
    return seen["x"].detach(), seen["y"].detach()


def test_dropout_draws_from_the_models_seeded_generator():
    """Dropout (rate 0.3, before bn3) draws its mask from the model's own
    generator, seeded with ``rng_seed``: two models of one seed drop the
    same units whatever the global RNG does, another seed drops others,
    and successive forwards draw new masks. Kept units are divided by
    0.7, as flax's ``nn.Dropout`` does."""
    x_a, y_a = _dropout_io(5)
    x_b, y_b = _dropout_io(5)
    assert torch.equal(x_a, x_b) and torch.equal(y_a, y_b)
    dropped = (y_a == 0) & (x_a != 0)
    assert 0.2 < dropped.float().mean().item() < 0.4
    kept = ~dropped & (x_a != 0)
    assert torch.equal(y_a[kept], x_a[kept] / 0.7)
    _, y_c = _dropout_io(6)
    assert not torch.equal(y_a == 0, y_c == 0)
    _, y_twice = _dropout_io(5, calls=2)
    assert not torch.equal(y_a == 0, y_twice == 0)
    model = bnn_mlp_small(infl_ratio=1, rng_seed=5).eval()
    x = torch.from_numpy(pixels(4))
    assert torch.equal(model(x), model(x))
