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
    assert list_models() == ["bnn-mlp-large", "bnn-mlp-small"]
    assert get_model("bnn-mlp-small", infl_ratio=1).hidden == (64, 64, 64)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("bnn-cnn")


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
