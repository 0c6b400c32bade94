"""Frozen packed serving of the PyTorch port against the JAX package.

The JAX predictor runs its Pallas kernels with ``interpret=True``; the
port's runs on ``device="cpu"``, where the packed GEMMs take their plain
versions. Weights come from a flax init carried across with
``params_from_jax`` (see test_torch_mlp.py for why the pixels are
multiples of 1/256 and why ``atol=1e-5``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu.models import bnn_mlp_small as jax_small
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch.interop import (
    frozen_from_jax,
    params_from_jax,
)
from distributed_mnist_bnns_tpu_torch.models import bnn_mlp_small


def _np_tree(t):
    if isinstance(t, dict) or hasattr(t, "items"):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_np_tree(v) for v in t]
    return np.array(t) if hasattr(t, "shape") else t


def _variables(seed=0):
    """flax init of bnn_mlp_small(infl_ratio=1) with non-trivial BN."""
    model = jax_small(infl_ratio=1)
    v = _np_tree(model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 28, 28, 1)), train=False,
    ))
    rng = np.random.RandomState(seed)
    for i, fan_in in enumerate((784, 64, 64)):
        name = f"BatchNorm_{i}"
        scale = rng.randn(64).astype(np.float32)
        scale[::9] = 0.0
        scale[1::7] = -np.abs(scale[1::7])
        v["params"][name]["scale"] = scale
        v["params"][name]["bias"] = (rng.randn(64) * 0.5).astype(np.float32)
        v["batch_stats"][name]["mean"] = (
            rng.randn(64) * fan_in ** 0.5 / 4).astype(np.float32)
        v["batch_stats"][name]["var"] = (
            (rng.rand(64) + 0.5) * fan_in / 4).astype(np.float32)
        v["params"][f"BinarizedDense_{i}"]["bias"] = rng.randn(64).astype(
            np.float32)
    return model, v


def _pixels(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 256, (n, 28, 28, 1)) / 256.0).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, numpy variables, port model, JAX frozen log-probs)."""
    jmodel, variables = _variables()
    jfn, _ = jinfer.freeze_bnn_mlp(
        jmodel, jax.tree.map(jnp.asarray, variables), interpret=True
    )
    want = np.asarray(jfn(jnp.asarray(_pixels())))
    return jmodel, variables, params_from_jax(variables), want


def test_freeze_matches_jax(pair):
    jmodel, variables, model, want = pair
    fn, info = tinfer.freeze_bnn_mlp(model, device="cpu")
    got = fn(_pixels()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    jfrozen = jinfer._freeze_tensors(jmodel, variables)
    assert info == jfrozen["info"]
    frozen = tinfer._freeze_tensors(model)
    for tl, jl in zip(frozen["layers"], jfrozen["layers"]):
        assert (tl["k"], tl["n"]) == (jl["k"], jl["n"])
        np.testing.assert_array_equal(tl["wp"].numpy(), np.asarray(jl["wp"]))
    np.testing.assert_array_equal(frozen["w1"].numpy(),
                                  np.asarray(jfrozen["w1"]))


def test_bn_folding_matches_jax_line_for_line(pair):
    _, variables, _, _ = pair
    for i in range(3):
        name = f"BatchNorm_{i}"
        p = variables["params"][name]
        s = variables["batch_stats"][name]
        jt = {k: jnp.asarray(v) for k, v in p.items()}
        js = {k: jnp.asarray(v) for k, v in s.items()}
        tt = {k: torch.from_numpy(v) for k, v in p.items()}
        ts = {k: torch.from_numpy(v) for k, v in s.items()}
        for jf, tf in ((jinfer._bn_sign_epilogue, tinfer._bn_sign_epilogue),
                       (jinfer._bn_affine_params, tinfer._bn_affine_params)):
            for j, t in zip(jf(jt, js), tf(tt, ts)):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_frozen_from_jax_gives_the_same_predictions(pair):
    jmodel, variables, model, want = pair
    jfrozen = _np_tree(jinfer._freeze_tensors(
        jmodel, jax.tree.map(jnp.asarray, variables)))
    fn = tinfer._build_apply(frozen_from_jax(jfrozen), "cpu")
    got = fn(_pixels()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mine, _ = tinfer.freeze_bnn_mlp(model, device="cpu")
    np.testing.assert_array_equal(got, mine(_pixels()).numpy())


def test_frozen_matches_live_eval(pair):
    _, _, model, _ = pair
    fn, _ = tinfer.freeze_bnn_mlp(model, device="cpu")
    x = _pixels(32, seed=1)
    got = fn(x)
    with torch.no_grad():
        live = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), live.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(got.argmax(-1), live.argmax(-1))


def test_export_load_round_trip_bitwise(pair, tmp_path):
    _, _, model, _ = pair
    path = str(tmp_path / "m.msgpack")
    info = tinfer.export_packed(model, path)
    fn, loaded_info = tinfer.load_packed(path, device="cpu")
    assert loaded_info == info
    live_fn, _ = tinfer.freeze_bnn_mlp(model, device="cpu")
    x = _pixels(8, seed=2)
    assert torch.equal(fn(x), live_fn(x))
    disk = tinfer.load_frozen(path)
    assert disk["w1"].dtype == torch.int8
    mem = tinfer._freeze_tensors(model)
    for a, b in zip(disk["layers"], mem["layers"]):
        assert torch.equal(a["wp"], b["wp"]) and a["wp"].dtype == torch.int32


def test_freeze_from_seeded_port_model_runs():
    model = bnn_mlp_small(infl_ratio=1,
                          generator=torch.Generator().manual_seed(0)).eval()
    fn, info = tinfer.freeze_bnn_mlp(model, device="cpu")
    out = fn(torch.from_numpy(_pixels(4)))
    assert out.shape == (4, 10) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
    assert info["packed_layers"] == ["BinarizedDense_1", "BinarizedDense_2"]


def test_rejects_other_families_and_models():
    model = bnn_mlp_small(infl_ratio=1)
    frozen = tinfer._freeze_tensors(model)
    frozen["family"] = "bnn-cnn"
    with pytest.raises(ValueError, match="family"):
        tinfer._build_apply(frozen, "cpu")
    with pytest.raises(ValueError, match="BnnMLP"):
        tinfer.freeze_bnn_mlp(torch.nn.Linear(3, 3), device="cpu")


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    model = bnn_mlp_small(infl_ratio=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinfer.freeze_bnn_mlp(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinfer.resolve_device(None)
