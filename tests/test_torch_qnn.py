"""The k-bit QNN family of the PyTorch port (``QuantizedDense``,
``QnnMLP``, ``qnn-mlp-large``, ``infer_qnn``) against the JAX package's.

Inputs come from numpy seeds and weights cross with ``interop``. The
tolerances: the live forward and its gradients are fp32 GEMMs of
quantized values summed in another order than XLA's (atol 1e-5 on the
log-probs and gradients of these widths, measured ~1e-6); the frozen
path's int8 inputs and int32 sums are bitwise JAX's, its fp32 first
layer and head leave 1e-5; frozen against the live eval forward 1e-4,
JAX's own test's tolerance (the live BN is not the frozen affine).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.infer import export_packed as jexport
from distributed_mnist_bnns_tpu.infer import load_packed as jload
from distributed_mnist_bnns_tpu.infer import _bn_affine_params as jaffine
from distributed_mnist_bnns_tpu.infer_qnn import (
    _freeze_qnn_tensors as jfreeze,
)
from distributed_mnist_bnns_tpu.models.layers import (
    QuantizedDense as JQuantizedDense,
)
from distributed_mnist_bnns_tpu.models.mlp import QnnMLP as JQnnMLP
from distributed_mnist_bnns_tpu.ops.binarize import quantize as jquantize
from distributed_mnist_bnns_tpu.ops.losses import cross_entropy_loss
from distributed_mnist_bnns_tpu.parallel.model_parallel import (
    tp_rules_for as jtp_rules_for,
)
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.infer import (
    _freeze_any,
    export_packed,
    load_frozen,
    load_packed,
)
from distributed_mnist_bnns_tpu_torch.infer_qnn import (
    FrozenQNN,
    freeze_qnn_mlp,
)
from distributed_mnist_bnns_tpu_torch.interop import (
    flax_params,
    frozen_from_jax,
    frozen_to_jax,
    params_from_jax,
    params_to_jax,
)
from distributed_mnist_bnns_tpu_torch.models import (
    QnnMLP,
    QuantizedDense,
    get_model,
    latent_clamp_mask,
)
from distributed_mnist_bnns_tpu_torch.ops.losses import (
    cross_entropy_loss as tce,
)
from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import int8_matmul
from distributed_mnist_bnns_tpu_torch.parallel.model_parallel import (
    tp_rules_for,
)
from tests.infer_train_util import trained_variables

HIDDEN = (96, 64, 48)
ATOL = 1e-5
FROZEN_LIVE_ATOL = 1e-4


def _np_tree(t):
    """Array leaves as numpy arrays; ints, strings and dicts kept."""
    return jax.tree.map(
        lambda a: np.array(a) if hasattr(a, "shape") else a, t)


def _images(n=16, seed=3):
    return np.random.RandomState(seed).randn(n, 28, 28, 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _trained(num_bits=8):
    """A JAX QnnMLP after three clamped Adam steps (non-trivial latents
    and BatchNorm statistics), as numpy trees."""
    model = JQnnMLP(hidden=HIDDEN, num_bits=num_bits, dropout_rate=0.0)
    x = jnp.asarray(_images())
    labels = jnp.asarray(np.random.RandomState(4).randint(0, 10, 16))
    variables = trained_variables(
        model, x, lambda out: cross_entropy_loss(out, labels))
    return model, _np_tree(variables)


def _port(num_bits=8):
    jm, v = _trained(num_bits)
    return params_from_jax(v, num_bits=num_bits, dropout_rate=0.0)


def test_params_cross_both_ways():
    """``params_to_jax`` of the port's model is JAX's tree leaf for leaf
    (QuantizedDense_0..2 kernels back to (in, out)), and JAX's apply on
    it gives the port's eval forward."""
    jm, v = _trained()
    back = params_to_jax(_port())
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): x
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat({"params": v["params"],
                      "batch_stats": v["batch_stats"]}), flat(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x = _images(8, seed=12)
    np.testing.assert_allclose(
        np.asarray(jm.apply(back, jnp.asarray(x))),
        _port().eval()(torch.from_numpy(x)).detach().numpy(), atol=ATOL)


def test_registry_widths_and_clamp_mask():
    """qnn-mlp-large is the flagship's topology at k bits, and its
    QuantizedDense latents are not clamped (JAX's mask leaves them
    out)."""
    model = get_model("qnn-mlp-large",
                      generator=torch.Generator().manual_seed(0))
    assert isinstance(model, QnnMLP) and model.hidden == (3072, 1536, 768)
    assert latent_clamp_mask(model) == {}
    jm, v = _trained()
    from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask

    assert not any(jax.tree.leaves(jmask(v["params"])))


@pytest.mark.parametrize("quant_input", [True, False])
def test_quantized_dense_forward_and_gradients(quant_input):
    rng = np.random.RandomState(0)
    x = rng.randn(12, 40).astype(np.float32) * 0.7
    layer = JQuantizedDense(24, num_bits=8, quant_input=quant_input)
    params = _np_tree(layer.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    params["params"]["bias"] = rng.randn(24).astype(np.float32) * 0.1

    def jloss(p, xx):
        return jnp.sum(layer.apply(p, xx) ** 2)

    jy = layer.apply(params, jnp.asarray(x))
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    port = QuantizedDense(40, 24, num_bits=8, quant_input=quant_input)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(params["params"]["kernel"].T))
        port.bias.copy_(torch.from_numpy(params["params"]["bias"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(port.weight.grad.numpy().T,
                               np.asarray(jg["params"]["kernel"]),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(port.bias.grad.numpy(),
                               np.asarray(jg["params"]["bias"]),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                               atol=ATOL, rtol=1e-5)


def test_train_forward_and_gradients_match_jax():
    """The train-mode forward (batch statistics) and every parameter's
    gradient of the CE loss, dropout 0, deterministic rounding."""
    jm, v = _trained()
    x = _images(16, seed=9)
    labels = np.random.RandomState(10).randint(0, 10, 16)

    def jloss(params):
        out, _ = jm.apply({"params": params,
                           "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
        return cross_entropy_loss(out, jnp.asarray(labels)), out

    (jl, jout), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    port = _port().train()
    out = port(torch.from_numpy(x))
    loss = tce(out, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    assert abs(loss.item() - float(jl)) <= ATOL
    want = params_from_jax({"params": _np_tree(jg),
                            "batch_stats": v["batch_stats"]},
                           num_bits=8)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want.get_parameter(name).detach().numpy(),
            atol=ATOL, rtol=1e-4, err_msg=name)


def test_frozen_tensors_equal_jax():
    """The artifact's int8 weights, biases, moments and head are JAX's
    ``_freeze_qnn_tensors`` bit for bit."""
    jm, v = _trained()
    want = frozen_from_jax(_np_tree(jfreeze(jm, v)))
    got = _freeze_any(_port())
    assert got["info"] == want["info"] and got["num_bits"] == 8
    for g, w in zip(got["layers"], want["layers"]):
        assert g["w_int"].dtype == torch.int8
        assert torch.equal(g["w_int"], w["w_int"])
        assert torch.equal(g["bias"], w["bias"])
    for key in ("head_w", "head_b"):
        assert torch.equal(got[key], want[key])


def test_frozen_int_inputs_and_sums_bitwise_jax():
    """Each hidden layer's int8 inputs (BN affine rounded once, hardtanh,
    quantize) from the same fp32 pre-activations, and their int32 sums,
    bitwise JAX's; the log-probs within 1e-5 of the JAX frozen
    predictor and 1e-4 of the live eval forward."""
    jm, v = _trained()
    frozen = _freeze_any(_port())
    fn = FrozenQNN(frozen, torch.device("cpu"))
    x = _images(16, seed=11)
    y = (torch.from_numpy(x).reshape(16, -1) @ fn.w0) / fn.scale + fn.b0
    for i, (wt, b) in enumerate(fn.hidden):
        xi = fn.int_inputs(y, i)
        bn = v["params"][f"BatchNorm_{i}"], v["batch_stats"][f"BatchNorm_{i}"]
        a, c = jaffine(bn[0], bn[1])
        jh = jax.nn.hard_tanh(a * jnp.asarray(y.numpy()) + c)
        jxi = (jquantize(jh, "det", 8) * 128.0).astype(jnp.int8)
        np.testing.assert_array_equal(xi.numpy(), np.asarray(jxi))
        acc = int8_matmul(xi, wt)
        jacc = jnp.dot(jxi, jnp.asarray(wt.t().numpy()),
                       preferred_element_type=jnp.int32)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
        y = acc.to(torch.float32) / (fn.scale * fn.scale) + b
    jfn, _ = jload_from_frozen(jm, v)
    got = fn(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                               atol=ATOL)
    live = _port().eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, live, atol=FROZEN_LIVE_ATOL)


def jload_from_frozen(jm, v):
    from distributed_mnist_bnns_tpu.infer_qnn import freeze_qnn_mlp as jf

    return jf(jm, v)


@pytest.mark.parametrize("m", [1, 5, 32])
def test_int8_matmul_exact_above_fp32_range(m):
    """At K = 3,072 of +-127/-128 values the int32 sums reach 5e7, past
    2^24: ``int8_matmul`` equals the int64 product at every M."""
    rng = np.random.RandomState(m)
    k, n = 3072, 24
    a = rng.choice([-128, 127], (m, k), p=[0.1, 0.9]).astype(np.int8)
    w = rng.choice([-128, 127], (n, k), p=[0.1, 0.9]).astype(np.int8)
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(w))
    want = a.astype(np.int64) @ w.astype(np.int64).T
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


@pytest.mark.parametrize("num_bits", [8, 4])
def test_frozen_matches_live_eval(num_bits):
    jm, v = _trained(num_bits)
    port = _port(num_bits).eval()
    x = torch.from_numpy(_images(8, seed=5))
    fn, info = freeze_qnn_mlp(port, device="cpu")
    np.testing.assert_allclose(fn(x).numpy(), port(x).detach().numpy(),
                               atol=FROZEN_LIVE_ATOL)
    assert info["family"] == "qnn-mlp" and info["compression"] == 4.0


def test_artifact_interchanges_with_jax(tmp_path):
    """The port's export is the JAX export's bytes; each side loads the
    other's and predicts what the exporting side does."""
    jm, v = _trained()
    port = _port()
    x = _images(8, seed=6)
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jexport(jm, v, jpath)
    export_packed(port, tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    tfn, _ = load_packed(jpath, device="cpu")
    jfn, info = jload(tpath)
    assert info["family"] == "qnn-mlp"
    np.testing.assert_allclose(tfn(x).numpy(), np.asarray(jfn(x)),
                               atol=ATOL)
    back = frozen_to_jax(load_frozen(tpath))
    assert back["layers"][1]["w_int"].dtype == np.int8


def test_wide_bits_and_stochastic_rejected():
    with pytest.raises(ValueError, match="num_bits"):
        _freeze_any(QnnMLP(hidden=HIDDEN, num_bits=12))
    with pytest.raises(ValueError, match="stochastic"):
        _freeze_any(QnnMLP(hidden=HIDDEN, stochastic=True))


def test_tp_table_is_jax_rule():
    """``tp_rules_for("qnn-mlp-large")`` gives JAX's QNN_MLP_TP_TABLE
    layout on the same tree (column, row, column, row head)."""
    model = QnnMLP(hidden=HIDDEN)
    got = tp_rules_for("qnn-mlp-large", flax_params(model))
    _, v = _trained()
    want = jtp_rules_for("qnn-mlp-large", v["params"])
    flat_g = jax.tree_util.tree_flatten_with_path(
        got, is_leaf=lambda t: isinstance(t, tuple))[0]
    flat_w = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda t: isinstance(t, tuple))[0]
    assert [(p, tuple(s)) for p, s in flat_g] == [
        (p, tuple(s)) for p, s in flat_w]
    assert tuple(got["QuantizedDense_1"]["kernel"]) == ("model", None)


def test_cli_train_eval_export_infer(tmp_path, capsys):
    """``cli train|eval|export|infer --model qnn-mlp-large`` on the CPU;
    ``--infl-ratio`` does not reach the QNN (the JAX CLI's rule)."""
    ck = str(tmp_path / "ck")
    common = ["--model", "qnn-mlp-large", "--infl-ratio", "1",
              "--synthetic-sizes", "64", "32", "--device", "cpu",
              "--data-dir", str(tmp_path / "none")]
    assert cli.main(["train", *common, "--epochs", "1", "--batch-size",
                     "32", "--checkpoint-dir", ck]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["model"] == "qnn-mlp-large" and np.isfinite(row["train_loss"])
    assert cli.main(["eval", *common, "--checkpoint-dir", ck]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = str(tmp_path / "q.msgpack")
    assert cli.main(["export", "--model", "qnn-mlp-large",
                     "--checkpoint-dir", ck, "--out", out]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["family"] == "qnn-mlp"
    frozen = load_frozen(out)
    assert tuple(frozen["layers"][0]["w_int"].shape) == (784, 3072)
    assert cli.main(["infer", "--artifact", out, "--device", "cpu",
                     "--synthetic-sizes", "64", "32",
                     "--data-dir", str(tmp_path / "none")]) == 0
    inf = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert inf["family"] == "qnn-mlp" and inf["n_examples"] == 32
    assert abs(inf["test_acc"] - ev["test_acc"]) <= 100.0 / 32
