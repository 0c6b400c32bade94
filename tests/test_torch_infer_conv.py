"""The port's frozen ``bnn-cnn`` (``infer_conv.py``, ``infer.py``'s
family dispatch) against the JAX package's ``freeze_bnn_cnn`` with its
Pallas kernels in interpret mode, and against the live model.

bnn-cnn at widths (16, 32), hidden 128 (the JAX package's
``test_infer_conv.py`` size), with drawn biases and BatchNorm state
(``tests/torch_conv_util.py``). The frozen tensors (packed words, tap
sums, the ±1 first kernel) are bitwise JAX's. The predictions: the
first conv is an fp32 conv of raw pixels, summed in another order than
XLA's, and its output meets a threshold, so log-probs are held to atol
1e-4 with argmax equal, as the MLP's frozen check; the packed convs are
exact. On the CPU the port's K1 is its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer_conv as jconv
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch import infer_conv as tconv
from distributed_mnist_bnns_tpu_torch.interop import frozen_from_jax
from distributed_mnist_bnns_tpu_torch.models import get_model
from tests import torch_conv_util as U

ATOL = 1e-4


def _setup(seed=0):
    jm, v = U.jax_variables("bnn-cnn", seed, backend="xla")
    return jm, v, U.port_model("bnn-cnn", v, backend="xla")


def _numpy(tree):
    """A JAX frozen dict with numpy arrays for its arrays."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree) if hasattr(tree, "shape") else tree


def _x(n=8, seed=0):
    return U.pixels(n, seed + 20)


@pytest.mark.parametrize("seed", [0, 1])
def test_frozen_cnn_matches_jax_freeze_and_the_live_model(seed):
    jm, v, model = _setup(seed)
    x = _x(seed=seed)
    jfn, jinfo = jconv.freeze_bnn_cnn(jm, v, interpret=True)
    want = np.asarray(jfn(jnp.asarray(x)))
    fn, info = tconv.freeze_bnn_cnn(model, device="cpu")
    got = fn(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    live = model.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=ATOL)
    assert (got.argmax(-1) == live.argmax(-1)).all()
    assert info == jinfo


def test_frozen_tensors_are_jax_bitwise():
    """Every array of the port's frozen dict equals JAX's
    ``_freeze_cnn_tensors`` (the same keys and layouts), and the port's
    predictor reads a JAX artifact as its own."""
    jm, v, model = _setup()
    want = _numpy(jconv._freeze_cnn_tensors(jm, v, (28, 28, 1)))
    got = tconv._freeze_cnn_tensors(model)

    def compare(g, w, path=""):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                compare(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            assert g == w, path

    compare(got, want)
    x = _x()
    from_jax = tconv.FrozenCNN(frozen_from_jax(want), torch.device("cpu"))
    mine = tconv.FrozenCNN(got, torch.device("cpu"))
    assert torch.equal(from_jax(x), mine(x))


def test_export_load_round_trip_and_input_layouts(tmp_path):
    """``export_packed`` -> ``load_packed`` gives the same predictions
    from flat (B, 784) and NHWC (B, 28, 28, 1) input, numpy or torch;
    the first kernel is stored as int8."""
    _, _, model = _setup()
    fn, info = tconv.freeze_bnn_cnn(model, device="cpu")
    path = str(tmp_path / "cnn.pt")
    assert tinfer.export_packed(model, path) == info
    assert tinfer.load_frozen(path)["conv1_w"].dtype == torch.int8
    loaded, info2 = tinfer.load_packed(path, device="cpu")
    assert isinstance(loaded, tconv.FrozenCNN) and info2 == info
    x = _x()
    want = fn(x)
    assert torch.equal(loaded(x), want)
    assert torch.equal(loaded(x.reshape(8, -1)), want)
    assert torch.equal(loaded(torch.from_numpy(x)), want)
    assert info["compression"] > 5


def test_rejections():
    _, _, model = _setup()
    stoch = get_model("bnn-cnn", widths=(16, 32), hidden=128,
                      stochastic=True)
    with pytest.raises(ValueError, match="stochastic"):
        tconv.freeze_bnn_cnn(stoch, device="cpu")
    model.fc.scale = True
    with pytest.raises(ValueError, match="scale"):
        tconv.freeze_bnn_cnn(model, device="cpu")
    model.fc.scale = False
    fn, _ = tconv.freeze_bnn_cnn(model, device="cpu")
    with pytest.raises(ValueError, match="expects"):
        fn(np.zeros((2, 14, 14, 1), np.float32))
    with pytest.raises(ValueError, match="no packed freeze"):
        tinfer.export_packed(get_model("convnet"), "unused.pt")
    with pytest.raises(ValueError, match="binarized"):
        tinfer._freeze_tensors(get_model("fp32-mlp-large", infl_ratio=1))
    with pytest.raises(ValueError, match="family"):
        tinfer._build_any({"family": "xnor-resnet"}, torch.device("cpu"))


def test_freeze_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, model = _setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconv.freeze_bnn_cnn(model)


def test_server_serves_a_bnn_cnn_artifact(tmp_path):
    """The HTTP server over a ``bnn-cnn`` artifact (``cli serve`` needs
    nothing more than ``load_packed``): each answer equals the
    predictor's on the zero-padded batch; ``/healthz`` names the
    family."""
    import json

    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    _, _, model = _setup()
    path = str(tmp_path / "cnn.pt")
    tinfer.export_packed(model, path)
    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device="cpu", port=0, batch_size=4,
        default_deadline_ms=30000.0))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        code, body = sc.healthz(base)
        assert code == 200 and json.loads(body)["family"] == "bnn-cnn"
        x = _x(3)
        code, body = sc.predict(base, x.tolist())
        assert code == 200
        out = json.loads(body)
        padded = np.zeros((4, 28, 28, 1), np.float32)
        padded[:3] = x
        direct = srv.engine.predict_fn(padded)[:3].numpy()
        assert out["argmax"] == direct.argmax(-1).tolist()
        np.testing.assert_array_equal(
            np.asarray(out["log_probs"], np.float32), direct)
    finally:
        srv.request_stop("test over")
        stats = srv.drain_and_stop()
    assert stats["flushed"]
