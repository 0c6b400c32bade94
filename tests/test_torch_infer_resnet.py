"""The port's frozen XNOR-ResNets (``infer_conv.FrozenResNet``,
``infer.py``'s family dispatch, ``cli``) against the JAX package's
``freeze_xnor_resnet`` with its Pallas kernels in interpret mode.

resnet18 at stem 16 on 32 x 32 and resnet50 at stem 8 on 64 x 64 (the
JAX package's ``test_infer_conv.py`` sizes; resnet50's bottlenecks fuse
each conv0 with the next threshold into K2), with drawn biases and
BatchNorm statistics that came from a train-mode pass. The frozen dict
is JAX's key for key, array for array (packed words, tap sums, kernels,
moments), in JAX's order, so the exported bytes are JAX's and either
package serves the other's artifact. The logits: the stem, the
shortcuts and the head are fp32 convs and GEMMs summed in other orders
than XLA's, and the residual stream meets thresholds, so they are held
to atol 1e-4 with the argmax equal (measured: 9.5e-7 and 4.3e-6), as
the frozen bnn-cnn is; the packed convs (K1 and K2 as their plain
versions on the CPU) are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu import infer_conv as jconv
from distributed_mnist_bnns_tpu.models import get_model as jget
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch import infer_conv as tconv
from distributed_mnist_bnns_tpu_torch.interop import (
    frozen_from_jax,
    frozen_to_jax,
    params_from_jax,
)
from distributed_mnist_bnns_tpu_torch.models import get_model
from tests.torch_conv_util import np_tree

ATOL = 1e-4
CASES = {
    "resnet18": ("xnor-resnet18", dict(stem_features=16), (32, 32, 3)),
    "resnet50": ("xnor-resnet50", dict(stem_features=8, num_classes=1000),
                 (64, 64, 3)),
}


def _setup(case, seed=0):
    name, kw, shape = CASES[case]
    jm = jget(name, backend="xla", **kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(4, *shape).astype(np.float32)
    v = np_tree(jax.jit(lambda key, x: jm.init({"params": key}, x,
                                               train=False))(
        jax.random.PRNGKey(seed), jnp.asarray(x)))
    for mod, leaves in v["params"].items():
        if "bias" in leaves and mod.startswith("Dense"):
            leaves["bias"] = (rng.randn(*leaves["bias"].shape)
                              ).astype(np.float32)
    # BatchNorm statistics of the data (a train-mode pass), not 0 / 1
    _, upd = jax.jit(lambda v, x: jm.apply(v, x, train=True,
                                           mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    v["batch_stats"] = np_tree(upd["batch_stats"])
    v = _creation_order(v)
    return jm, v, params_from_jax(v, backend="xla"), x, shape


def _creation_order(tree):
    """``tree`` with each module's leaves in flax's creation order (kernel
    or scale, then bias), as an eager ``init`` gives them: a jitted one
    returns sorted keys, and the artifact keeps a BatchNorm's parameters
    in the order the variables hold them (the port writes creation
    order)."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _creation_order(v) for k, v in tree.items()}
    first = [k for k in ("kernel", "scale") if k in out]
    if first and "bias" in out:
        out = {first[0]: out[first[0]], "bias": out["bias"],
               **{k: v for k, v in out.items() if k not in (first[0],
                                                             "bias")}}
    return out


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return np.asarray(tree) if hasattr(tree, "shape") else tree


def _compare(got, want, path=""):
    if isinstance(want, dict):
        assert list(got) == list(want), path     # the same keys, in order
        for k in want:
            _compare(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _compare(g, w, f"{path}/{i}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize("case", list(CASES))
def test_frozen_resnet_matches_jax_freeze_and_the_live_model(case):
    jm, v, model, x, shape = _setup(case)
    jfn, jinfo = jconv.freeze_xnor_resnet(jm, v, input_shape=shape,
                                          interpret=True)
    want = np.asarray(jfn(jnp.asarray(x)))
    fn, info = tconv.freeze_xnor_resnet(model, input_shape=shape,
                                        device="cpu")
    got = fn(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    live = model.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, live, rtol=0, atol=ATOL)
    assert (got.argmax(-1) == live.argmax(-1)).all()
    assert info == jinfo
    assert info["compression"] > 10


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_is_jax_bitwise_both_ways(case, tmp_path):
    """The frozen dict equals JAX's ``_freeze_resnet_tensors`` key for key
    (in order) and array for array; the exported bytes equal JAX's
    export; each package's predictor serves the other's artifact as its
    own (JAX's, in interpret mode, on resnet18's: the bytes are the
    same)."""
    jm, v, model, x, shape = _setup(case, seed=1)
    want = _numpy(jconv._freeze_resnet_tensors(jm, v, shape))
    _compare(frozen_to_jax(tconv._freeze_resnet_tensors(model, shape)), want)
    mine, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax.msgpack")
    assert tinfer.export_packed(model, mine, input_shape=shape) == (
        jinfer.export_packed(jm, v, theirs, input_shape=shape))
    with open(mine, "rb") as f1, open(theirs, "rb") as f2:
        assert f1.read() == f2.read()
    fn, _ = tinfer.load_packed(theirs, device="cpu")
    assert isinstance(fn, tconv.FrozenResNet)
    ref = tconv.FrozenResNet(frozen_from_jax(want), torch.device("cpu"))
    assert torch.equal(fn(x), ref(x))
    if case == "resnet50":   # the same bytes: JAX's load is resnet18's
        return
    jfn, jinfo = jinfer.load_packed(mine, interpret=True)
    jref, _ = jconv.freeze_xnor_resnet(jm, v, input_shape=shape,
                                       interpret=True)
    np.testing.assert_array_equal(np.asarray(jfn(jnp.asarray(x))),
                                  np.asarray(jref(jnp.asarray(x))))
    assert jinfo["family"] == "xnor-resnet"


def test_bottleneck_fusion_is_constructed():
    """The fusion gate (JAX's ``test_bottleneck_fusion_actually_constructed``):
    a bottleneck's conv0 (1x1/1) becomes K2 carrying conv1's threshold
    (conv1's sign is None), its conv2 feeds the residual add; a basic
    block fuses nothing."""
    for name, kw in (("xnor-resnet50", dict(stem_features=8)),
                     ("xnor-resnet18", dict(stem_features=8))):
        model = get_model(name, **kw)
        fn, _ = tconv.freeze_xnor_resnet(model, input_shape=(32, 32, 3),
                                         device="cpu")
        for pairs, _ in fn.blocks:
            if model.bottleneck:
                assert pairs[0][0] is not None
                assert isinstance(pairs[0][1], tconv._PackedConv1x1Sign)
                assert pairs[1][0] is None, "conv0's fusion did not fire"
                assert pairs[2][0] is not None
                assert not isinstance(pairs[2][1], tconv._PackedConv1x1Sign)
            else:
                assert all(sign is not None for sign, _ in pairs)
                assert not any(isinstance(c, tconv._PackedConv1x1Sign)
                               for _, c in pairs)


def test_refusals():
    model = get_model("xnor-resnet18", stem_features=8)
    fn, _ = tconv.freeze_xnor_resnet(model, input_shape=(32, 32, 3),
                                     device="cpu")
    with pytest.raises(ValueError, match="expects"):
        fn(np.zeros((2, 16, 16, 3), np.float32))
    with pytest.raises(ValueError, match="scale"):
        tconv.freeze_xnor_resnet(
            get_model("xnor-resnet18", stem_features=8, scale=True),
            device="cpu")
    with pytest.raises(ValueError, match="binarized"):
        tconv.freeze_xnor_resnet(
            get_model("fp32-resnet18", stem_features=8), device="cpu")
    with pytest.raises(ValueError, match="xnor-resnet artifact"):
        tconv.FrozenResNet({"family": "bnn-cnn"}, torch.device("cpu"))
    with pytest.raises(ValueError, match="packed for"):
        layer = tconv._freeze_resnet_tensors(model, (32, 32, 3))
        conv = tconv._PackedConv(layer["blocks"][0]["convs"][0]["conv"],
                                 torch.device("cpu"))
        conv(torch.ones(1, 16, 16, 8))


def test_cli_train_augment_export_infer(tmp_path, capsys):
    """``cli train --dataset cifar10 --augment`` (xnor-resnet18 at full
    width, synthetic CIFAR-10, 2 steps) -> ``export --checkpoint-dir`` ->
    ``infer --dataset cifar10``, on the CPU; ``--stream`` without an
    on-disk ImageNet exits 2 and a dataset's foreign ``--norm`` exits."""
    ck, art = str(tmp_path / "ck"), str(tmp_path / "r18.msgpack")
    data = ["--dataset", "cifar10", "--data-dir", str(tmp_path / "none"),
            "--synthetic-sizes", "16", "8"]
    assert cli.main(["--log-level", "WARNING", "train", "--model",
                     "xnor-resnet18", *data, "--augment", "--epochs", "1",
                     "--batch-size", "8", "--device", "cpu",
                     "--checkpoint-dir", ck]) == 0
    row = __import__("json").loads(capsys.readouterr().out.strip()
                                   .splitlines()[-1])
    assert row["steps"] == 2 and np.isfinite(row["train_loss"])
    assert cli.main(["export", "--model", "xnor-resnet18", "--dataset",
                     "cifar10", "--checkpoint-dir", ck, "--out", art]) == 0
    info = __import__("json").loads(capsys.readouterr().out.strip()
                                    .splitlines()[-1])
    assert info["family"] == "xnor-resnet"
    assert tinfer.load_frozen(art)["arch"]["input_shape"] == [32, 32, 3]
    assert cli.main(["infer", "--artifact", art, *data, "--device", "cpu",
                     "--batch-size", "8"]) == 0
    out = __import__("json").loads(capsys.readouterr().out.strip()
                                   .splitlines()[-1])
    assert out["family"] == "xnor-resnet" and out["n_examples"] == 8
    with pytest.raises(SystemExit) as e:
        cli.main(["train", "--model", "xnor-resnet50", "--dataset",
                  "imagenet", "--stream", "--data-dir",
                  str(tmp_path / "none"), "--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit, match="not valid"):
        cli.main(["train", "--dataset", "cifar10", "--norm", "mnist",
                  "--device", "cpu"])
