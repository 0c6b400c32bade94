"""ViT serving in the PyTorch port, against the JAX package.

The binarized ViT of ``tests/torch_vit_util.py`` (embed 32, depth 2, 2
heads, patch 7: 16 tokens; every parameter redrawn from a numpy seed, so
no exact ties), carried into the port through ``interop``:

  * the frozen tensors equal the JAX package's ``_freeze_vit_tensors``
    bit for bit (packed words, ±1 patch weights) and its size info;
  * the frozen ViT's log-probs against the JAX package's frozen ViT
    (Pallas in interpret mode) and both live eval forwards within
    ``VIT_ATOL`` = 2e-5: the integer projection sums are exact on both
    sides, and flax's LayerNorm and XLA's softmax and head differ from
    the port's by float32 rounding, a few 1e-6 after two blocks; the
    argmax is identical;
  * artifacts interchange: the port's ``export_packed`` serves in the
    JAX ``load_packed`` and the reverse (``w_embed`` as int8 on disk);
  * the JAX package's refusals (the fp32 twin, stochastic binarization,
    an ``attention_fn``, a resolution that does not give the artifact's
    tokens), and ``cli export | infer | serve`` of a ``bnn-vit`` model.
"""

import json

import jax
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu.infer_transformer import (
    _freeze_vit_tensors as jax_freeze_vit,
    freeze_bnn_vit as jax_freeze_bnn_vit,
)
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.infer import (
    _freeze_any,
    export_packed,
    load_frozen,
    load_packed,
)
from distributed_mnist_bnns_tpu_torch.infer_transformer import (
    FrozenViT,
    _build_transformer_apply,
    _freeze_vit_tensors,
    freeze_bnn_vit,
)
from distributed_mnist_bnns_tpu_torch.interop import frozen_from_jax
from distributed_mnist_bnns_tpu_torch.models import bnn_vit_tiny
from distributed_mnist_bnns_tpu_torch.serve import (
    PackedInferenceServer,
    ServeConfig,
)
from distributed_mnist_bnns_tpu_torch.serve import client as sc
from tests.torch_vit_util import images, vit_pair

VIT_ATOL = 2e-5


@pytest.fixture(scope="module")
def vit():
    jm, params, tm = vit_pair(seed=3)
    return jm, params, tm


def _np(tree):
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


@pytest.mark.parametrize("scale", [False, True])
def test_frozen_tensors_equal_jax(scale):
    jm, params, tm = vit_pair(seed=4, scale=scale)
    want = _np(jax_freeze_vit(jm, {"params": params}))
    got = _freeze_vit_tensors(tm)
    assert got["info"] == want["info"]
    assert got["kind"] == "vit" and got["causal"] is False
    assert got["patch_size"] == want["patch_size"] == 7
    for key in ("w_embed", "b_embed", "pos_embed", "head_w", "head_b"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for b, jb in zip(got["blocks"], want["blocks"]):
        for key in ("q", "k", "v", "out", "mlp1", "mlp2"):
            np.testing.assert_array_equal(b[key]["wp"].numpy(),
                                          jb[key]["wp"])
            assert (b[key]["k"], b[key]["n"]) == (jb[key]["k"],
                                                  jb[key]["n"])
            if scale:
                np.testing.assert_allclose(b[key]["alpha"].numpy(),
                                           jb[key]["alpha"], rtol=1e-6)


def test_frozen_logprobs_match_jax_and_live_models(vit):
    jm, params, tm = vit
    x = images(5, 6)
    jfn, _ = jax_freeze_bnn_vit(jm, {"params": params}, interpret=True)
    fn, info = freeze_bnn_vit(tm, device="cpu")
    assert info["kind"] == "vit"
    got = fn(x).numpy()
    refs = {
        "jax frozen": np.asarray(jfn(x)),
        "jax live": np.asarray(jm.apply({"params": params}, x, train=False)),
        "port live": tm.eval()(torch.from_numpy(x)).detach().numpy(),
        "port frozen from jax": FrozenViT(frozen_from_jax(_np(
            jax_freeze_vit(jm, {"params": params}))), "cpu")(x).numpy(),
    }
    for name, ref in refs.items():
        np.testing.assert_allclose(got, ref, atol=VIT_ATOL, rtol=0,
                                   err_msg=name)
        assert (got.argmax(-1) == ref.argmax(-1)).all(), name
    np.testing.assert_array_equal(fn(x.reshape(6, -1)).numpy(), got)


def test_artifacts_interchange_both_ways(vit, tmp_path):
    jm, params, tm = vit
    x = images(7, 4)
    ours = str(tmp_path / "port.msgpack")
    info = export_packed(tm, ours)
    assert load_frozen(ours)["w_embed"].dtype == torch.int8
    jfn, jinfo = jinfer.load_packed(ours, interpret=True)
    assert jinfo == info
    fn, _ = load_packed(ours, device="cpu")
    np.testing.assert_allclose(fn(x).numpy(), np.asarray(jfn(x)),
                               atol=VIT_ATOL, rtol=0)
    theirs = str(tmp_path / "jax.msgpack")
    jinfer.export_packed(jm, {"params": params}, theirs)
    fn2, info2 = load_packed(theirs, device="cpu")
    assert info2 == info and isinstance(fn2, FrozenViT)
    np.testing.assert_array_equal(fn2(x).numpy(), fn(x).numpy())


def test_refusals(vit):
    _, _, tm = vit
    fp32 = bnn_vit_tiny(binarized=False)
    with pytest.raises(ValueError, match="binarized weights"):
        _freeze_any(fp32)
    ring = bnn_vit_tiny(attention_fn=lambda q, k, v: q)
    with pytest.raises(ValueError, match="attention_fn"):
        _freeze_any(ring)
    stochastic = bnn_vit_tiny()
    stochastic.blocks[1].mlp1.stochastic = True
    with pytest.raises(ValueError, match="stochastic"):
        _freeze_any(stochastic)
    fn, _ = freeze_bnn_vit(tm, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        fn(np.zeros((1, 30, 30, 1), np.float32))
    with pytest.raises(ValueError, match="yields 4 patch tokens"):
        fn(np.zeros((1, 14, 14, 1), np.float32))
    frozen = _freeze_vit_tensors(tm)
    with pytest.raises(ValueError, match="unknown bnn-transformer kind"):
        _build_transformer_apply({**frozen, "kind": "moe"}, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            freeze_bnn_vit(tm)


def test_cli_export_infer_serve(vit, tmp_path, capsys):
    """``cli export --model bnn-vit-tiny`` of a seeded init, ``cli
    infer`` of the artifact, and the classifier server answering with
    the predictor's log-probs."""
    out = str(tmp_path / "vit.msgpack")
    assert cli.main(["export", "--model", "bnn-vit-tiny", "--seed", "2",
                     "--out", out]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert info["kind"] == "vit" and info["artifact"] == out
    assert cli.main(["infer", "--artifact", out, "--device", "cpu",
                     "--synthetic-sizes", "64", "64", "--batch-size",
                     "32"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["family"] == "bnn-transformer" and res["n_examples"] == 64
    path = str(tmp_path / "trained.msgpack")
    export_packed(vit[2], path)
    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device="cpu", port=0, batch_size=4, queue_depth=8,
        default_deadline_ms=5000.0))
    host, port = srv.start()
    try:
        x = images(9, 3)
        code, body = sc.predict(f"http://{host}:{port}", x.tolist())
    finally:
        srv.request_stop("test over")
        srv.drain_and_stop()
    assert code == 200
    got = np.asarray(json.loads(body)["log_probs"], np.float32)
    pad = np.zeros((4, 28, 28, 1), np.float32)
    pad[:3] = x
    want = srv.engine.predict_fn(pad)[:3].numpy()
    np.testing.assert_array_equal(got, want)
