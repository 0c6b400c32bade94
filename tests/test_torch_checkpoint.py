"""The port's checkpoints and artifacts in the JAX package's format.

The codec (``utils/msgpack.py``) against ``flax.serialization``: the same
tree gives the same bytes (a train state, an artifact, a leaf over the
chunk limit, every scalar form), and each side decodes the other's. The
checkpoint module (``utils/checkpoint.py``) as the JAX
``tests/test_checkpoint.py`` holds its own: round trip, the best and
per-epoch copies, atomic writes, the async checkpointer (same bytes as
the synchronous save, call order, a snapshot the live tensors cannot
change, a write error raised on ``wait``), digests and generations.

Across the frameworks, for each of the ten optimizers on
``bnn-mlp-small`` at ``infl_ratio=1`` (784-64-64-64-10), dropout 0,
backend xla, synthetic data (4 steps of batch 32 an epoch):
  * the JAX ``load_checkpoint(trainer.state, dir)`` restores a port
    checkpoint to arrays equal to the port's, and ``to_bytes`` of what
    it restored is the port file's bytes (also with clipping and the
    1-bit exchange stages);
  * the port's ``resume`` of a JAX checkpoint restores it bitwise and
    takes one more step within ``tests/test_torch_train.py``'s
    tolerances of the JAX trainer's next step: latents and BatchNorm
    statistics to atol 1e-5 (statistics also rtol 1e-5), but the dense
    biases in front of a train-mode BatchNorm, whose exact gradient is 0
    and which the normalising optimizers move by rounding noise, held to
    the step bound: the larger of the two sides' own moves of that
    tensor, doubled.
Artifacts: the JAX ``load_packed(interpret=True)`` serves a port export
and the port's ``load_packed`` a JAX export, with equal predictions
(argmax equal, log-probs within the frozen paths' own tolerances: 1e-4
for the MLP and CNN, whose first layer is an fp32 product of raw pixels,
1e-5 for the LM), for the MLP, the CNN and the LM.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu.data import batch_iterator as jbatches
from distributed_mnist_bnns_tpu.data import load_mnist as jload_mnist
from distributed_mnist_bnns_tpu.train import TrainConfig as JConfig
from distributed_mnist_bnns_tpu.train import Trainer as JTrainer
from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch.data import batch_iterator, load_mnist
from distributed_mnist_bnns_tpu_torch.interop import (
    frozen_to_jax,
    train_state_to_jax,
)
from distributed_mnist_bnns_tpu_torch.models import get_model
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.train.optim import OPTIMIZER_REGISTRY
from distributed_mnist_bnns_tpu_torch.utils import checkpoint as ck
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests import torch_conv_util as U
from tests.torch_lm_util import frozen_pair, lm_pair, tokens

OPTIMIZERS = sorted(OPTIMIZER_REGISTRY)
MODEL_KW = {"infl_ratio": 1, "dropout_rate": 0.0}
SIZES = (128, 32)
BATCH, LR = 32, 0.01
ATOL = 1e-5
STAT_RTOL = 1e-5
BN_BIASES = ("BinarizedDense_0", "BinarizedDense_1", "BinarizedDense_2")


def _flat(tree, prefix=()):
    """{path: numpy leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    if torch.is_tensor(tree):
        return {prefix: tree.detach().cpu().numpy()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _port_data():
    return load_mnist("/nonexistent", synthetic_sizes=SIZES)


def _port_cfg(**kw):
    kw = dict(dict(model="bnn-mlp-small", model_kwargs=dict(MODEL_KW),
                   epochs=1, batch_size=BATCH, learning_rate=LR,
                   backend="xla", device="cpu", seed=1), **kw)
    return TrainConfig(**kw)


def _jax_cfg(**kw):
    kw = dict(dict(model="bnn-mlp-small", model_kwargs=dict(MODEL_KW),
                   epochs=1, batch_size=BATCH, learning_rate=LR,
                   backend="xla", seed=1), **kw)
    return JConfig(**kw)


# -- the codec ----------------------------------------------------------------


def _scalar_tree():
    return {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                 2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                 -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "flags": [True, False, None],
        "text": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é€",
                 "e" * 70000],
        "bytes": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
        "np_scalars": [np.float32(1.5), np.int64(-7), np.uint8(3),
                       np.bool_(True), np.float16(2.0)],
        "zero_d": np.asarray(3, np.int32),
        "arrays": {f"a{n}": np.arange(n, dtype=np.int8) for n in
                   (0, 1, 2, 4, 8, 16, 17, 300, 70000)},
        "wide": np.random.RandomState(0).randn(3, 5).astype(np.float64),
        "empty": {},
        "map16": {f"k{i:02d}": i for i in range(20)},
    }


def _train_state_tree():
    t = Trainer(_port_cfg(optimizer="adam", clip_grad_norm=1.0,
                          grad_compress="sign_ef"))
    t.fit(_port_data(), eval_every=0)
    return ck._to_host(train_state_to_jax(t))


def _artifact_tree():
    model = get_model("bnn-mlp-small", infl_ratio=1,
                      generator=torch.Generator().manual_seed(0))
    return frozen_to_jax(tinfer._to_cpu(tinfer._freeze_any(model.eval())))


@pytest.mark.parametrize("which", ["scalars", "state", "artifact"])
def test_codec_bytes_equal_flax(which):
    tree = {"scalars": _scalar_tree, "state": _train_state_tree,
            "artifact": _artifact_tree}[which]()
    assert msgpack.msgpack_serialize(tree) == \
        serialization.msgpack_serialize(tree)
    if which == "state":   # flax's to_bytes turns lists into dicts
        assert msgpack.to_bytes(tree) == serialization.to_bytes(tree)


def test_codec_bfloat16_and_chunked_leaves_equal_flax(monkeypatch):
    """bfloat16 by name; a leaf over the chunk limit (cut to 64 bytes in
    both codecs) in flax's ``__msgpack_chunked_array__`` form."""
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(1)
    big = rng.randn(7, 5).astype(np.float32)
    bf = rng.randn(40).astype(np.float32)
    jtree = {"w": big, "small": np.ones(3, np.float32),
             "bf": jnp.asarray(bf, jnp.bfloat16), "nest": {"v": big[:, :4]}}
    ttree = dict(jtree, bf=torch.from_numpy(bf).to(torch.bfloat16))
    want = serialization.msgpack_serialize(jtree)
    assert msgpack.msgpack_serialize(ttree) == want
    assert b"__msgpack_chunked_array__" in want
    back = msgpack.from_bytes(want)
    np.testing.assert_array_equal(back["w"], big)
    np.testing.assert_array_equal(back["nest"]["v"], big[:, :4])
    assert back["bf"].dtype == torch.bfloat16
    assert torch.equal(back["bf"], ttree["bf"])
    again = serialization.msgpack_restore(msgpack.msgpack_serialize(ttree))
    np.testing.assert_array_equal(again["w"], big)


def test_codec_decodes_flax_and_flax_decodes_the_codec():
    tree = _scalar_tree()
    back = msgpack.from_bytes(serialization.msgpack_serialize(tree))
    want = serialization.msgpack_restore(serialization.msgpack_serialize(tree))
    assert back.keys() == want.keys()
    for k in ("ints", "floats", "flags", "text", "bytes"):
        assert back[k] == want[k], k
    for a, b in zip(back["np_scalars"], want["np_scalars"]):
        assert type(a) is type(b) and a == b
    _assert_trees_equal(back["arrays"], want["arrays"])
    assert back["zero_d"].shape == () and int(back["zero_d"]) == 3
    flax_view = serialization.msgpack_restore(msgpack.msgpack_serialize(tree))
    _assert_trees_equal(flax_view["arrays"], tree["arrays"])
    assert flax_view["text"] == tree["text"]


def test_codec_rejects_truncated_and_trailing_bytes():
    data = msgpack.to_bytes({"a": np.arange(10, dtype=np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.from_bytes(data[:-3])
    with pytest.raises(ValueError, match="extra data"):
        msgpack.from_bytes(data + b"\x00")


# -- the checkpoint module ------------------------------------------------------


def _trained(tmp_path, **kw):
    t = Trainer(_port_cfg(checkpoint_dir=str(tmp_path / "ckpts"),
                          save_all_epochs=True, **kw))
    t.fit(_port_data())
    return t


def test_roundtrip_preserves_state(tmp_path):
    t = _trained(tmp_path)
    path = str(tmp_path / "ckpts")
    assert ck.latest_exists(path)
    fresh = Trainer(_port_cfg())
    template = train_state_to_jax(fresh, values=False)
    restored = ck.load_checkpoint(template, path)
    _assert_trees_equal(restored, ck._to_host(train_state_to_jax(t)))
    fresh.restore(path)
    _assert_trees_equal(ck._to_host(train_state_to_jax(fresh)),
                        ck._to_host(train_state_to_jax(t)))


def test_best_and_epoch_copies(tmp_path):
    _trained(tmp_path, epochs=2)
    path = tmp_path / "ckpts"
    assert (path / "model_best.msgpack").exists()
    assert (path / "checkpoint_epoch_0.msgpack").exists()
    assert (path / "checkpoint_epoch_1.msgpack").exists()
    meta = ck.read_meta(str(path))
    assert meta["epoch"] == 1 and "best_acc" in meta
    assert meta["model"] == "bnn-mlp-small" and meta["world_size"] == 1


def test_save_checkpoint_atomic_no_tmp_left(tmp_path):
    t = Trainer(_port_cfg())
    path = str(tmp_path / "c2")
    ck.save_checkpoint(train_state_to_jax(t), path, epoch=0)
    assert ck.latest_exists(path)
    assert not any(f.endswith(".tmp") for f in os.listdir(path))


def test_async_checkpointer_matches_sync(tmp_path):
    t = Trainer(_port_cfg())
    tree = train_state_to_jax(t)
    sync_dir, async_dir = str(tmp_path / "sync"), str(tmp_path / "async")
    ck.save_checkpoint(tree, sync_dir, epoch=0, is_best=True)
    with ck.AsyncCheckpointer() as c:
        c.save(tree, async_dir, epoch=0, is_best=True)
        c.wait()
    for name in ("checkpoint.msgpack", "model_best.msgpack"):
        assert (tmp_path / "sync" / name).read_bytes() == \
            (tmp_path / "async" / name).read_bytes()
    assert ck.read_meta(async_dir)["epoch"] == 0


def test_async_checkpointer_ordering_and_snapshot(tmp_path):
    """Two saves in a row: the second lands last; changing the live
    tensors after ``save`` does not reach the snapshot being written."""
    t = Trainer(_port_cfg())
    d = str(tmp_path / "ord")
    tree0 = train_state_to_jax(t)
    kernel = tree0["params"]["BinarizedDense_0"]["kernel"]
    want0 = kernel.clone()
    with ck.AsyncCheckpointer() as c:
        c.save(tree0, d, epoch=0)
        with torch.no_grad():
            t.model.fc1.weight.add_(1.0)   # the same storage, transposed
        assert not torch.equal(kernel, want0)
        c.wait()
        first = msgpack.from_bytes((tmp_path / "ord" / ck.LATEST)
                                   .read_bytes())
        np.testing.assert_array_equal(
            first["params"]["BinarizedDense_0"]["kernel"], want0.numpy())
        t.step = 41
        c.save(train_state_to_jax(t), d, epoch=1)
    assert ck.read_meta(d)["epoch"] == 1
    restored = ck.load_checkpoint(train_state_to_jax(t, values=False), d)
    assert int(restored["step"]) == 41


def test_async_checkpointer_reraises_write_errors(tmp_path):
    t = Trainer(_port_cfg())
    blocked = tmp_path / "blocked"
    blocked.write_text("a file, not a directory")
    c = ck.AsyncCheckpointer()
    c.save(train_state_to_jax(t), str(blocked), epoch=0)
    with pytest.raises(OSError):
        c.wait()
    c.close()


def test_meta_digest_and_generations(tmp_path):
    t = Trainer(_port_cfg())
    path = str(tmp_path / "gens")
    for epoch in range(3):
        t.step = epoch
        ck.save_checkpoint(train_state_to_jax(t), path, epoch=epoch,
                           keep_generations=2)
    meta = ck.read_meta(path)
    assert meta["generation"] == 2 and meta["digest"] and meta["step"] == 2
    assert [g["file"] for g in meta["generations"]] == [
        "checkpoint_gen_2.msgpack", "checkpoint_gen_1.msgpack"]
    assert not os.path.exists(os.path.join(path, "checkpoint_gen_0.msgpack"))
    assert ck.verify_checkpoint(path)
    assert ck.file_digest(os.path.join(path, ck.LATEST)) == meta["digest"]
    for g in meta["generations"]:
        assert ck.verify_checkpoint(path, file=g["file"], digest=g["digest"])


def test_hardlink_refused_falls_back_to_a_copy(tmp_path, monkeypatch):
    def refuse(src, dst):
        raise OSError("links not supported")

    monkeypatch.setattr(os, "link", refuse)
    t = Trainer(_port_cfg())
    path = tmp_path / "nolink"
    ck.save_checkpoint(train_state_to_jax(t), str(path), epoch=0)
    gen = path / "checkpoint_gen_0.msgpack"
    assert gen.read_bytes() == (path / ck.LATEST).read_bytes()
    assert os.stat(gen).st_ino != os.stat(path / ck.LATEST).st_ino


# -- across the frameworks ------------------------------------------------------


STATE_CASES = [(o, {}) for o in OPTIMIZERS] + [
    ("adam", {"clip_grad_norm": 1.0}),
    ("sgd", {"grad_compress": "sign"}),
    ("adam", {"clip_grad_norm": 1.0, "grad_compress": "sign_ef"}),
    # the compressed FSDP exchange at world 1 (FsdpCompressState)
    ("adam", {"dp_mode": "fsdp", "grad_compress": "sign_ef"}),
    ("sgd", {"clip_grad_norm": 1.0, "dp_mode": "fsdp",
             "grad_compress": "sign"}),
]


@pytest.mark.parametrize(
    "opt,extra", STATE_CASES,
    ids=[o + "".join(f"-{k}" for k in e) for o, e in STATE_CASES])
def test_jax_load_checkpoint_restores_a_port_checkpoint(opt, extra,
                                                        tmp_path):
    path = str(tmp_path / "port")
    t = Trainer(_port_cfg(optimizer=opt, checkpoint_dir=path, **extra))
    t.fit(_port_data(), eval_every=0)
    jt = JTrainer(_jax_cfg(optimizer=opt, **extra))
    restored = jckpt.load_checkpoint(jt.state, path)
    _assert_trees_equal(serialization.to_state_dict(restored),
                        ck._to_host(train_state_to_jax(t)))
    with open(os.path.join(path, ck.LATEST), "rb") as f:
        assert serialization.to_bytes(restored) == f.read()


def _jax_checkpoint_and_next_step(opt, root):
    """A JAX run of one epoch with a checkpoint under ``root``, and the
    state after the first step of epoch 1 (as numpy trees)."""
    jt = JTrainer(_jax_cfg(optimizer=opt, epochs=2, checkpoint_dir=root))
    # asgd's average starts as the params' own buffers, which the donating
    # JAX step would then be handed twice
    jt.state = jt.state.replace(
        opt_state=jax.tree.map(jnp.copy, jt.state.opt_state))
    data = jload_mnist("/nonexistent", synthetic_sizes=SIZES)
    jt.train_epoch(data, 0)
    jckpt.save_checkpoint(jt.state, root, epoch=0,
                          extra_meta={"best_acc": 0.0})
    before = serialization.to_state_dict(jax.device_get(jt.state))
    images, labels = next(iter(jbatches(
        data.train_images, data.train_labels, BATCH, epoch=1, seed=1)))
    jt._apply_epoch_regime(1)
    jt.state, _ = jt.train_step(jt.state, jnp.asarray(images),
                                jnp.asarray(labels), jt.rng)
    after = serialization.to_state_dict(jax.device_get(jt.state))
    return before, after


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_port_resumes_a_jax_checkpoint_and_steps_like_jax(opt,
                                                          tmp_path_factory):
    root = str(tmp_path_factory.mktemp(f"jax_{opt}"))
    before, after = _jax_checkpoint_and_next_step(opt, root)
    t = Trainer(_port_cfg(optimizer=opt, epochs=2, checkpoint_dir=root,
                          resume=True))
    assert t.try_resume() == (1, 0)
    _assert_trees_equal(ck._to_host(train_state_to_jax(t)), before)
    data = _port_data()
    images, labels = next(iter(batch_iterator(
        data.train_images, data.train_labels, BATCH, epoch=1, seed=1)))
    t._apply_epoch_regime(1)
    x, y = t._to_device(images, labels)
    t.train_step(t.model, t.optimizer, x, y)
    t.step += 1
    got = _flat(ck._to_host(train_state_to_jax(t)))
    want = _flat(after)
    pre = _flat(before)
    assert got.keys() == want.keys()
    for k in want:
        if k[0] == "params" and k[1] in BN_BIASES and k[-1] == "bias":
            bound = 2 * max(np.abs(want[k] - pre[k]).max(),
                            np.abs(got[k] - pre[k]).max())
            assert np.abs(got[k] - want[k]).max() <= bound, k
        elif k[0] == "opt_state" and any(b in k for b in BN_BIASES) and \
                k[-1] == "bias":
            continue   # the moments of those biases: rounding noise
        elif k[0] == "batch_stats":
            np.testing.assert_allclose(got[k], want[k], atol=ATOL,
                                       rtol=STAT_RTOL, err_msg=str(k))
        elif got[k].dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
        else:
            np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0,
                                       err_msg=str(k))


@pytest.mark.parametrize("opt,mode", [("adam", "sign_ef"), ("sgd", "sign")])
def test_port_resumes_a_jax_compressed_fsdp_checkpoint(opt, mode, tmp_path):
    """A JAX checkpoint of the compressed FSDP exchange at world 1 (the
    ``FsdpCompressState``: residual rows, the base optimizer's segment
    rows) restores into the port's ``SignCompressFsdp`` trainer to the
    same state, every leaf bitwise."""
    root = str(tmp_path)
    kw = dict(optimizer=opt, dp_mode="fsdp", grad_compress=mode)
    jt = JTrainer(_jax_cfg(checkpoint_dir=root, **kw))
    jt.train_epoch(jload_mnist("/nonexistent", synthetic_sizes=SIZES), 0)
    jckpt.save_checkpoint(jt.state, root, epoch=0,
                          extra_meta={"best_acc": 0.0})
    want = serialization.to_state_dict(jax.device_get(jt.state))
    t = Trainer(_port_cfg(epochs=2, checkpoint_dir=root, resume=True, **kw))
    assert t.try_resume() == (1, 0)
    _assert_trees_equal(ck._to_host(train_state_to_jax(t)), want)


# -- artifacts ----------------------------------------------------------------


def _mlp_pair():
    from distributed_mnist_bnns_tpu.models import bnn_mlp_small as jsmall
    from distributed_mnist_bnns_tpu_torch.interop import params_from_jax

    jm = jsmall(infl_ratio=1, dropout_rate=0.0)
    v = U.np_tree(jm.init({"params": jax.random.PRNGKey(5),
                           "dropout": jax.random.PRNGKey(6)},
                          jnp.zeros((2, 28, 28, 1)), train=True))
    rng = np.random.RandomState(5)   # non-trivial BatchNorm state
    for name, bn in v["batch_stats"].items():
        bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * 0.1
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return jm, v, params_from_jax(v, dropout_rate=0.0)


def _family(name):
    if name == "mlp":
        jm, v, model = _mlp_pair()
        return jm, v, model, U.pixels(8, 31), 1e-4
    if name == "cnn":
        jm, v = U.jax_variables("bnn-cnn", 0, backend="xla")
        return jm, v, U.port_model("bnn-cnn", v, backend="xla"), \
            U.pixels(8, 32), 1e-4
    jm, params, tm = lm_pair(seed=0, scale=True)
    toks = np.stack([tokens(1, 24), tokens(2, 24)])
    return jm, {"params": params}, tm, toks, 1e-5


@pytest.mark.parametrize("family", ["mlp", "cnn", "lm"])
def test_artifacts_serve_in_both_frameworks(family, tmp_path):
    jm, variables, model, x, atol = _family(family)
    port_path = str(tmp_path / "port.msgpack")
    jax_path = str(tmp_path / "jax.msgpack")
    tinfer.export_packed(model.eval(), port_path)
    jinfer.export_packed(jm, variables, jax_path,
                         input_shape=None if family == "lm" else (28, 28, 1))
    outs = {}
    for path, who in ((port_path, "port"), (jax_path, "jax")):
        jfn, jinfo = jinfer.load_packed(path, interpret=True)
        tfn, tinfo = tinfer.load_packed(path, device="cpu")
        outs[who, "jax"] = np.asarray(jfn(jnp.asarray(x)))
        outs[who, "port"] = tfn(x if family == "lm" else torch.from_numpy(x)
                                ).numpy()
        assert tinfo == jinfo
    want = outs["jax", "jax"]
    for key, got in outs.items():
        np.testing.assert_allclose(got, want, rtol=0 if family != "lm"
                                   else 1e-5, atol=atol, err_msg=str(key))
        assert (got.argmax(-1) == want.argmax(-1)).all(), key
