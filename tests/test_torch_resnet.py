"""The port's XNOR-ResNet family (``models/resnet.py``, the registry, the
interop maps, the MAC counter and the train step) against the JAX
package's ``models/resnet.py``.

Sizes are the JAX package's own tests': resnet18 at stem 16 on 32 x 32,
resnet50 at stem 8 on 64 x 64, and for the forwards and the steps
two-stage models (stages (2, 1): an identity and a projection shortcut
in each block type) at stem 8 on 16 x 16 (the ImageNet stem on 32 x 32).
Parameters are flax's (``params_from_jax``), with drawn biases and
BatchNorm scales. Forwards: every block alone on the same input, and
whole models, train and eval mode, within 1e-6 of the output's largest
magnitude (measured: at most 1.8e-7 of it; a BatchNorm sign flipped by
a summation order would move a block's output by 2 in whole units). The
steps: three SGD steps (lr 0.01) of ``make_step_body`` against JAX's
``make_train_step`` on the same batches, at the conv families'
tolerances (``test_torch_conv_train.py``): losses rtol 2e-5, every
parameter and running statistic atol 1e-4 (statistics also rtol 5e-4);
``pallas_xnor`` (K1's plain version on the CPU) against JAX's exact
``xla``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import obs as jobs
from distributed_mnist_bnns_tpu.models import get_model as jget
from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask
from distributed_mnist_bnns_tpu.models import resnet as jres
from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu.train import optim as jopt
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch import obs as pobs
from distributed_mnist_bnns_tpu_torch.interop import (
    params_from_jax,
    params_to_jax,
    to_flax_layout,
)
from distributed_mnist_bnns_tpu_torch.models import (
    XnorResNet,
    get_model,
    latent_clamp_mask,
)
from distributed_mnist_bnns_tpu_torch.models.resnet import max_pool_same
from distributed_mnist_bnns_tpu_torch.ops import losses as tl
from distributed_mnist_bnns_tpu_torch.train import (
    make_optimizer,
    make_step_body,
)
from tests.torch_conv_util import np_tree

REL = 1e-6
STEPS, BATCH, LR, ATOL = 3, 8, 0.01, 1e-4
#: two-stage models: (flax kwargs, input (H, W, C))
SMALL = {
    "basic": (dict(stage_sizes=(2, 1), stem_features=8), (16, 16, 3)),
    "bottleneck": (dict(stage_sizes=(2, 1), bottleneck=True,
                        stem_features=8, cifar_stem=False), (32, 32, 3)),
    "fp32": (dict(stage_sizes=(2, 1), stem_features=8, binarized=False),
             (16, 16, 3)),
}


def _draw(tree, rng):
    """Drawn biases and BatchNorm scales (some negative) in every module."""
    for leaves in tree.values():
        if "kernel" not in leaves and "scale" not in leaves:
            _draw(leaves, rng)
            continue
        if "bias" in leaves:
            leaves["bias"] = (rng.randn(*leaves["bias"].shape) * 0.3
                              ).astype(np.float32)
        if "scale" in leaves:
            s = (rng.rand(*leaves["scale"].shape) + 0.5).astype(np.float32)
            s[1::5] = -s[1::5]
            leaves["scale"] = s


def _init(jm, shape, seed):
    """flax's variables of ``jm`` for (1, *shape) inputs, initialised
    under ``jax.jit`` (eagerly a resnet50's init takes tens of seconds)."""
    init = jax.jit(lambda key, x: jm.init({"params": key}, x, train=False))
    return np_tree(init(jax.random.PRNGKey(seed), jnp.zeros((1, *shape))))


def _pair(kind, seed=0, backend="xla"):
    kw, shape = SMALL[kind]
    jm = jres.XnorResNet(backend=backend, **kw)
    x = np.random.RandomState(seed).randn(BATCH, *shape).astype(np.float32)
    v = _init(jm, shape, seed)
    _draw(v["params"], np.random.RandomState(seed + 7))
    return jm, v, x


def _apply(module, v, x, train):
    """(output, updated variables) of a jitted flax ``apply`` (eager
    applies of these models take seconds each)."""
    if train:
        return jax.jit(lambda v, x: module.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
    return jax.jit(lambda v, x: module.apply(v, x, train=False))(v, x), None


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL * np.abs(want).max())


def test_shapes_of_both_stems():
    m18 = get_model("xnor-resnet18", stem_features=16)
    assert m18(torch.zeros(2, 32, 32, 3)).shape == (2, 10)
    m50 = get_model("xnor-resnet50", stem_features=8, num_classes=1000)
    assert m50(torch.zeros(1, 64, 64, 3)).shape == (1, 1000)
    assert (m18.stage_sizes, m18.bottleneck, m18.cifar_stem) == (
        (2, 2, 2, 2), False, True)
    assert (m50.stage_sizes, m50.bottleneck, m50.cifar_stem) == (
        (3, 4, 6, 3), True, False)
    assert m50.blocks[-1].conv2.features == 8 * 8 * 4
    twin = get_model("fp32-resnet18", stem_features=16)
    assert not twin.binarized and not latent_clamp_mask(twin)


@pytest.mark.parametrize("name,shape", [("xnor-resnet18", (32, 32, 3)),
                                        ("xnor-resnet50", (64, 64, 3)),
                                        ("fp32-resnet18", (32, 32, 3))])
def test_tree_round_trip_and_clamp_mask(name, shape):
    """``params_from_jax`` builds the family from a JAX tree (stages,
    stem, classes, twin) and ``params_to_jax`` gives the tree back; the
    clamp mask is JAX's: BinarizedConv kernels and biases only, never the
    stem, the shortcuts, the BatchNorms or the head."""
    kw = {"stem_features": 16 if "18" in name else 8}
    jm = jget(name, **kw)
    v = _init(jm, shape, 0)
    model = params_from_jax(v)
    assert type(model) is XnorResNet
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(v)
    assert all(jax.tree.leaves(jax.tree.map(np.array_equal, back, v)))
    flags = {"/".join(str(getattr(k, "key", k)) for k in path): bool(f)
             for path, f in jax.tree_util.tree_flatten_with_path(
                 jmask(v["params"]))[0]}
    mine = set()
    for sub, flax, kind in model.flax_names():
        for leaf in ("weight", "bias"):
            t = getattr(model.get_submodule(sub), leaf, None)
            if t is not None and any(t is p for p in
                                     latent_clamp_mask(model).values()):
                mine.add(f"{flax}/{'kernel' if leaf == 'weight' else 'bias'}")
    assert mine == {p for p, f in flags.items() if f}
    assert all("BinarizedConv" in p for p in mine)
    assert not any(p.startswith(("Conv_0", "Dense_0")) for p in mine)


@pytest.mark.parametrize("hw", [(32, 32), (33, 17), (112, 112), (7, 8)])
def test_max_pool_same_is_reduce_window_same(hw):
    x = np.random.RandomState(hw[0]).randn(2, *hw, 3).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind", list(SMALL))
def test_each_block_on_the_same_input(kind, train):
    """Every block alone, fed the same input, against the flax block's
    ``apply`` (its BatchNorm state updated in train mode)."""
    jm, v, x = _pair(kind)
    model = params_from_jax(v, backend="xla").train(train)
    block_cls = (jres.XnorBottleneckBlock if model.bottleneck
                 else jres.XnorBasicBlock)
    name = block_cls.__name__
    h = model.stem(torch.from_numpy(x).permute(0, 3, 1, 2))
    if not model.cifar_stem:
        h = max_pool_same(h)
    h = h.detach()
    cin = h.shape[1]
    for i, blk in enumerate(model.blocks):
        # the block's width: conv0's out channels (a bottleneck's conv1's)
        features = (blk.conv1 if model.bottleneck else blk.conv0
                    ).weight.shape[0]
        jb = block_cls(features, strides=blk.strides, backend="xla",
                       binarized=model.binarized)
        bv = {"params": v["params"][f"{name}_{i}"],
              "batch_stats": v["batch_stats"][f"{name}_{i}"]}
        xin = jnp.asarray(h.permute(0, 2, 3, 1).numpy())
        want, upd = _apply(jb, bv, xin, train)
        with torch.no_grad():
            got = blk(h)
        _close(got.permute(0, 2, 3, 1).numpy(), want)
        if train:
            for j in range(blk.n_convs):
                bn = getattr(blk, f"bn{j}")
                st = upd["batch_stats"][f"BatchNorm_{j}"]
                np.testing.assert_allclose(bn.running_mean.numpy(),
                                           st["mean"], rtol=5e-4,
                                           atol=1e-6)
                np.testing.assert_allclose(bn.running_var.numpy(),
                                           st["var"], rtol=5e-4, atol=1e-6)
        h, cin = got, got.shape[1]
    assert cin == model.bn.num_features


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name,shape,kw", [
    ("xnor-resnet18", (32, 32, 3), {"stem_features": 16})])
def test_whole_models_match_apply(name, shape, kw, train):
    """The registry's resnet18 end to end (resnet50's eval forward is
    held through its frozen form in ``test_torch_infer_resnet.py``; the
    blocks of both types and of the fp32 twin above)."""
    jm = jget(name, **({} if "fp32" in name else {"backend": "xla"}), **kw)
    x = np.random.RandomState(3).randn(2, *shape).astype(np.float32)
    v = _init(jm, shape, 1)
    _draw(v["params"], np.random.RandomState(4))
    model = params_from_jax(v, backend="xla").train(train)
    want, _ = _apply(jm, v, jnp.asarray(x), train)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, want)


def test_macs_equal_the_jaxpr_walk_on_every_backend():
    jm = jget("xnor-resnet18", stem_features=16)
    v = _init(jm, (32, 32, 3), 0)
    want = jobs.jaxpr_macs_per_example(jm.apply, v, (32, 32, 3))
    for backend in ("bf16", "pallas_xnor", "int8"):
        model = get_model("xnor-resnet18", stem_features=16, backend=backend)
        assert pobs.module_macs_per_example(model, (32, 32, 3)) == want > 0
    flops = pobs.train_step_flops("xnor-resnet18", model, 64,
                                  input_shape=(32, 32, 3))
    assert flops == (6.0 * want * 64,
                     "analytic_3x_conv_and_dense_from_flop_counter")


def _check_params(model, jparams, jstats):
    for sub, flax, kind in model.flax_names():
        mod = model.get_submodule(sub)
        tree_p = jparams
        tree_s = jstats
        for part in flax.split("/"):
            tree_p = tree_p[part]
            tree_s = tree_s.get(part, {}) if kind == "bn" else tree_s
        leaves = [("weight", tree_p, "scale" if kind == "bn" else "kernel",
                   0), ("bias", tree_p, "bias", 0)]
        if kind == "bn":
            leaves += [("running_mean", tree_s, "mean", 5e-4),
                       ("running_var", tree_s, "var", 5e-4)]
        for port, tree, leaf, rtol in leaves:
            t = getattr(mod, port, None)
            if t is None:
                assert leaf not in tree, f"{flax}/{leaf}"
                continue
            got = to_flax_layout(t.detach(), kind).numpy()
            np.testing.assert_allclose(got, tree[leaf], rtol=rtol,
                                       atol=ATOL, err_msg=f"{flax}/{leaf}")


STEP_CASES = [("basic", "xla"), ("basic", "bf16"), ("basic", "pallas_xnor"),
              ("bottleneck", "pallas_xnor"), ("fp32", "xla")]


@pytest.mark.parametrize("kind,backend", STEP_CASES,
                         ids=[f"{k}-{b}" for k, b in STEP_CASES])
def test_three_sgd_steps_match_jax_make_train_step(kind, backend):
    jbackend = "xla" if backend == "pallas_xnor" else backend
    jm, v, x = _pair(kind, seed=2, backend=jbackend)
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = jopt.make_optimizer("sgd", LR)
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)
    jstep = jtrainer.make_train_step(jmask(params), loss_fn=jl.make_loss("ce"),
                                     donate=False)
    model = params_from_jax(v, backend=backend)
    optimizer = make_optimizer("sgd", model.parameters(), LR)
    step = make_step_body(latent_clamp_mask(model),
                          loss_fn=tl.make_loss("ce"))
    rng = np.random.RandomState(30)
    for s in range(STEPS):
        xs = rng.randn(*x.shape).astype(np.float32)
        ys = rng.randint(0, 10, BATCH).astype(np.int32)
        state, m = jstep(state, jnp.asarray(xs), jnp.asarray(ys),
                         jax.random.PRNGKey(0))
        loss, acc = step(model, optimizer, torch.from_numpy(xs),
                         torch.from_numpy(ys).long())
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=2e-5)
        assert acc.item() == pytest.approx(float(m["accuracy"]))
    _check_params(model, np_tree(state.params), np_tree(state.batch_stats))
    for p in latent_clamp_mask(model).values():
        assert float(p.detach().abs().max()) <= 1.0
