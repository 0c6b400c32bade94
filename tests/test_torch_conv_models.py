"""The port's conv families and the flagship's fp32 twin (``ConvNet``,
``DeepCNN``, ``BinarizedCNN``, ``fp32-mlp-large``) against the JAX
package's flax models, on the same numpy inputs, weights carried across
with ``interop.params_from_jax`` (``tests/torch_conv_util.py``: drawn
biases and BatchNorm state; bnn-cnn at widths (16, 32), hidden 128).

Tolerances, from the gaps measured at seeds 0 and 1 (in brackets):
  * fp32 logits and log-probs: atol 1e-4 [2.8e-5]; the loss rtol 1e-5
    [1.2e-6];
  * fp32 gradients: atol 5e-5 plus rtol 1e-4 of each leaf's largest
    value [1.5e-5]. The biases of a layer that feeds a train-mode
    BatchNorm have an exact-zero gradient that both frameworks compute
    as noise: held to 1e-5 [1.4e-6];
  * bnn-cnn's first conv and BatchNorm (upstream of the first max-pool
    over hard_tanh maps, where values tie at exactly +-1 and near-ties
    are common): relative L2 error 0.1 [0.05]. XLA on the CPU sums the
    BatchNorm statistics of 12,544 values with an error of 2.8e-5 (the
    port's: 8.2e-7 against float64), which moves BN outputs by up to
    2.3e-4 and so reroutes the max-pool's gradient at near-ties; every
    layer downstream is held elementwise;
  * bf16 precision (flax ``dtype=bfloat16``; PyTorch's bf16 convs round
    in another order): logits atol 8e-3 [4.7e-3], loss rtol 5e-4
    [1.6e-4], all gradients as one vector relative L2 1e-2 [3.2e-3],
    each leaf's relative L2 0.1 [5.6e-2]. The port's fp32 run misses the
    logits and the gradient vector: against JAX's bf16 run it is off by
    [1.2e-2 to 2.4e-2] and [2.3e-2 to 4.9e-2] (its loss, [7.6e-5 to
    8.8e-4], and its worst leaf, [6.9e-2 to 0.13], are not told apart).
    Each layer's output dtype is also held to flax's, so a layer left in
    fp32 fails whatever the numbers;
  * running statistics after a train step: rtol 5e-4, atol 1e-4
    [2.2e-4 relative, the XLA summation above].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask
from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu_torch.interop import (
    JaxFlatOrder,
    params_from_jax,
)
from distributed_mnist_bnns_tpu_torch.models import (
    BinarizedCNN,
    BnnMLP,
    ConvNet,
    DeepCNN,
    get_model,
    latent_clamp_mask,
)
from distributed_mnist_bnns_tpu_torch.ops import losses as tl
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from tests import torch_conv_util as U

FAM = list(U.FAMILIES)
SEEDS = [0, 1]
GRAD_ATOL, GRAD_RTOL = 5e-5, 1e-4
NOISE = 1e-5
UPSTREAM_REL = 0.1
BF16 = dict(logits=8e-3, loss=5e-4, grad_rel=1e-2, leaf_rel=1e-1)
#: biases in front of a train-mode BatchNorm (exact-zero gradients)
BN_FED = {"convnet": ("Conv_0", "Conv_1"),
          "bnn-cnn": ("BinarizedConv_0", "BinarizedConv_1",
                      "BinarizedDense_0"),
          "fp32-mlp-large": ("Dense_0", "Dense_1", "Dense_2"),
          "deep-cnn": ()}


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_step(name, v, x, y, **kw):
    """JAX train-mode loss, logits, grads and new batch stats."""
    jm = U.jax_model(name, **kw)
    stats = {"batch_stats": v["batch_stats"]} if v.get("batch_stats") else {}

    def f(p):
        out, st = jm.apply({"params": p, **stats}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"],
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jl.cross_entropy_loss(out, jnp.asarray(y)), (out, st)

    (loss, (out, st)), g = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, v["params"]))
    return float(loss), np.asarray(out, np.float32), U.np_tree(g), U.np_tree(
        st.get("batch_stats", {}))


def _port_step(model, x, y):
    model.train()
    model.zero_grad()
    out = model(torch.from_numpy(x))
    loss = tl.cross_entropy_loss(out, torch.from_numpy(y).long())
    loss.backward()
    return float(loss), out.detach().float().numpy(), U.flax_grads(model)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FAM)
def test_eval_forward_matches_flax(name, seed):
    jm, v = U.jax_variables(name, seed)
    x = U.pixels(16, seed)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    got = U.port_model(name, v)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", FAM)
def test_train_step_loss_gradients_and_stats_match_flax(name, seed):
    """One train-mode forward (batch statistics), its cross-entropy loss
    and every parameter's gradient; the running statistics it leaves."""
    jm, v = U.jax_variables(name, seed)
    x, y = U.pixels(16, seed), U.labels(16, seed)
    jloss, jout, jgrads, jstats = _jax_step(name, v, x, y)
    model = U.port_model(name, v)
    loss, out, grads = _port_step(model, x, y)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-4)
    upstream = ("BinarizedConv_0", "BatchNorm_0") if name == "bnn-cnn" \
        else ()
    for mod, leaves in jgrads.items():
        for leaf, want in leaves.items():
            got = grads[mod][leaf]
            what = f"{mod}/{leaf}"
            if leaf == "bias" and mod in BN_FED[name]:
                assert np.abs(got).max() <= NOISE, what
                assert np.abs(want).max() <= NOISE, what
            elif mod in upstream:
                assert _rel_l2(got, want) <= UPSTREAM_REL, what
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0,
                    atol=GRAD_ATOL + GRAD_RTOL * np.abs(want).max(),
                    err_msg=what)
    for sub, flax_name, kind in model.flax_names():
        if kind != "bn":
            continue
        bn = model.get_submodule(sub)
        for port, leaf in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, port).numpy(), jstats[flax_name][leaf],
                rtol=5e-4, atol=1e-4, err_msg=f"{flax_name}/{leaf}")


BACKENDS = ("xla", "bf16", "int8", "xnor", "pallas_xnor")


def test_bnn_cnn_backends_are_bitwise_one_another_and_match_flax():
    """bnn-cnn on every backend. xla, int8, xnor and pallas_xnor (the
    first conv falls back to xla on the last three; the rest are exact
    ±1 sums) give bitwise-equal logits and loss. Gradients are bitwise
    within each lowering: xla and int8 share the fp32 conv VJP, xnor and
    pallas_xnor the patch GEMM's fp32 backward and im2col's adjoint;
    across the two the sums run in other orders (as in JAX, whose
    lowerings differ alike), so they agree to GRAD_ATOL. Each backend
    matches the flax model on xla (bf16: on bf16, which rounds the raw
    pixels)."""
    jm, v = U.jax_variables("bnn-cnn", 0)
    x, y = U.pixels(16, 0), U.labels(16, 0)
    runs = {}
    for backend in BACKENDS:
        jb = "bf16" if backend == "bf16" else "xla"
        jloss, jout, _, _ = _jax_step("bnn-cnn", v, x, y, backend=jb)
        model = U.port_model("bnn-cnn", v, backend=backend)
        runs[backend] = _port_step(model, x, y)
        np.testing.assert_allclose(runs[backend][1], jout, rtol=0, atol=1e-4)
        np.testing.assert_allclose(runs[backend][0], jloss, rtol=1e-5)
    ref = runs["xla"]
    for backend, twin in (("int8", "xla"), ("xnor", "xla"),
                          ("pallas_xnor", "xnor")):
        loss, out, grads = runs[backend]
        assert loss == ref[0] and np.array_equal(out, ref[1]), backend
        for mod, leaves in grads.items():
            for leaf, g in leaves.items():
                if backend == "xnor":
                    np.testing.assert_allclose(
                        g, ref[2][mod][leaf], rtol=0, atol=GRAD_ATOL)
                else:
                    assert np.array_equal(g, runs[twin][2][mod][leaf]), (
                        backend, mod, leaf)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["convnet", "deep-cnn"])
def test_bf16_precision_matches_flax_dtype(name, seed):
    """flax's ``dtype=bfloat16`` against the port's ``dtype=
    torch.bfloat16``: logits, loss and gradients at the BF16 tolerances,
    which the port's fp32 run misses; each layer's output in flax's
    dtype; the bf16 model really rounds (its logits differ from fp32's)."""
    jm, v = U.jax_variables(name, seed)
    x, y = U.pixels(16, seed), U.labels(16, seed)
    jloss, jout, jgrads, _ = _jax_step(name, v, x, y, dtype=jnp.bfloat16)
    model = U.port_model(name, v, dtype=torch.bfloat16)
    seen = {}

    def record(name):
        def hook(mod, inputs, out):
            seen[name] = out.dtype
        return hook

    for sub, flax_name, _ in model.flax_names():
        model.get_submodule(sub).register_forward_hook(record(flax_name))
    loss, out, grads = _port_step(model, x, y)
    np.testing.assert_allclose(out, jout, rtol=0, atol=BF16["logits"])
    np.testing.assert_allclose(loss, jloss, rtol=BF16["loss"])
    keys = [(mod, leaf) for mod, leaves in jgrads.items() for leaf in leaves
            # noise both sides, larger in bf16
            if not (leaf == "bias" and mod in BN_FED[name])]
    for mod, leaf in keys:
        assert _rel_l2(grads[mod][leaf], jgrads[mod][leaf]) <= \
            BF16["leaf_rel"], (mod, leaf)
    assert _rel_l2(np.concatenate([grads[m][l].ravel() for m, l in keys]),
                   np.concatenate([jgrads[m][l].ravel() for m, l in keys])
                   ) <= BF16["grad_rel"]
    _, inter = U.jax_model(name, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(x), train=False, capture_intermediates=True)
    want = {n: str(o["__call__"][0].dtype)
            for n, o in inter["intermediates"].items() if n in seen}
    assert set(want) == set(seen) and "bfloat16" in want.values()
    assert {n: str(d).replace("torch.", "") for n, d in seen.items()} == \
        want
    fp32 = U.port_model(name, v)
    fp32.train()
    assert not np.array_equal(fp32(torch.from_numpy(x)).detach().numpy(),
                              out)
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("name", FAM)
def test_latent_clamp_mask_is_jax_set(name):
    jm, v = U.jax_variables(name, 0)
    jflat = jax.tree_util.tree_flatten_with_path(jmask(v["params"]))[0]
    want = {"/".join(k.key for k in path) for path, on in jflat if on}
    model = U.port_model(name, v)
    flax_of = {sub: fl for sub, fl, _ in model.flax_names()}
    got = set()
    for qual in latent_clamp_mask(model):
        sub, leaf = qual.rsplit(".", 1)
        got.add(f"{flax_of[sub]}/{'kernel' if leaf == 'weight' else leaf}")
    assert got == want
    assert bool(want) == (name == "bnn-cnn")


@pytest.mark.parametrize("name", FAM)
def test_jax_flat_order_is_ravel_pytree(name):
    """``JaxFlatOrder`` lays the parameters out as ``ravel_pytree`` lays
    the flax params (sorted paths, HWIO and (in, out) kernels), bitwise,
    and ``unflatten`` inverts it."""
    jm, v = U.jax_variables(name, 0)
    want = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray,
                                                v["params"]))[0])
    model = U.port_model(name, v)
    order = JaxFlatOrder(model)
    flat = order.flatten()
    np.testing.assert_array_equal(flat.numpy(), want)
    back = order.unflatten(flat)
    for p in model.parameters():
        assert torch.equal(back[p], p.detach())


@pytest.mark.parametrize("name,cls", [("convnet", ConvNet),
                                      ("deep-cnn", DeepCNN),
                                      ("bnn-cnn", BinarizedCNN),
                                      ("fp32-mlp-large", BnnMLP)])
def test_params_from_jax_infers_the_family(name, cls):
    jm, v = U.jax_variables(name, 0)
    model = params_from_jax(v)
    assert type(model) is cls
    want = U.port_model(name, v).state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)


def test_trainer_drops_the_knobs_a_model_rejects():
    """The JAX ``_build_model`` rule: fp32-mlp-large under bf16 stays
    fp32, convnet takes the dtype but no backend, bnn-cnn the backend but
    no dtype."""
    def model_of(name, **kw):
        return Trainer(TrainConfig(model=name, device="cpu", **kw)).model

    m = model_of("fp32-mlp-large", precision="bf16", backend="xla",
                 model_kwargs={"infl_ratio": 1})
    assert not m.binarized and m.fc1.weight.dtype == torch.float32
    assert m.bn1.dtype is None
    m = model_of("convnet", precision="bf16", backend="pallas_xnor")
    assert m.dtype == torch.bfloat16 and m.bn1.dtype == torch.bfloat16
    m = model_of("bnn-cnn", precision="bf16", backend="pallas_xnor")
    assert m.conv2.backend == "pallas_xnor" and m.conv1.gemm_backend() == "xla"
    with pytest.raises(ValueError, match="precision"):
        model_of("convnet", precision="fp16")


def test_deep_cnn_dropout_draws_from_the_models_generator():
    """Dropout 0.5 after fc1 in train mode: two models of one seed drop
    the same units, another seed others, eval drops none; torch's global
    RNG is untouched."""
    x = torch.from_numpy(U.pixels(4, 0))
    models = [get_model("deep-cnn", rng_seed=seed,
                        generator=torch.Generator().manual_seed(0))
              for seed in (1, 1, 2)]
    state = torch.get_rng_state()
    a, b, c = (m.train()(x).detach() for m in models)
    assert torch.equal(state, torch.get_rng_state())
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(models[0].eval()(x), models[2].eval()(x))
