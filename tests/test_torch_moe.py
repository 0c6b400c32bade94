"""The routed binarized MoE of the PyTorch port (``ops.routing``,
``models.moe``, the trainer's auxiliary loss, ``infer_moe``, the MoE's
data- and tensor-parallel steps) against the JAX package's.

Routing is held exactly: the same gates give the same 0/1 dispatch, and
the combine weights within rtol 1e-6 (bitwise here). Gates computed on
each side differ by ulps, and a token whose top gates sit within ulps of
each other could pick another expert on the other side, moving every
later slot; so the parity inputs assert a margin of at least 1e-4
between each token's k-th and (k+1)-th gate (and its first and second)
before they are compared. Forward outputs, losses and gradients are fp32
sums in two frameworks' orders: atol 1e-5 (measured ~1e-6 at these
widths; a loss also rtol 1e-6, an ulp of the sqrt-hinge's ~145). A
binarized net at its zero-bias init ties exactly, so the parity weights
draw non-zero biases. Two gloo ranks on the CPU hold the
data-parallel step (global routing) to one process and the
tensor-parallel step (experts sharded) to the unsharded one, step by
step on the same parameters.
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
from distributed_mnist_bnns_tpu.infer_moe import freeze_bnn_moe as jfreeze
from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask
from distributed_mnist_bnns_tpu.models.moe import BinarizedExperts as JExperts
from distributed_mnist_bnns_tpu.models.moe import BnnMoEMLP as JMoE
from distributed_mnist_bnns_tpu.obs.flops import (
    train_step_flops as jflops,
)
from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu.ops import routing as jr
from distributed_mnist_bnns_tpu.parallel.model_parallel import (
    tp_rules_for as jtp_rules_for,
)
from distributed_mnist_bnns_tpu.train import optim as jopt
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.data import ImageClassData
from distributed_mnist_bnns_tpu_torch.infer import (
    _freeze_any,
    export_packed,
    load_frozen,
    load_packed,
)
from distributed_mnist_bnns_tpu_torch.infer_moe import (
    FrozenMoE,
    freeze_bnn_moe,
)
from distributed_mnist_bnns_tpu_torch.interop import (
    flax_params,
    params_from_jax,
    params_to_jax,
)
from distributed_mnist_bnns_tpu_torch.models import (
    BinarizedExperts,
    BnnMoEMLP,
    get_model,
    latent_clamp_mask,
)
from distributed_mnist_bnns_tpu_torch.obs.flops import train_step_flops
from distributed_mnist_bnns_tpu_torch.ops import routing as tr
from distributed_mnist_bnns_tpu_torch.ops.losses import make_loss
from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import BACKENDS
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.parallel.model_parallel import (
    BNN_MOE_TP_TABLE,
    tp_rules_for,
    tp_table_for,
)
from distributed_mnist_bnns_tpu_torch.train import (
    TrainConfig,
    Trainer,
    make_optimizer,
    make_step_body,
)
from tests import torch_mp_util as mp_util

ATOL = 1e-5
MARGIN = 1e-4
SMALL = dict(hidden=32, num_experts=4, expert_features=32)
BATCH, LR = 16, 0.05


def _np_tree(t):
    return jax.tree.map(
        lambda a: np.array(a) if hasattr(a, "shape") else a, t)


def _gates(t=32, e=8, seed=0):
    logits = np.random.RandomState(seed).randn(t, e).astype(np.float32)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    return (g / g.sum(-1, keepdims=True)).astype(np.float32)


def _margin(gates: np.ndarray, k: int) -> float:
    s = -np.sort(-gates, axis=-1)
    return float(min((s[:, 0] - s[:, 1]).min(), (s[:, k - 1] - s[:, k]).min()))


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 3), (2, 16), (3, 5)])
def test_dispatch_and_combine_equal_jax(k, capacity):
    """The same gates route the same: dispatch exact, combine at rtol 1e-6
    (top-1 through ``top1_dispatch``, else ``topk_dispatch``)."""
    gates = _gates(t=40, e=6, seed=k + capacity)
    jfn = jr.top1_dispatch if k == 1 else functools.partial(
        jr.topk_dispatch, k=k)
    tfn = tr.top1_dispatch if k == 1 else functools.partial(
        tr.topk_dispatch, k=k)
    jd, jc = jfn(jnp.asarray(gates), capacity)
    td, tc = tfn(torch.from_numpy(gates), capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=0)


def test_ties_break_to_the_first_expert():
    """Gates tied on purpose: both sides pick the first maximal expert
    (``torch.argmax`` and ``jnp.argmax``), for each of the k choices."""
    gates = np.full((6, 4), 0.25, np.float32)
    gates[1] = [0.4, 0.1, 0.4, 0.1]
    gates[2] = [0.1, 0.3, 0.3, 0.3]
    for k in (1, 2, 3):
        jd, jc = jr.topk_dispatch(jnp.asarray(gates), 6, k)
        td, tc = tr.topk_dispatch(torch.from_numpy(gates), 6, k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    d, _ = tr.top1_dispatch(torch.from_numpy(gates), 6)
    assert d[0, 0].sum() == 1 and d[1, 0].sum() == 1 and d[2, 1].sum() == 1


def test_each_token_uses_k_distinct_experts():
    dispatch, combine = tr.topk_dispatch(torch.from_numpy(_gates()), 32, 2)
    assert torch.equal(dispatch.sum(dim=(1, 2)), torch.full((32,), 2.0))
    assert dispatch.sum(dim=2).max() == 1.0
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               atol=1e-5)


def test_capacity_respected_and_slots_unique():
    dispatch, _ = tr.topk_dispatch(torch.from_numpy(_gates(64, 4)), 3, 2)
    assert dispatch.sum(dim=(0, 2)).max() <= 3.0
    assert dispatch.sum(dim=0).max() <= 1.0


def test_first_choices_win_slots_over_second():
    """Choice-major filling: everyone's top-1 before anyone's top-2."""
    gates = torch.tensor([[0.8, 0.2], [0.6, 0.4], [0.3, 0.7]])
    dispatch, _ = tr.topk_dispatch(gates, 2, 2)
    assert dispatch[2, 0].sum() == 0 and dispatch[0, 0].sum() == 1
    assert dispatch[1, 0].sum() == 1


def test_k_bounds_validated():
    with pytest.raises(ValueError, match="top-k"):
        tr.topk_dispatch(torch.from_numpy(_gates(e=4)), 4, 5)


def test_load_balance_loss_equals_jax_and_bounds():
    """1 at uniform routing, E when collapsed; value and gradient through
    the softmax against JAX's."""
    assert abs(tr.load_balance_loss(torch.full((64, 8), 1 / 8)).item()
               - 1.0) < 1e-5
    collapsed = torch.zeros(64, 8)
    collapsed[:, 3] = 1.0
    assert abs(tr.load_balance_loss(collapsed).item() - 8.0) < 1e-5
    logits = np.random.RandomState(0).randn(32, 4).astype(np.float32)
    jv, jg = jax.value_and_grad(
        lambda lg: jr.load_balance_loss(jax.nn.softmax(lg)))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    v = tr.load_balance_loss(torch.softmax(lt, dim=-1))
    v.backward()
    assert abs(v.item() - float(jv)) <= 1e-6
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-7)
    assert lt.grad.abs().max() > 0


# -- the experts and the model --------------------------------------------------


def test_underfull_expert_binarizes_first_on_every_backend():
    """An expert left with empty slots: the slot's 0 binarizes to +1
    before the product (JAX's order), its combine weight is 0, and every
    backend (K1's plain version on "pallas_xnor") gives JAX's output
    bitwise."""
    rng = np.random.RandomState(1)
    t, e, d = 12, 4, 16
    x = rng.randn(t, d).astype(np.float32)
    gates = rng.rand(t, e).astype(np.float32)
    gates[:, 3] = 0.0      # expert 3 is nobody's choice
    gates /= gates.sum(-1, keepdims=True)
    dispatch, combine = jr.topk_dispatch(jnp.asarray(gates), 8, 2)
    assert float(dispatch[:, 3].sum()) == 0.0
    jm = JExperts(e, 24)
    jp = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), dispatch,
                          combine))
    jp["params"]["b"] = rng.randn(e, 24).astype(np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x), dispatch, combine))
    for backend in BACKENDS:
        m = BinarizedExperts(e, d, 24, backend=backend)
        with torch.no_grad():
            m.w.copy_(torch.from_numpy(jp["params"]["w"]))
            m.b.copy_(torch.from_numpy(jp["params"]["b"]))
        got = m(torch.from_numpy(x), torch.from_numpy(np.array(dispatch)),
                torch.from_numpy(np.array(combine)))
        np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                                   err_msg=backend)


def _jax_model(aux_coef=0.01):
    return JMoE(backend="xla", aux_coef=aux_coef, **SMALL)


def _images(n=BATCH, seed=3):
    return np.random.RandomState(seed).randn(n, 28, 28, 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables(seed=0):
    """JAX init with every bias, BN scale and shift and the running
    statistics drawn (no exact ties), as numpy."""
    v = _np_tree(_jax_model().init(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 784)),
        train=True))
    rng = np.random.RandomState(seed + 100)
    p = v["params"]
    for name in ("BinarizedDense_0", "BinarizedDense_1", "router"):
        p[name]["bias"] = rng.randn(*p[name]["bias"].shape).astype(
            np.float32) * 0.3
    p["BinarizedExperts_0"]["b"] = rng.randn(
        *p["BinarizedExperts_0"]["b"].shape).astype(np.float32) * 2.0
    for name in ("BatchNorm_0", "BatchNorm_1"):
        c = p[name]["scale"].shape
        p[name]["scale"] = (0.5 + rng.rand(*c)).astype(np.float32)
        p[name]["bias"] = (rng.randn(*c) * 0.1).astype(np.float32)
        v["batch_stats"][name]["mean"] = (rng.randn(*c) * 3).astype(
            np.float32)
        v["batch_stats"][name]["var"] = (1 + rng.rand(*c) * 50).astype(
            np.float32)
    return v


def _port(seed=0, backend="xla", **kw):
    return params_from_jax(_variables(seed), backend=backend, **kw)


def _port_gates(model, x, train=True):
    model.train(train)
    h = model.fc1(torch.from_numpy(x).reshape(len(x), -1))
    h = torch.clamp(model.bn1(h), -1, 1)
    return torch.softmax(model.router(h), dim=-1).detach().numpy()


def test_params_cross_both_ways():
    """``params_to_jax`` gives back JAX's tree leaf for leaf: the router
    (a "dense" leaf, (in, out)), the stacked BinarizedExperts_0 w and b
    (their own layout), the binarized dense layers and BatchNorms."""
    back = params_to_jax(_port())
    flat = lambda t: {"/".join(str(getattr(k, "key", k)) for k in p): x
                      for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat(_variables()), flat(back)
    assert got.keys() == want.keys()
    assert got["params/BinarizedExperts_0/w"].shape == (4, 32, 32)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_registry_clamp_mask_and_tp_table():
    """bnn-moe-mlp's defaults (hidden 512, 8 experts of 512, top-2,
    capacity factor 1.25); the experts' w and b and the binarized dense
    layers are clamped, the fp32 router is not (JAX's mask on the same
    tree); ``tp_table_for`` is BNN_MOE_TP_TABLE, JAX's layout."""
    model = get_model("bnn-moe-mlp",
                      generator=torch.Generator().manual_seed(0))
    assert (model.hidden, model.num_experts, model.expert_features,
            model.router_k, model.capacity_factor) == (512, 8, 512, 2, 1.25)
    assert tuple(model.experts.w.shape) == (8, 512, 512)
    mask = latent_clamp_mask(_port())
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): m
             for path, m in jax.tree_util.tree_flatten_with_path(
                 jmask(_variables()["params"]))[0]}
    assert jflat["BinarizedExperts_0/w"] and not jflat["router/kernel"]
    assert sorted(mask) == ["experts.b", "experts.w", "fc1.bias",
                            "fc1.weight", "head.bias", "head.weight"]
    assert sum(jflat.values()) == len(mask)
    assert tp_table_for("bnn-moe-mlp") is BNN_MOE_TP_TABLE
    got = tp_rules_for("bnn-moe-mlp", flax_params(_port()))
    want = jtp_rules_for("bnn-moe-mlp", _variables()["params"])
    assert tuple(got["BinarizedExperts_0"]["w"]) == ("model",)
    for mod, leaves in want.items():
        for leaf, spec in leaves.items():
            assert tuple(got[mod][leaf]) == tuple(spec), (mod, leaf)


@pytest.mark.parametrize("train", [True, False])
def test_forward_and_aux_loss_equal_jax(train):
    """Train mode (batch statistics, the recorded aux loss) and eval mode
    against JAX's apply on the same weights, with margins asserted."""
    x = _images()
    model = _port()
    assert _margin(_port_gates(model, x, train), 2) > MARGIN
    model.train(train)
    out = model(torch.from_numpy(x))
    if train:
        jout, mut = _jax_model().apply(
            _variables(), jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"])
        jaux = mut["intermediates"]["aux_loss"][0]
        assert abs(model.aux_loss.item() - float(jaux)) <= 1e-7
    else:
        jout = _jax_model().apply(_variables(), jnp.asarray(x))
        assert model.aux_loss is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)


def _jax_steps(xs, ys, *, aux_coef=0.01, grad_accum=1, loss="ce",
               opt="sgd"):
    model = _jax_model(aux_coef)
    v = _variables()
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = jopt.make_optimizer(opt, LR)
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
        opt_state=tx.init(params), apply_fn=model.apply, tx=tx)
    step = jtrainer.make_train_step(jmask(params),
                                    loss_fn=jl.make_loss(loss),
                                    grad_accum=grad_accum, donate=False)
    out = []
    for x, y in zip(xs, ys):
        state, metrics = step(state, jnp.asarray(x), jnp.asarray(y),
                              jax.random.PRNGKey(0))
        out.append((float(metrics["loss"]), _np_tree(
            {"params": state.params, "batch_stats": state.batch_stats})))
    return out


def _batches(n=2, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, BATCH, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (n, BATCH)).astype(np.int64))


def _assert_state(model, want, what):
    ref = params_from_jax(want, get_model("bnn-moe-mlp", **SMALL))
    got = model.state_dict()
    for name, t in ref.state_dict().items():
        if "num_batches" in name:
            continue
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), atol=ATOL,
                                   rtol=1e-5, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("kw", [dict(), dict(grad_accum=2),
                                dict(loss="sqrt_hinge")])
def test_train_steps_equal_jax_with_aux_loss(kw):
    """Two SGD steps of the port's step body against JAX's
    ``make_train_step`` (whose loss adds the sown aux_loss): the logged
    losses, which hold the term, the latents and the running statistics.
    SGD, since fc1's bias feeds a train-mode BatchNorm: its exact
    gradient is 0, and Adam turns each side's rounding noise into moves
    of up to lr (``test_torch_train`` holds Adam to the step bound)."""
    xs, ys = _batches()
    for x in xs:   # every microbatch routes with a margin
        for half in np.split(x, kw.get("grad_accum", 1)):
            assert _margin(_port_gates(_port(), half), 2) > MARGIN
    want = _jax_steps(xs, ys.astype(np.int32), **kw)
    model = _port()
    opt = make_optimizer(kw.get("opt", "sgd"), model.parameters(), LR)
    step = make_step_body(latent_clamp_mask(model),
                          loss_fn=make_loss(kw.get("loss", "ce")),
                          grad_accum=kw.get("grad_accum", 1))
    for i, (x, y) in enumerate(zip(xs, ys)):
        loss, _ = step(model, opt, torch.from_numpy(x), torch.from_numpy(y))
        assert np.isclose(loss.item(), want[i][0], rtol=1e-6, atol=ATOL)
        _assert_state(model, want[i][1], f"step {i}")


def test_remat_is_bitwise_the_plain_step():
    """With ``remat`` the aux loss comes back with the checkpoint's output
    (the recompute records it again but is never read): two steps equal
    the plain step's bitwise."""
    xs, ys = _batches()
    runs = []
    for remat in (False, True):
        model = _port()
        opt = make_optimizer("adam", model.parameters(), LR)
        step = make_step_body(latent_clamp_mask(model), remat=remat)
        losses = [step(model, opt, torch.from_numpy(x),
                       torch.from_numpy(y))[0].item()
                  for x, y in zip(xs, ys)]
        runs.append((losses, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][name]), name


def test_aux_loss_reaches_router_gradient():
    """JAX's oracle: with aux_coef 1 and constant labels the router still
    learns; its gradient matches JAX's (through the combine weights and
    the balance term's p)."""
    x = _images(16, seed=5)
    labels = np.zeros(16, np.int64)
    model = _port(aux_coef=1.0).train()
    assert _margin(_port_gates(model, x), 2) > MARGIN

    def jloss(params):
        out, mut = _jax_model(1.0).apply(
            {"params": params, "batch_stats": _variables()["batch_stats"]},
            jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"])
        return (jl.cross_entropy_loss(out, jnp.asarray(labels, np.int32))
                + mut["intermediates"]["aux_loss"][0])

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, _variables()["params"]))
    out = model(torch.from_numpy(x))
    (make_loss("ce")(out, torch.from_numpy(labels))
     + model.aux_loss).backward()
    np.testing.assert_allclose(model.router.weight.grad.numpy().T,
                               np.asarray(jg["router"]["kernel"]),
                               atol=ATOL)
    np.testing.assert_allclose(model.router.bias.grad.numpy(),
                               np.asarray(jg["router"]["bias"]), atol=ATOL)
    assert model.router.weight.grad.abs().max() > 0
    before = model.router.weight.detach().clone()
    opt = make_optimizer("sgd", model.parameters(), 0.1)
    make_step_body(latent_clamp_mask(model))(
        model, opt, torch.from_numpy(x), torch.from_numpy(labels))
    assert (model.router.weight - before).abs().max() > 0


def _blobs(n=256, test=64):
    from distributed_mnist_bnns_tpu_torch.data import synthetic_blobs

    tr_x, tr_y, te_x, te_y = synthetic_blobs((28, 28, 1), n, test, seed=0)
    return ImageClassData(tr_x.astype(np.float32) / 255.0, tr_y,
                          te_x.astype(np.float32) / 255.0, te_y)


def test_trainer_converges_with_aux_loss():
    """JAX's convergence check through the port's Trainer: loss falls and
    the blobs separate (K1's plain version: ``pallas_xnor``)."""
    trainer = Trainer(TrainConfig(
        model="bnn-moe-mlp", model_kwargs=dict(SMALL), epochs=3,
        batch_size=64, optimizer="adam", learning_rate=0.003,
        backend="pallas_xnor", seed=0, device="cpu"))
    history = trainer.fit(_blobs())
    assert history[-1]["train_loss"] < history[0]["train_loss"]
    assert history[-1]["test_acc"] > 50.0


def test_flops_count_as_jax():
    """``obs.flops.train_step_flops`` counts both new families as JAX's
    does (every rank-2 leaf; the experts' stacked w is rank 3)."""
    from distributed_mnist_bnns_tpu.models.mlp import QnnMLP as JQnn

    from distributed_mnist_bnns_tpu_torch.models import QnnMLP

    hidden = (96, 64, 48)
    jq = _np_tree(JQnn(hidden=hidden).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 784)))["params"])
    for name, model, params in (
            ("bnn-moe-mlp", _port(), _variables()["params"]),
            ("qnn-mlp-large", QnnMLP(hidden=hidden), jq)):
        assert train_step_flops(name, model, 32) == jflops(name, params, 32)


# -- frozen serving ------------------------------------------------------------


def _jax_frozen(seed=0):
    return jfreeze(_jax_model(), _variables(seed), interpret=True)


@pytest.mark.parametrize("seed", [0, 7])
def test_frozen_equals_jax_and_live_eval(seed):
    """The frozen predictor against JAX's frozen predictor (Pallas K1 in
    interpret mode) and the port's live eval forward; the packed expert
    planes and head planes bitwise JAX's."""
    x = _images(16, seed=seed + 20)
    model = _port(seed).eval()
    assert _margin(_port_gates(model, x, False), 2) > MARGIN
    frozen = _freeze_any(model)
    from distributed_mnist_bnns_tpu.infer_moe import (
        _freeze_moe_tensors as jtensors,
    )

    want = _np_tree(jtensors(_jax_model(), _variables(seed)))
    for key in ("experts_wp", "head_wp", "w1"):
        np.testing.assert_array_equal(
            frozen[key].numpy().view(np.int32) if key != "w1"
            else frozen[key].numpy(),
            want[key].view(np.int32) if key != "w1" else want[key],
            err_msg=key)
    assert frozen["info"] == want["info"]
    fn = FrozenMoE(frozen, torch.device("cpu"))
    got = fn(x).numpy()
    jfn, _ = _jax_frozen(seed)
    np.testing.assert_allclose(got, np.asarray(jfn(jnp.asarray(x))),
                               atol=ATOL)
    live = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, live, atol=1e-4)


def test_artifact_interchanges_with_jax(tmp_path):
    """The port's export is the JAX export's bytes (stacked (E, KW_p, N_p)
    planes, int8 w1); each side serves the other's artifact."""
    x = _images(16, seed=21)
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jexport(_jax_model(), _variables(), jpath)
    info = export_packed(_port(), tpath)
    assert info["family"] == "bnn-moe-mlp"
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert f.read() == g.read()
    tfn, _ = load_packed(jpath, device="cpu")
    jfn, jinfo = jload(tpath, interpret=True)
    assert jinfo["compression"] == info["compression"]
    np.testing.assert_allclose(tfn(x).numpy(), np.asarray(jfn(x)),
                               atol=ATOL)
    assert load_frozen(tpath)["w1"].dtype == torch.int8


def test_served_batch_keeps_padded_rows_in_routing():
    """The classifier server pads each micro-batch to its batch size and
    the padded rows take capacity slots (the JAX server's semantics): a
    request's answer is the padded batch's first rows, not the forward
    of its rows alone."""
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    model = _port().eval()
    fn, _ = freeze_bnn_moe(model, device="cpu")
    x = _images(5, seed=30)
    padded = np.concatenate([x, np.zeros((11, 28, 28, 1), np.float32)])
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/moe.msgpack"
        export_packed(model, path)
        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device="cpu", port=0, batch_size=16,
            queue_depth=4, default_deadline_ms=60000.0,
            input_shape=(28, 28, 1)))
        host, port = srv.start()
        try:
            code, body = sc.predict(f"http://{host}:{port}", x.tolist())
        finally:
            srv.request_stop("test over")
            srv.drain_and_stop()
    assert code == 200
    got = np.asarray(json.loads(body)["log_probs"], np.float32)
    np.testing.assert_array_equal(got, fn(padded)[:5].numpy())
    assert fn.capacity(16) != fn.capacity(5)


def test_cli_train_export_infer(tmp_path, capsys):
    """``cli train|eval|export|infer --model bnn-moe-mlp`` on the CPU, the
    experts on K1's plain version (``--backend pallas_xnor``)."""
    ck = str(tmp_path / "ck")
    common = ["--model", "bnn-moe-mlp", "--synthetic-sizes", "64", "32",
              "--device", "cpu", "--data-dir", str(tmp_path / "none")]
    assert cli.main(["train", *common, "--epochs", "1", "--batch-size", "32",
                     "--backend", "pallas_xnor", "--checkpoint-dir",
                     ck]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["model"] == "bnn-moe-mlp" and np.isfinite(row["train_loss"])
    assert cli.main(["eval", *common, "--checkpoint-dir", ck]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = str(tmp_path / "m.msgpack")
    assert cli.main(["export", "--model", "bnn-moe-mlp", "--checkpoint-dir",
                     ck, "--out", out]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "family"] == "bnn-moe-mlp"
    assert cli.main(["infer", "--artifact", out, "--device", "cpu",
                     "--batch-size", "32", "--synthetic-sizes", "64", "32",
                     "--data-dir", str(tmp_path / "none")]) == 0
    inf = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert inf["family"] == "bnn-moe-mlp" and inf["n_examples"] == 32
    assert abs(inf["test_acc"] - ev["test_acc"]) <= 100.0 / 32


# -- two gloo ranks: global routing under DP, the experts sharded under TP ----


MP_CFG = dict(model="bnn-moe-mlp", model_kwargs=dict(SMALL), batch_size=BATCH,
              optimizer="sgd", learning_rate=LR, backend="xla")
QNN_CFG = dict(model="qnn-mlp-large", model_kwargs={"infl_ratio": 1,
                                                     "dropout_rate": 0.0},
               batch_size=BATCH, optimizer="sgd", learning_rate=LR,
               backend="xla")
CASES = {
    "dp": dict(MP_CFG, data_parallel=2),
    "dp_remat_accum": dict(MP_CFG, data_parallel=2, remat=True, grad_accum=2),
    "tp": dict(MP_CFG, tensor_parallel=2),
    "tp_smooth": dict(MP_CFG, tensor_parallel=2, label_smoothing=0.1),
    "qnn_tp": dict(QNN_CFG, tensor_parallel=2),
}
N_STEPS = 3


def _reference_cfg(cfg):
    return {k: v for k, v in cfg.items()
            if k not in ("data_parallel", "tensor_parallel")}


def _start_variables(cfg):
    """The state every step starts from: the drawn MoE weights, or a
    seeded QNN's (numpy)."""
    if cfg["model"] == "bnn-moe-mlp":
        return _variables()
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax

    t = mp_util._trainer(_reference_cfg(cfg))
    st = mp_util._np(train_state_to_jax(t))
    return {"params": st["params"], "batch_stats": st["batch_stats"]}


def _case_images(cfg, xs):
    """The QNN case's pixels on a 1/8 grid: the quantizer rounds, and a
    column shard of fc1's fp32 GEMM sums raw pixels in another order,
    which can carry a value across a rounding boundary of the next layer
    (a quantization level, ~1e-4 on the loss). On the grid every product
    before the head is a multiple of 2^-10 and every sum exact, so the
    comparison holds the sharding itself."""
    if cfg["model"] != "qnn-mlp-large":
        return xs
    return np.clip(np.round(xs * 8) / 8, -4, 4).astype(np.float32)


@pytest.fixture(scope="module")
def two_ranks():
    """Each case's one-step runs from the same start on 2 gloo ranks (one
    spawn for all of them), keyed (case, batch)."""
    xs, ys = _batches(N_STEPS, seed=40)
    jobs = [(f"{name}/{i}", "steps_run",
             (cfg, _start_variables(cfg), _case_images(cfg, xs)[i:i + 1],
              ys[i:i + 1]))
            for name, cfg in CASES.items() for i in range(N_STEPS)]
    ranks = spawn(mp_util.jobs_rank, 2, backend="gloo", device="cpu",
                  args=(jobs,), timeout_s=300.0)
    return ranks, xs, ys


@pytest.mark.parametrize("name", sorted(CASES))
def test_two_ranks_equal_one_process_step_by_step(name, two_ranks):
    """Every step from the same parameters on 2 ranks against one
    process: dp 2 routes the global batch (capacity from the global T,
    slots in global token order) and equals the single-process step on
    it, with remat and grad_accum too; tp 2 shards the experts (and the
    QNN's Megatron pairs) and equals the unsharded step, with label
    smoothing too."""
    ranks, xs, ys = two_ranks
    cfg = CASES[name]
    xs = _case_images(cfg, xs)
    for i in range(N_STEPS):
        start = _start_variables(cfg)
        if cfg["model"] == "bnn-moe-mlp":
            for half in np.split(xs[i], cfg.get("grad_accum", 1)):
                assert _margin(_port_gates(_port(), half), 2) > MARGIN
        ref = mp_util._trainer(_reference_cfg(cfg))
        mp_util.load_variables(ref, start)
        want_loss = mp_util._steps(ref, xs[i:i + 1], ys[i:i + 1])[0]
        want = mp_util._full_state(ref)
        got = ranks[0][f"{name}/{i}"]
        assert np.isclose(got["losses"][0], want_loss, rtol=1e-6,
                          atol=ATOL), (name, i)
        assert ranks[1][f"{name}/{i}"]["repl"] == got["repl"]
        for coll in ("params", "batch_stats"):
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    want[coll])[0]:
                g = got["state"][coll]
                for k in path:
                    g = g[k.key]
                np.testing.assert_allclose(
                    g, leaf, atol=ATOL, rtol=1e-5,
                    err_msg=f"{name} step {i} {coll} {path}")
    if "tp" in name:
        shapes = ranks[0][f"{name}/0"]["shapes"]
        if cfg["model"] == "bnn-moe-mlp":
            assert shapes["experts.w"] == (2, 32, 32)
        else:
            assert shapes["fc1.weight"] == (512, 784)
