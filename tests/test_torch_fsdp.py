"""The port's FSDP (``parallel/fsdp.py``: ``fsdp_spec``,
``fsdp_memory_fraction``, ``FsdpShards``, ``make_fsdp_train_step``) and
the 1-bit compressed FSDP exchange (``train.optim.SignCompressFsdp``,
``make_compressed_fsdp_train_step``) against the JAX package's.

The layout: every leaf of ``bnn-mlp-small``, ``bnn-mlp-large`` and
``bnn-cnn`` is sharded on JAX's axis at 2, 4 and 8 ranks, and each
rank's shard is JAX's device's slice of the leaf; the memory fractions
are equal.

fp32 FSDP: three steps of the Trainer with ``dp_mode="fsdp"`` in 4 gloo
ranks against the JAX Trainer's GSPMD FSDP step at ``data=4`` (the
setting of ``tests/test_torch_data_parallel.py``: ``bnn-mlp-small`` at
``infl_ratio=1``, dropout 0, global batch 32, the JAX initial weights).
Under SGD, parameters and statistics to atol 1e-5 and the losses to
rtol 1e-5 (JAX's own bound for its FSDP step, ``tests/test_fsdp.py``):
the reduce-scatter sums in another order than GSPMD's. Global-norm
clipping (the norm over whole leaves, the shards' partial sums
all-reduced) under SGD the same; LAMB (trust ratios over whole leaves)
under ``test_torch_data_parallel``'s Adam bounds. Every rank ends
bitwise equal to the others.

Compressed FSDP: at world 1, three steps of the transform against JAX
``sign_compress_fsdp(world=1)`` wrapping SGD and Adam, ``sign_ef`` and
``sign``: each step's update with the same signs (the decoded planes)
and magnitudes to rtol 1e-6 (bucket scales: ``mean |x|`` sums in
another order in XLA); the error-feedback rows and the segment moments
in JAX's ``(world, seg)`` layout to rtol 1e-5. At world 4, the Trainer
against JAX's shard_map step under SGD, held as
``test_torch_data_parallel`` holds the compressed DP steps (a sign may
differ only in the buckets of the dense biases whose gradient is
rounding noise), with the checkpointed state in JAX's layout and shapes.
LARS and LAMB raise as JAX does. End to end, ``fit`` of both FSDP modes
at world 4: ranks bitwise equal, wire bytes a step equal to the plans,
each rank's shards the memory fraction of the parameters.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.models import get_model as jget_model
from distributed_mnist_bnns_tpu.parallel import fsdp as jfsdp
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu.train.optim import (
    make_optimizer as jmake_optimizer,
)
from distributed_mnist_bnns_tpu.train.optim import (
    sign_compress_fsdp as jsign_compress_fsdp,
)
from distributed_mnist_bnns_tpu_torch.interop import (
    JaxFlatOrder,
    from_flax_layout,
    params_from_jax,
    port_dim,
    to_flax_layout,
)
from distributed_mnist_bnns_tpu_torch.models import get_model
from distributed_mnist_bnns_tpu_torch.parallel import (
    fsdp_memory_fraction,
    fsdp_spec,
    spawn,
)
from distributed_mnist_bnns_tpu_torch.train import (
    SignCompressFsdp,
    TrainConfig,
    Trainer,
    make_optimizer,
)
from tests import test_torch_data_parallel as tdp
from tests import torch_dp_util as util
from tests.test_torch_comm_compress import _jax_template

WORLD = 4
MODELS = ("bnn-mlp-small", "bnn-mlp-large", "bnn-cnn")
RTOL_SCALE, RTOL_STATE = 1e-6, 1e-5
BUCKET, CHUNKS, LR = 64, 2, 0.01


# -- the layout --------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_shapes(name):
    """{flax path: shape} of the JAX model's params (shapes only)."""
    model = jget_model(name)
    keys = {k: jax.random.PRNGKey(i) for i, k in enumerate(
        ("params", "dropout", "binarize"))}
    v = jax.eval_shape(lambda: model.init(
        keys, jnp.zeros((2, 28, 28, 1)), train=False))
    flat = jax.tree_util.tree_flatten_with_path(v["params"])[0]
    return {"/".join(k.key for k in path): leaf.shape
            for path, leaf in flat}


@functools.lru_cache(maxsize=None)
def _port_shapes(name):
    """{flax path: (port parameter's flax-layout shape, kind)}."""
    with torch.device("meta"):
        model = get_model(name)
    order = JaxFlatOrder(model)
    kinds = order.kinds()
    return {path: (tuple(to_flax_layout(p, kinds[p]).shape), kinds[p],
                   tuple(p.shape))
            for path, p, _ in order.entries}


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", MODELS)
def test_fsdp_spec_picks_jax_axis_for_every_leaf(name, n):
    """Each leaf is sharded on the axis JAX's ``fsdp_spec`` picks (or
    replicated where it replicates), and the port tensor's dim
    (``port_dim``) holds, at each rank, JAX's device's slice."""
    jshapes, pshapes = _jax_shapes(name), _port_shapes(name)
    assert set(jshapes) == set(pshapes)
    rng = np.random.RandomState(0)
    for path, shape in jshapes.items():
        flax_shape, kind, port_shape = pshapes[path]
        assert flax_shape == tuple(shape), path
        spec = jfsdp.fsdp_spec(jnp.zeros(shape), n)
        want = None if spec == jax.sharding.PartitionSpec() else list(
            spec).index("data")
        axis = fsdp_spec(flax_shape, n)
        assert axis == want, (path, axis, spec)
        if axis is None or np.prod(shape) > 1 << 16:
            continue
        full = rng.randn(*shape).astype(np.float32)
        port = from_flax_layout(torch.from_numpy(full), kind).contiguous()
        dim = port_dim(kind, len(port_shape), axis)
        for r, part in enumerate(np.split(full, n, axis=axis)):
            k = port.shape[dim] // n
            mine = to_flax_layout(port.narrow(dim, r * k, k), kind)
            np.testing.assert_array_equal(mine.numpy(), part, err_msg=path)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", MODELS)
def test_fsdp_memory_fraction_equals_jax(name, n):
    with torch.device("meta"):
        model = get_model(name)
    params = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32),
        _jax_shapes(name), is_leaf=lambda x: isinstance(x, tuple))
    mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
    assert fsdp_memory_fraction(model, n) == jfsdp.fsdp_memory_fraction(
        params, mesh)


# -- fp32 FSDP and compressed FSDP steps at world 4 ---------------------------


STEP_RUNS = {
    # name: (port config, JAX config)
    "fsdp-sgd": (dict(optimizer="sgd", dp_mode="fsdp"),
                 dict(optimizer="sgd", dp_mode="fsdp")),
    "fsdp-clip": (dict(optimizer="sgd", dp_mode="fsdp", clip_grad_norm=0.05),
                  dict(optimizer="sgd", dp_mode="fsdp", clip_grad_norm=0.05)),
    "fsdp-lamb": (dict(optimizer="lamb", dp_mode="fsdp"),
                  dict(optimizer="lamb", dp_mode="fsdp")),
    "cfsdp-sign_ef": (dict(optimizer="sgd", dp_mode="fsdp",
                           grad_compress="sign_ef"),
                      dict(optimizer="sgd", dp_mode="fsdp",
                           grad_compress="sign_ef")),
    "cfsdp-sign": (dict(optimizer="sgd", dp_mode="fsdp",
                        grad_compress="sign"),
                   dict(optimizer="sgd", dp_mode="fsdp",
                        grad_compress="sign")),
}
FIT_JOBS = {
    "fit-fsdp": dict(dp_mode="fsdp", optimizer="adam"),
    "fit-cfsdp": dict(dp_mode="fsdp", optimizer="adam",
                      grad_compress="sign_ef"),
}
FIT_SIZES = (512, 128)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """(initial variables, per step (loss, variables after it), the final
    state as a flax state dict)."""
    xs, ys = tdp._batches()
    t = jtrainer.Trainer(tdp._jax_cfg(data_parallel=WORLD,
                                      **STEP_RUNS[name][1]))
    state, key = t.state, jax.random.PRNGKey(0)
    init = tdp._variables(state)
    out = []
    for s in range(tdp.STEPS):
        state, m = t.train_step(state, xs[s], ys[s], key)
        out.append((float(m["loss"]), tdp._variables(state)))
    return init, out, jax.tree.map(np.asarray,
                                   serialization.to_state_dict(state))


def _fit_rank(rank, world, device, sizes):
    """``fit`` of each FSDP mode: ``fit_run``'s result, plus this rank's
    shard elements and the memory fraction."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        fsdp_memory_fraction as frac,
    )

    out = {}
    for name, cfg in FIT_JOBS.items():
        r = util.fit_run(rank, world, device, dict(
            model_kwargs={"infl_ratio": 1}, epochs=1, batch_size=64,
            data_parallel="auto", **cfg), sizes)
        out[name] = r
    t = util._trainer(dict(model_kwargs={"infl_ratio": 1},
                           data_parallel="auto", dp_mode="fsdp"))
    out["shards"] = (sum(s.numel() for s in t.fsdp.tensors),
                     sum(p.numel() for p in t.model.parameters()),
                     frac(t.model, world))
    return out


@pytest.fixture(scope="module")
def port():
    xs, ys = tdp._batches()
    step_jobs = [("trainer", tdp._port_cfg(**cfg), _jax_run(name)[0])
                 for name, (cfg, _) in STEP_RUNS.items()]
    jobs = [("steps", "steps_rank", (step_jobs, xs, ys))]
    per_rank = spawn(util.jobs_rank, WORLD, backend="gloo", device="cpu",
                     args=(jobs,))
    out = {name: [r["steps"][i] for r in per_rank]
           for i, name in enumerate(STEP_RUNS)}
    out["fit"] = spawn(_fit_rank, WORLD, backend="gloo", device="cpu",
                       args=(FIT_SIZES,))
    return out


@pytest.mark.parametrize("name", ["fsdp-sgd", "fsdp-clip", "fsdp-lamb"])
def test_fp32_fsdp_steps_match_jax(port, name):
    init, want, _ = _jax_run(name)
    tdp._check_uncompressed(port[name][0], init, want,
                            adam=name == "fsdp-lamb")


@pytest.mark.parametrize("name", ["cfsdp-sign_ef", "cfsdp-sign"])
def test_compressed_fsdp_steps_match_jax(port, name):
    init, want, _ = _jax_run(name)
    tdp._check_compressed(port[name], init, want, name)


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_fsdp_state_has_jax_layout(port, name):
    """The checkpointed state (``interop.train_state_to_jax``: full
    leaves gathered from the shards; the exchange's ``(world, ...)``
    rows and segment moments) has the JAX state's paths and shapes."""
    _, _, jstate = _jax_run(name)

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(flat(v, f"{prefix}/{k}" if prefix else k))
            return out
        return {prefix: np.shape(tree)}

    got = {k: np.shape(v) for k, v in port[name][0]["jax_state"].items()}
    assert got == flat(jstate)


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_fsdp_ranks_end_bitwise_equal(port, name):
    runs = port[name]
    for r in runs[1:]:
        for s in range(tdp.STEPS):
            assert r["runs"][s][:2] == runs[0]["runs"][s][:2]
            for k, v in runs[0]["runs"][s][2].items():
                assert np.array_equal(r["runs"][s][2][k], v), k


@pytest.mark.parametrize("name", list(FIT_JOBS))
def test_trainer_fsdp_end_to_end(port, name):
    """The JAX ``test_trainer_fsdp_end_to_end`` at world 4: ``fit``
    trains and evaluates; every rank ends bitwise equal, and each rank's
    wire bytes a step equal the plan's."""
    ranks = [r[name] for r in port["fit"]]
    r0 = ranks[0]
    assert np.isfinite(r0["history"][-1]["train_loss"])
    assert r0["history"][-1]["test_acc"] >= 0.0
    for r in ranks:
        for k, v in r0["state"].items():
            assert np.array_equal(r["state"][k], v), k
        assert r["loss_history"] == r0["loss_history"]
        assert sum(r["wire"].values()) == r["steps"] * r["plan"]


def test_fsdp_shards_hold_the_memory_fraction(port):
    held, total, frac = port["fit"][0]["shards"]
    assert held == round(frac * total)
    assert frac < 0.3


# -- compressed FSDP at world 1: the transform against JAX ---------------------


def _grads(seed, steps=3):
    params = _jax_template()["params"]
    rng = np.random.RandomState(seed)
    return [jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params) for _ in range(steps)]


def _jax_fsdp_transform(opt, mode, grads):
    params = jax.tree.map(jnp.asarray, _jax_template()["params"])
    # the JAX Trainer's construction: float32 hyperparameters
    # (inject_hyperparams), sgd's momentum 0.0 kept as a trace
    tx = jmake_optimizer(opt, LR, grad_transform_wrapper=lambda inner:
                         jsign_compress_fsdp(inner, mode=mode, world=1,
                                             bucket_size=BUCKET,
                                             chunks=CHUNKS))
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
        out.append((np.asarray(ravel_pytree(upd)[0]), jax.tree.map(
            np.asarray, serialization.to_state_dict(state)["inner_state"])))
    return out


def _port_fsdp_transform(opt, mode, grads):
    model = params_from_jax(_jax_template())
    order = JaxFlatOrder(model)
    kinds = order.kinds()
    tx = SignCompressFsdp(mode=mode, order=order, world=1,
                          bucket_size=BUCKET, chunks=CHUNKS)
    o = make_optimizer(opt, model.parameters(), LR, fsdp_compress=tx)
    seen = []

    def recording(params, g, base):
        upd = tx(params, g, base)
        seen.append(order.flatten(dict(zip(params, upd))).numpy())
        return upd

    o.fsdp_compress = recording
    out = []
    for g in grads:
        for path, p, _ in order.entries:
            mod, leaf = path.split("/")
            p.grad = from_flax_layout(torch.from_numpy(g[mod][leaf]),
                                      kinds[p]).contiguous()
        o.step()
        seg = o.param_groups[0]["params"][0]
        out.append((seen[-1], {k: v.numpy().copy()
                               for k, v in o.state[seg].items()
                               if torch.is_tensor(v)},
                    {k: v.numpy().copy() for k, v in tx.state_dict().items()}))
    return out


@pytest.mark.parametrize("mode", ["sign_ef", "sign"])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_compressed_fsdp_world1_matches_jax(opt, mode):
    """Three steps of ``SignCompressFsdp(world=1)`` around SGD and Adam
    against JAX ``sign_compress_fsdp(world=1)``: the decoded updates'
    signs bitwise, their magnitudes (bucket scales) to rtol 1e-6, the
    residual rows and the segment's moments (row 0 of JAX's ``(1,
    seg)``) to rtol 1e-5."""
    grads = _grads(11)
    want = _jax_fsdp_transform(opt, mode, grads)
    got = _port_fsdp_transform(opt, mode, grads)
    for (w_upd, w_state), (g_upd, g_moments, g_rows) in zip(want, got):
        np.testing.assert_array_equal(np.sign(g_upd), np.sign(w_upd))
        np.testing.assert_allclose(np.abs(g_upd), np.abs(w_upd),
                                   rtol=RTOL_SCALE)
        if mode == "sign_ef":
            for k in ("ef_residual", "ef_residual2"):
                np.testing.assert_allclose(g_rows[k], w_state[k][0],
                                           rtol=RTOL_STATE, atol=1e-6)
        else:
            assert g_rows == {}
            assert w_state["ef_residual"].shape == (1, 0)
        inner = w_state["inner"]["0"]
        for k, v in g_moments.items():
            np.testing.assert_allclose(v, inner[k][0], rtol=RTOL_STATE,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("opt", ["lars", "lamb"])
def test_compressed_fsdp_rejects_layerwise_optimizers_as_jax(opt):
    kw = dict(model="bnn-mlp-small", optimizer=opt, dp_mode="fsdp",
              grad_compress="sign_ef")
    with pytest.raises(ValueError, match="does not compose with "
                       "grad_compress under dp_mode='fsdp'"):
        Trainer(TrainConfig(device="cpu", **kw))
    with pytest.raises(ValueError, match="does not compose with "
                       "grad_compress under dp_mode='fsdp'"):
        jtrainer.Trainer(jtrainer.TrainConfig(**kw))


def test_cli_train_and_eval_fsdp_with_dispatch_flags(capsys, tmp_path):
    """``cli train --dp 2 --dp-mode fsdp --scan-steps 2 --grad-accum 2
    --remat --device cpu`` starts two gloo ranks and trains (its bytes a
    step the fp32 FSDP plan's); ``cli eval --dp-mode fsdp`` restores the
    checkpoint of full leaves it wrote."""
    import json

    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import make_plan

    common = ["--model", "bnn-mlp-small", "--infl-ratio", "1",
              "--synthetic-sizes", "256", "64", "--device", "cpu",
              "--dp-mode", "fsdp", "--checkpoint-dir", str(tmp_path)]
    assert cli.main(["--log-level", "WARNING", "train", "--epochs", "1",
                     "--dp", "2", "--scan-steps", "2", "--grad-accum", "2",
                     "--remat", *common]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = sum(p.numel() for p in Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
        device="cpu")).model.parameters())
    plan = make_plan(n, world=2, mode="fp32", layout="fsdp")
    assert row["data_parallel"] == 2 and row["steps"] == 256 // 64
    assert row["comm_bytes_per_step"] == plan.wire_bytes_per_step
    assert np.isfinite(row["train_loss"])
    assert cli.main(["--log-level", "WARNING", "eval", *common]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["checkpoint_step"] == 256 // 64
    assert ev["test_acc"] == pytest.approx(row["test_acc"], abs=1e-9)
