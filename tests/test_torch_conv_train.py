"""The conv families' training in the port (``train.make_step_body``,
``Trainer``, ``parallel/``, ``cli train|export|infer``) against the JAX
package's.

Three steps of the port's ``make_step_body`` against the JAX
``make_train_step`` on the same batches and weights (carried across
with ``interop.params_from_jax``; ``tests/torch_conv_util.py``), for
each family (dropout 0) and for bnn-cnn on pallas_xnor (JAX: xla, the
exact oracle of the ±1 backends), under SGD at lr 0.01: losses to rtol
2e-5 and every parameter and running statistic to atol 1e-4 (the
largest gap measured, 5.7e-5, is bnn-cnn's first BatchNorm: see
``test_torch_conv_models.py`` on XLA's BatchNorm sums and the max-pool's
near-ties). Under Adam the exact-zero gradients of the biases in front
of a train-mode BatchNorm become moves of up to lr on both sides
(``tests/test_torch_train.py`` holds the optimizer to optax on the MLP).

Data parallel, 2 gloo ranks on the CPU against the JAX Trainer over 2
of the forced CPU devices, 3 steps of global batch 16: convnet
uncompressed (the GSPMD step, global-batch BatchNorm) held as above;
bnn-cnn under ``sign_ef``, where each gradient element's sign is
exchanged, so the rounding-level gradients (the biases in front of a
BatchNorm) may take either sign: the first loss to rtol 1e-5, the later
ones to rtol 1e-2. Both: every rank bitwise equal, and the wire bytes a
step equal to the JAX Trainer's ``CommPlan``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.models import latent_clamp_mask as jmask
from distributed_mnist_bnns_tpu.ops import losses as jl
from distributed_mnist_bnns_tpu.train import optim as jopt
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.interop import to_flax_layout
from distributed_mnist_bnns_tpu_torch.models import latent_clamp_mask
from distributed_mnist_bnns_tpu_torch.ops import losses as tl
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.train import (
    make_optimizer,
    make_step_body,
)
from tests import torch_conv_util as U
from tests import torch_dp_util as dp_util

STEPS, BATCH, LR = 3, 16, 0.01
ATOL = 1e-4
STEP_CASES = [(name, None) for name in U.FAMILIES] + [
    ("bnn-cnn", "pallas_xnor")]
BUCKET, CHUNKS = 1024, 2


def _batches(steps=STEPS, seed=50):
    return ([U.pixels(BATCH, seed + s) for s in range(steps)],
            [U.labels(BATCH, seed + s) for s in range(steps)])


def _check_params(model, jparams, jstats):
    """Every parameter of ``model`` against the flax trees at ATOL, the
    running statistics also to rtol 5e-4 (XLA's fp32 sums of the batch
    statistics: ``test_torch_conv_models.py``)."""
    for sub, flax_name, kind in model.flax_names():
        mod = model.get_submodule(sub)
        leaves = [("weight", jparams, "scale" if kind == "bn" else "kernel"),
                  ("bias", jparams, "bias")]
        if kind == "bn":
            leaves += [("running_mean", jstats, "mean"),
                       ("running_var", jstats, "var")]
        for port, tree, leaf in leaves:
            got = to_flax_layout(getattr(mod, port).detach(), kind).numpy()
            np.testing.assert_allclose(
                got, tree[flax_name][leaf],
                rtol=5e-4 if tree is jstats else 0, atol=ATOL,
                err_msg=f"{flax_name}/{leaf}")


@pytest.mark.parametrize("name,backend", STEP_CASES,
                         ids=[f"{n}-{b or 'default'}" for n, b in STEP_CASES])
def test_three_sgd_steps_match_jax_make_train_step(name, backend):
    kw = {} if backend is None else {"backend": backend}
    jm, v = U.jax_variables(name, 0, **({} if backend is None
                                        else {"backend": "xla"}))
    params = jax.tree.map(jnp.asarray, v["params"])
    tx = jopt.make_optimizer("sgd", LR)
    state = jtrainer.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, v.get("batch_stats", {})),
        opt_state=tx.init(params), apply_fn=jm.apply, tx=tx)
    jstep = jtrainer.make_train_step(jmask(params), loss_fn=jl.make_loss("ce"),
                                     donate=False)
    model = U.port_model(name, v, **kw)
    optimizer = make_optimizer("sgd", model.parameters(), LR)
    step = make_step_body(latent_clamp_mask(model),
                          loss_fn=tl.make_loss("ce"))
    xs, ys = _batches()
    for s in range(STEPS):
        state, m = jstep(state, jnp.asarray(xs[s]), jnp.asarray(ys[s]),
                         jax.random.PRNGKey(0))
        loss, acc = step(model, optimizer, torch.from_numpy(xs[s]),
                         torch.from_numpy(ys[s]).long())
        np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=2e-5)
        assert acc.item() == pytest.approx(float(m["accuracy"]))
    _check_params(model, U.np_tree(state.params),
                  U.np_tree(state.batch_stats))
    if name == "bnn-cnn":
        for p in latent_clamp_mask(model).values():
            assert float(p.detach().abs().max()) <= 1.0


# -- data parallel ---------------------------------------------------------

DP_RUNS = {
    # name: (model, grad_compress)
    "convnet-gspmd": ("convnet", "none"),
    "bnn-cnn-sign_ef": ("bnn-cnn", "sign_ef"),
}


def _model_kwargs(name):
    return {k: v for k, v in U.FAMILIES[name].items()
            if k not in ("infl_ratio",)}


def _jax_cfg(name, gc, **kw):
    return jtrainer.TrainConfig(
        model=name, model_kwargs=_model_kwargs(name), backend="xla",
        seed=0, batch_size=BATCH, learning_rate=LR, optimizer="sgd",
        compress_bucket_size=BUCKET, compress_chunks=CHUNKS,
        grad_compress=gc, **kw)


@functools.lru_cache(maxsize=None)
def _jax_dp(run):
    """(initial variables, per step (loss, params, stats), plan bytes)."""
    name, gc = DP_RUNS[run]
    t = jtrainer.Trainer(_jax_cfg(name, gc, data_parallel=2))
    state = t.state
    init = U.np_tree({"params": state.params,
                      "batch_stats": state.batch_stats})
    xs, ys = _batches()
    out = []
    for s in range(STEPS):
        state, m = t.train_step(state, xs[s], ys[s], jax.random.PRNGKey(0))
        out.append((float(m["loss"]), U.np_tree(state.params),
                    U.np_tree(state.batch_stats)))
    return init, out, t.comm_plan.wire_bytes_per_step


@pytest.fixture(scope="module")
def dp_port():
    """Both DP runs in one spawn of 2 gloo ranks: {run: per rank}."""
    xs, ys = _batches()
    jobs = []
    for run, (name, gc) in DP_RUNS.items():
        cfg = dict(model=name, model_kwargs=_model_kwargs(name),
                   batch_size=BATCH, learning_rate=LR, optimizer="sgd",
                   data_parallel="auto", grad_compress=gc,
                   compress_bucket_size=BUCKET, compress_chunks=CHUNKS)
        jobs.append(("trainer", cfg, _jax_dp(run)[0]))
    per_rank = spawn(dp_util.steps_rank, 2, backend="gloo", device="cpu",
                     args=(jobs, np.stack(xs), np.stack(ys)))
    return {run: [r[i] for r in per_rank] for i, run in enumerate(DP_RUNS)}


@pytest.mark.parametrize("run", list(DP_RUNS))
def test_dp_ranks_equal_bytes_equal_jax_plan(dp_port, run):
    ranks = dp_port[run]
    _, want, plan_bytes = _jax_dp(run)
    r0 = ranks[0]
    for r in ranks[1:]:
        assert [x[0] for x in r["runs"]] == [x[0] for x in r0["runs"]]
        for k, v in r0["runs"][-1][2].items():
            assert np.array_equal(r["runs"][-1][2][k], v), k
    for r in ranks:
        assert sum(r["wire"].values()) == STEPS * plan_bytes, r["wire"]
    name, gc = DP_RUNS[run]
    losses = [x[0] for x in r0["runs"]]
    np.testing.assert_allclose(losses[0], want[0][0], rtol=1e-5)
    if gc == "none":
        np.testing.assert_allclose(losses, [w[0] for w in want], rtol=2e-5)
        model = U.port_model(name, _jax_dp(run)[0])
        state = {k: torch.from_numpy(v) for k, v in r0["runs"][-1][2].items()}
        model.load_state_dict(state, strict=False)
        _check_params(model, want[-1][1], want[-1][2])
    else:
        np.testing.assert_allclose(losses, [w[0] for w in want], rtol=1e-2)


# -- the CLI -------------------------------------------------------------------


def _cli_json(argv, capsys):
    assert cli.main(["--log-level", "WARNING", *argv]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_export_infer_bnn_cnn(tmp_path, capsys):
    """``cli train --model bnn-cnn`` (full width, on the CPU, a short
    synthetic split, backend xla: the first conv in fp32, as the
    artifact's) with a checkpoint, ``eval`` of it, ``export
    --checkpoint-dir`` and ``infer`` of the artifact: the artifact's
    accuracy is the checkpoint's, up to one example at a threshold
    tie."""
    ck = str(tmp_path / "ck")
    common = ["--model", "bnn-cnn", "--synthetic-sizes", "128", "64",
              "--device", "cpu", "--backend", "xla"]
    row = _cli_json(["train", *common, "--epochs", "1", "--batch-size",
                     "32", "--checkpoint-dir", ck], capsys)
    assert row["total_steps"] == 4 and np.isfinite(row["train_loss"])
    ev = _cli_json(["eval", *common, "--checkpoint-dir", ck], capsys)
    assert ev["test_acc"] == row["test_acc"]
    out = str(tmp_path / "cnn.pt")
    info = _cli_json(["export", "--model", "bnn-cnn", "--checkpoint-dir",
                      ck, "--out", out], capsys)
    assert info["family"] == "bnn-cnn" and info["compression"] > 5
    inf = _cli_json(["infer", "--artifact", out, "--device", "cpu",
                     "--synthetic-sizes", "128", "64"], capsys)
    assert inf["family"] == "bnn-cnn" and inf["n_examples"] == 64
    # the frozen predictor may only differ at threshold ties
    assert abs(inf["test_acc"] - ev["test_acc"]) <= 100.0 / 64


@pytest.mark.parametrize("model,extra", [
    ("convnet", ["--precision", "bf16"]),
    ("deep-cnn", []),
    ("fp32-mlp-large", ["--infl-ratio", "1", "--precision", "bf16"]),
    ("convnet", ["--precision", "bf16", "--dp", "2"]),
])
def test_cli_train_each_family(model, extra, capsys):
    row = _cli_json(["train", "--model", model, "--epochs", "1",
                     "--batch-size", "32", "--synthetic-sizes", "64", "32",
                     "--device", "cpu", *extra], capsys)
    assert row["model"] == model and row["total_steps"] == 2
    assert np.isfinite(row["train_loss"])
    assert row["data_parallel"] == (2 if "--dp" in extra else 1)
