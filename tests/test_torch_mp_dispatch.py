"""Model parallelism finished: tensor parallelism of the ViT family (with
the row-parallel XNOR-Net alpha) and the chunked dispatches
(``scan_steps``, ``device_data``) under tensor and pipeline parallelism,
against the JAX package.

gloo ranks on the CPU (``parallel.spawn``, one module-scoped spawn a
world, the rank side in ``tests/torch_mp_util.py``); the JAX Trainer on
the forced CPU devices, from the same initial variables:

* ``bnn-vit-tiny`` at tp 2 (JAX ``test_tp_vit_trains``'s setting: batch
  16, the ``xla`` backend; SGD 0.05 and dropout 0 so the steps compare):
  three steps against JAX's ``Trainer(tensor_parallel=2)``, losses
  within 1e-4 and parameters within 1e-3 (the JAX TP test's
  tolerances), with ``scale=False`` and with ``scale=True`` (the
  XNOR-Net alpha of the row-parallel out projection and second MLP
  dense summed over the model group);
* ``bnn-mlp-small`` at tp 2, dropout 0 (JAX
  ``test_tp_scan_matches_per_step`` and
  ``test_tp_device_data_matches_streaming``): ``scan_steps=4`` and
  ``device_data`` bitwise the per-step fit (on the CPU a chunk runs
  eagerly, the plain version of the captured graph), and the per-step
  fit against JAX's scan fit within 1e-3;
* ``bnn-vit-tiny`` at data 2 x pipe 2 (JAX
  ``test_dp_pp_scan_matches_per_step``, its params redrawn from a numpy
  seed on both sides): ``scan_steps=2`` bitwise the per-step fit, which
  is held to JAX's scan fit within 1e-3;
* a regime's optimizer switch with TP ``device_data`` and with DP x PP
  (JAX ``test_regime_optimizer_switch_with_tp_device_data`` /
  ``..._with_dp_pp``): finite losses, the sharding kept.
"""

import functools
import json

import jax
import numpy as np
import pytest

from distributed_mnist_bnns_tpu.data.common import ImageClassData
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from tests import torch_mp_util as util
from tests.torch_vit_util import VIT as VIT_DIMS
from tests.torch_vit_util import assert_trees_close, np_tree, redraw

LOSS_ATOL, PARAM_TOL = 1e-4, 1e-3   # the JAX TP test's
MLP = dict(model="bnn-mlp-small",
           model_kwargs={"infl_ratio": 1, "dropout_rate": 0.0},
           batch_size=16, optimizer="sgd", learning_rate=0.05,
           backend="xla", seed=0)
VIT = dict(model="bnn-vit-tiny", model_kwargs=dict(VIT_DIMS, dropout=0.0),
           batch_size=16, optimizer="sgd", learning_rate=0.05,
           backend="xla", seed=0)
PP = dict(model="bnn-vit-tiny", model_kwargs=dict(VIT_DIMS),
          batch_size=8, optimizer="sgd",
          learning_rate=0.05, backend="xla", seed=0)
REGIME = {1: {"optimizer": "sgd", "learning_rate": 0.05}}


def _jdata(n):
    rng = np.random.RandomState(0)
    return ImageClassData(
        train_images=rng.rand(n, 28, 28, 1).astype(np.float32),
        train_labels=rng.randint(0, 10, n).astype(np.int32),
        test_images=rng.rand(16, 28, 28, 1).astype(np.float32),
        test_labels=rng.randint(0, 10, 16).astype(np.int32))


def _init(t, seed=None):
    """The JAX trainer's initial variables (numpy); with ``seed`` its
    params first redrawn from that numpy seed and placed back (a
    binarized transformer at its zero-bias init ties exactly, and the
    two sides break the ties apart)."""
    if seed is not None:
        new = redraw(t.state.params, seed)
        t.state = t.state.replace(params=jax.tree.map(
            lambda a, old: jax.device_put(a, old.sharding), new,
            t.state.params))
    s = t.state
    return np_tree({"params": s.params, "batch_stats": s.batch_stats})


@functools.lru_cache(maxsize=None)
def _jax_fit(key, n, **kw):
    cfg = dict({"mlp": MLP, "pp": PP}[key], **kw)
    t = jtrainer.Trainer(jtrainer.TrainConfig(epochs=1, **cfg))
    init = _init(t, seed=8 if key == "pp" else None)
    t.fit(_jdata(n))
    return init, np_tree(t.state.params)


def _batches(steps=3, seed=7, batch=16):
    rng = np.random.RandomState(seed)
    x = rng.rand(steps, batch, 28, 28, 1).astype(np.float32)
    return x, rng.randint(0, 10, (steps, batch)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_vit_steps(scale):
    mk = dict(VIT["model_kwargs"], scale=scale)
    t = jtrainer.Trainer(jtrainer.TrainConfig(
        **dict(VIT, model_kwargs=mk), tensor_parallel=2))
    init = _init(t, seed=8)
    state, losses = t.state, []
    for x, y in zip(*_batches()):
        state, m = t.train_step(state, x, y, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return init, losses, np_tree(state.params)


@pytest.fixture(scope="module")
def two():
    mlp_init, _ = _jax_fit("mlp", 64, tensor_parallel=2, scan_steps=4)
    xs, ys = _batches()
    jobs = []
    for scale in (False, True):
        init, _, _ = _jax_vit_steps(scale)
        cfg = dict(VIT, model_kwargs=dict(VIT["model_kwargs"], scale=scale),
                   tensor_parallel=2)
        jobs.append((f"vit-{scale}", "steps_run", (cfg, init, xs, ys)))
    tp = dict(MLP, tensor_parallel=2)
    for name, kw in (("step", {}), ("scan", {"scan_steps": 4}),
                     ("dd", {"device_data": True})):
        jobs.append((name, "dispatch_fit_run",
                     (dict(tp, **kw), mlp_init, 64)))
    jobs.append(("dd_regime", "dispatch_fit_run",
                 (dict(tp, optimizer="adam", learning_rate=0.003,
                       device_data=True, regime=REGIME), None, 64, 2)))
    return spawn(util.jobs_rank, 2, backend="gloo", device="cpu",
                 args=(jobs,))


@pytest.fixture(scope="module")
def four():
    pp_init, _ = _jax_fit("pp", 32, pipeline_parallel=2, data_parallel=2,
                          scan_steps=2)
    dp_pp = dict(PP, pipeline_parallel=2, data_parallel=2)
    jobs = [("step", "dispatch_fit_run", (dp_pp, pp_init, 32)),
            ("scan", "dispatch_fit_run",
             (dict(dp_pp, scan_steps=2), pp_init, 32)),
            ("regime", "dispatch_fit_run",
             (dict(dp_pp, optimizer="adam", learning_rate=0.003,
                   regime=REGIME), None, 32, 2))]
    return spawn(util.jobs_rank, 4, backend="gloo", device="cpu",
                 args=(jobs,))


@pytest.mark.parametrize("scale", [False, True])
def test_vit_tp_steps_match_jax(two, scale):
    _, losses, params = _jax_vit_steps(scale)
    got = two[0][f"vit-{scale}"]
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL,
                               rtol=0)
    assert_trees_close(got["state"]["params"], params, atol=PARAM_TOL,
                       rtol=PARAM_TOL)
    assert all(r[f"vit-{scale}"]["losses"] == got["losses"] for r in two)
    shapes = got["shapes"]
    assert shapes["blocks.0.attn.q.weight"] == (16, 32)
    assert shapes["blocks.0.attn.out.weight"] == (32, 16)
    assert shapes["blocks.0.mlp1.weight"] == (32, 32)
    assert shapes["patch_embed.weight"] == (32, 49)


def test_tp_scan_and_device_data_bitwise_per_step(two):
    step = two[0]["step"]
    for mode in ("scan", "dd"):
        got = two[0][mode]
        assert got["step"] == step["step"] == 4
        assert_trees_close(got["state"], step["state"], atol=0)
        assert got["shapes"] == step["shapes"]
    _, want = _jax_fit("mlp", 64, tensor_parallel=2, scan_steps=4)
    assert_trees_close(step["state"]["params"], want, atol=PARAM_TOL,
                       rtol=PARAM_TOL)


def test_dp_pp_scan_bitwise_per_step(four):
    step = four[0]["step"]
    got = four[0]["scan"]
    assert got["step"] == step["step"] == 4 and got["mp"] == "pp"
    assert_trees_close(got["state"], step["state"], atol=0)
    _, want = _jax_fit("pp", 32, pipeline_parallel=2, data_parallel=2,
                       scan_steps=2)
    assert_trees_close(step["state"]["params"], want, atol=PARAM_TOL,
                       rtol=PARAM_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_regime_switch_keeps_the_sharding(two, four, world):
    runs = two if world == 2 else four
    got = runs[0]["dd_regime" if world == 2 else "regime"]
    assert len(got["history"]) == 2 and got["optimizer"] == "SGD"
    assert all(np.isfinite(h["train_loss"]) for h in got["history"])
    assert got["mp"] == ("tp" if world == 2 else "pp")
    if world == 2:
        assert got["shapes"]["fc1.weight"][0] == 64 // 2


@pytest.mark.parametrize("model,extra", [
    ("bnn-vit-tiny", ["--tp", "2", "--scan-steps", "2"]),
    ("bnn-mlp-small", ["--infl-ratio", "1"]),
])
def test_cli_train_xnor_scale(tmp_path, capsys, caplog, model, extra):
    """``cli train --xnor-scale``: the ViT at tp 2 with the chunked
    dispatch runs with the alpha; a model without ``scale`` drops the
    knob with a warning, as the JAX trainer's ``_build_model`` does."""
    from distributed_mnist_bnns_tpu_torch.cli import main

    rc = main(["train", "--model", model, "--xnor-scale", "--epochs", "1",
               "--batch-size", "16", "--backend", "xla", "--device", "cpu",
               "--synthetic-sizes", "64", "32", "--log-interval", "1",
               "--data-dir", str(tmp_path / "none"), *extra])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["total_steps"] == 4 and np.isfinite(row["train_loss"])
    dropped = "does not take 'scale'" in caplog.text
    assert dropped == (model == "bnn-mlp-small")
