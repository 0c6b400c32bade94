"""The port's tensor parallelism (``parallel/model_parallel.py``,
``parallel/mesh.py``, ``Trainer(tensor_parallel=N)``, ``cli --tp``)
against the JAX package's.

The rule tables and ``tp_rules_by_path`` are held to JAX's on the flax
trees of the port's models (``interop.flax_params``): every table equal,
every spec equal, the strict-match errors. The port's tensor-parallel
trainer runs in 4 gloo ranks on the CPU (``parallel.spawn``, one
module-scoped spawn, ``tests/torch_mp_util.py``), the JAX Trainer on 4
of the 8 forced CPU devices, from the same initial variables:
  * data 2 x model 2 on ``bnn-mlp-small`` (SGD 0.05, batch 16, backend
    xla, dropout 0): three steps' losses within 1e-4 and parameters
    within 1e-3 of JAX's ``Trainer(tensor_parallel=2, data_parallel=2)``
    (the JAX TP test's tolerances; measured far inside), every rank's
    losses equal, the replicated leaves bitwise equal on every rank, the
    parameters really sharded, the wire bytes a step ``tp_wire_plan``'s;
  * on the +-1 backends (int8, xnor, pallas_xnor) at model 4 the forward
    up to the head bitwise the unsharded model's (the head's fp32 partial
    sums reassociate: its logits to 1e-5);
  * ``remat`` bitwise the plain step, ``grad_accum=2`` against JAX's;
  * a regime's optimizer switch keeps the sharding and the whole-leaf
    norms; a checkpoint resumes bitwise and the JAX ``load_checkpoint``
    reads it into an unsharded trainer's template;
  * ``cli train --tp`` and ``cli eval --tp``;
  * the JAX validation errors word for word.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from distributed_mnist_bnns_tpu.models import get_model as j_get_model
from distributed_mnist_bnns_tpu.parallel import model_parallel as jmp
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt
from distributed_mnist_bnns_tpu_torch.interop import flax_params
from distributed_mnist_bnns_tpu_torch.models import get_model
from distributed_mnist_bnns_tpu_torch.parallel import (
    P,
    bnn_mlp_tp_rules,
    spawn,
    tp_rules_by_path,
    tp_rules_for,
    tp_wire_plan,
)
from distributed_mnist_bnns_tpu_torch.parallel import model_parallel as pmp
from tests import torch_mp_util as util
from tests.torch_vit_util import assert_trees_close, np_tree

STEPS, BATCH, LR = 3, 16, 0.05
MODEL_KW = {"dropout_rate": 0.0}
TABLES = ("BNN_MLP_TP_TABLE", "QNN_MLP_TP_TABLE", "BNN_VIT_TP_TABLE",
          "BNN_MOE_TP_TABLE")


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _specs(tree):
    """{path: tuple(spec)} of a spec tree (JAX's or the port's)."""
    is_p = lambda s: isinstance(s, (jax.sharding.PartitionSpec, P))  # noqa
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_p)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _jax_params(name, **kw):
    shape = (1, 28, 28, 1) if "vit" in name else (1, 784)
    m = j_get_model(name, **kw)
    return jax.eval_shape(lambda: m.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(shape), train=True))["params"]


# -- the rule tables ---------------------------------------------------------


@pytest.mark.parametrize("table", TABLES)
def test_tables_equal_jax(table):
    assert getattr(pmp, table) == getattr(jmp, table)


@pytest.mark.parametrize("name", ["bnn-mlp-large", "bnn-mlp-small",
                                  "bnn-vit-tiny", "bnn-vit-small"])
def test_rules_for_match_jax(name):
    jp = _jax_params(name)
    tp = flax_params(get_model(name))
    assert _specs(tp_rules_for(name, tp)) == _specs(jmp.tp_rules_for(
        name, jp))


def test_mlp_table_matches_megatron_layout():
    by_path = dict(_flat(tp_rules_for("bnn-mlp-large", flax_params(
        get_model("bnn-mlp-large")))))
    assert by_path["BinarizedDense_0/kernel"] == P(None, "model")
    assert by_path["BinarizedDense_1/kernel"] == P("model", None)
    assert by_path["BinarizedDense_2/kernel"] == P(None, "model")
    assert by_path["Dense_0/kernel"] == P("model", None)
    assert by_path["BatchNorm_0/scale"] == P("model")
    assert by_path["BatchNorm_1/scale"] == P()
    assert by_path["BinarizedDense_1/bias"] == P(None)
    assert bnn_mlp_tp_rules(flax_params(get_model("bnn-mlp-large"))) == (
        tp_rules_for("bnn-mlp-large", flax_params(
            get_model("bnn-mlp-large"))))


@pytest.mark.parametrize("name,table", [("qnn-mlp-large", "QNN_MLP_TP_TABLE"),
                                        ("bnn-moe-mlp", "BNN_MOE_TP_TABLE")])
def test_unported_families_tables_on_jax_trees(name, table):
    """The qnn and moe tables over the JAX models' trees give JAX's specs,
    and ``tp_rules_for`` returns them (the families are ported: ROADMAP
    items 12 and 15)."""
    jp = np_tree(jax.tree_util.tree_map(np.zeros_like, _jax_params(name)))
    got = tp_rules_by_path(jp, getattr(pmp, table))
    want = _specs(jmp.tp_rules_for(name, _jax_params(name)))
    assert _specs(got) == want
    assert _specs(tp_rules_for(name, jp)) == want


def test_unknown_module_fails_loudly():
    params = {"BinarizedDense_0": {"kernel": np.zeros((4, 4))},
              "SurpriseLayer_0": {"kernel": np.zeros((4, 4))}}
    with pytest.raises(KeyError, match="SurpriseLayer_0"):
        tp_rules_by_path(params, {"BinarizedDense_0": "col"})
    specs = tp_rules_by_path(params, {"BinarizedDense_0": "col"},
                             strict=False)
    assert specs["SurpriseLayer_0"]["kernel"] == P()
    assert specs["BinarizedDense_0"]["kernel"] == P(None, "model")


def test_glob_star_does_not_cross_slash():
    params = {"TransformerBlock_0": {"RotaryAttention_0": {
        "BinarizedDense_0": {"kernel": np.zeros((4, 4))}}}}
    with pytest.raises(KeyError, match="RotaryAttention_0"):
        tp_rules_by_path(params,
                         {"TransformerBlock_*/BinarizedDense_0": "col"})
    with pytest.raises(KeyError) as e:
        jmp.tp_rules_by_path(params,
                             {"TransformerBlock_*/BinarizedDense_0": "col"})
    assert "RotaryAttention_0" in str(e.value)


def test_unknown_role_rejected():
    with pytest.raises(ValueError, match="role"):
        tp_rules_by_path({}, {"X": "diagonal"})


@pytest.mark.parametrize("name", ["fp32-mlp-large", "xnor-resnet18"])
def test_unknown_family_rejected_as_jax(name):
    with pytest.raises(ValueError) as e:
        tp_rules_for(name, {})
    with pytest.raises(ValueError) as j:
        jmp.tp_rules_for(name, {})
    assert str(e.value) == str(j.value)


# -- the trainer ---------------------------------------------------------------


def _batches(steps=STEPS, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (steps, BATCH, 28, 28, 1)) / 255.0 - 0.1307
    return ((x / 0.3081).astype(np.float32),
            rng.randint(0, 10, (steps, BATCH)).astype(np.int32))


def _cfg(**kw):
    cfg = dict(model="bnn-mlp-small", model_kwargs=MODEL_KW, backend="xla",
               optimizer="sgd", learning_rate=LR, batch_size=BATCH, seed=0)
    cfg.update(kw)
    return cfg


@functools.lru_cache(maxsize=None)
def _jax_run(grad_accum=1):
    """JAX ``Trainer(tensor_parallel=2, data_parallel=2)``: (initial
    variables, losses, final params)."""
    t = jtrainer.Trainer(jtrainer.TrainConfig(**_cfg(
        tensor_parallel=2, data_parallel=2, grad_accum=grad_accum)))
    state = t.state
    init = np_tree({"params": state.params,
                    "batch_stats": state.batch_stats})
    xs, ys = _batches()
    losses = []
    for x, y in zip(xs, ys):
        state, m = t.train_step(state, x, y, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return init, losses, np_tree(state.params)


RAISES = [
    # (port config in 4 ranks, JAX config or None, exception, phrase)
    (dict(tensor_parallel=2, dp_mode="fsdp"),
     dict(tensor_parallel=2, dp_mode="fsdp"), "ValueError",
     "composes with dp_mode='gspmd' only"),
    (dict(tensor_parallel=2, data_parallel=2, batch_size=33),
     dict(tensor_parallel=2, data_parallel=2, batch_size=33), "ValueError",
     "not divisible by data_parallel=2"),
    (dict(tensor_parallel=2, data_parallel=2, grad_compress="sign_ef"),
     dict(tensor_parallel=2, data_parallel=2, grad_compress="sign_ef"),
     "ValueError", "requires tensor_parallel=1"),
    (dict(tensor_parallel=2, data_parallel=2, elastic=True),
     dict(tensor_parallel=2, data_parallel=2, elastic=True), "ValueError",
     "elastic=True requires tensor_parallel=1"),
    (dict(tensor_parallel=4, model="fp32-mlp-large"),
     dict(tensor_parallel=4, model="fp32-mlp-large"), "ValueError",
     "no TP rule table"),
    (dict(tensor_parallel=4, model="bnn-vit-tiny",
          model_kwargs={"num_heads": 2}), None,
     "ValueError", "num_heads 2 not divisible by tensor_parallel=4"),
    (dict(tensor_parallel=2, data_parallel=2, grad_accum=3),
     dict(tensor_parallel=2, data_parallel=2, grad_accum=3), "ValueError",
     "not divisible by grad_accum=3"),
    (dict(tensor_parallel=3), None, "ValueError", "holds 4"),
]
FORWARD_BACKENDS = ("int8", "xnor", "pallas_xnor")
REGIME = {0: {"optimizer": "adam", "learning_rate": 0.003},
          1: {"optimizer": "sgd", "learning_rate": 0.05}}


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@functools.lru_cache(maxsize=None)
def _port(root):
    init, _, _ = _jax_run()
    xs, ys = _batches()
    x_eval = _batches(1, seed=3)[0][0]
    tp22 = _cfg(tensor_parallel=2, data_parallel=2)
    jobs = [("steps", "steps_run", (tp22, init, xs, ys)),
            ("remat", "steps_run", (dict(tp22, remat=True), init, xs, ys)),
            ("accum", "steps_run", (dict(tp22, grad_accum=2), init, xs,
                                    ys))]
    for b in FORWARD_BACKENDS:
        jobs.append((f"fwd-{b}", "tp_forward_run",
                     (_cfg(tensor_parallel=4, backend=b), init, x_eval)))
    jobs += [
        ("regime", "fit_run", (dict(tp22, epochs=2, regime=REGIME,
                                    batch_size=32), (256, 64))),
        ("resume", "resume_run", (dict(tp22, optimizer="adam",
                                       learning_rate=0.003),
                                  f"{root}/resume", xs, ys, 2)),
        ("raises", "raises_run", ([_cfg(**c) for c, *_ in RAISES],)),
    ]
    return spawn(util.jobs_rank, 4, backend="gloo", device="cpu",
                 args=(jobs,))


@pytest.fixture(scope="module")
def port(ckpt_root):
    return _port(ckpt_root)


def test_dp2_tp2_steps_match_jax(port):
    _, losses, params = _jax_run()
    got = port[0]["steps"]
    np.testing.assert_allclose(got["losses"], losses, atol=1e-4, rtol=0)
    assert_trees_close(got["state"]["params"], params, atol=1e-3,
                       rtol=1e-3)


def test_remat_is_bitwise_and_grad_accum_matches_jax(port):
    """``remat`` under TP takes the forward's all-reduced sums back in the
    recompute: bitwise the plain step; ``grad_accum=2`` (microbatches
    sliced from the global batch) against JAX's TP step with it."""
    plain, remat = port[0]["steps"], port[0]["remat"]
    assert remat["losses"] == plain["losses"]
    assert_trees_close(remat["state"], plain["state"], atol=0)
    assert remat["wire"] == plain["wire"]
    _, losses, params = _jax_run(grad_accum=2)
    got = port[0]["accum"]
    np.testing.assert_allclose(got["losses"], losses, atol=1e-4, rtol=0)
    assert_trees_close(got["state"]["params"], params, atol=1e-3,
                       rtol=1e-3)


def test_ranks_agree_and_replicated_leaves_are_bitwise_equal(port):
    runs = [r["steps"] for r in port]
    assert all(r["losses"] == runs[0]["losses"] for r in runs)
    assert len({r["repl"] for r in runs}) == 1


def test_state_is_really_sharded(port):
    w = 64 * 3   # bnn-mlp-small's width
    for r in port:
        shapes = r["steps"]["shapes"]
        assert shapes["fc1.weight"] == (w // 2, 784)
        assert shapes["fc2.weight"] == (w, w // 2)
        assert shapes["fc2.bias"] == (w,)
        assert shapes["bn1.weight"] == (w // 2,)
        assert shapes["bn2.weight"] == (w,)
        assert shapes["head.weight"] == (10, w // 2)
        assert r["steps"]["norm_shards"]


def test_wire_bytes_equal_the_plan(port):
    plan = tp_wire_plan(get_model("bnn-mlp-small"), tp=2, dp=2,
                        batch=BATCH)
    for r in port:
        wire = r["steps"]["wire"]
        got_model = sum(v for k, v in wire.items() if k.startswith("model/"))
        got_data = sum(v for k, v in wire.items() if k.startswith("inter/"))
        assert got_model == plan["model"] * STEPS
        assert got_data == plan["data"] * STEPS
        assert wire["model/fwd"] == plan["model_fwd"] * STEPS


@pytest.mark.parametrize("backend", FORWARD_BACKENDS)
def test_forward_up_to_the_head_is_bitwise_unsharded(port, backend):
    for r in port:
        got = r[f"fwd-{backend}"]
        assert got["equal"], got["err"]
        assert got["logits_err"] < 1e-5


def test_regime_switch_keeps_tp(port):
    for r in port:
        fit = r["regime"]
        assert len(fit["history"]) == 2
        assert np.isfinite(fit["history"][1]["train_loss"])
        assert fit["optimizer"] == "SGD" and fit["norm_shards"]
        assert fit["shapes"]["fc1.weight"][0] == 64 * 3 // 2


def test_checkpoint_resumes_and_jax_reads_it(port, ckpt_root):
    res = port[0]["resume"]
    assert_trees_close(res["resumed"], res["uninterrupted"], atol=0)
    template = jtrainer.Trainer(jtrainer.TrainConfig(**_cfg(
        optimizer="adam", learning_rate=0.003))).state
    restored = jckpt.load_checkpoint(template, f"{ckpt_root}/resume")
    assert_trees_close(np_tree(serialization.to_state_dict(restored)),
                       res["saved"], atol=0)


@pytest.mark.parametrize("i", range(len(RAISES)))
def test_validation_errors_as_jax_raises(port, i):
    _, jax_kw, kind, phrase = RAISES[i]
    got = port[0]["raises"][i]
    assert got is not None and got[0] == kind and phrase in got[1], got
    if jax_kw is None:
        return
    with pytest.raises(ValueError) as e:
        jtrainer.Trainer(jtrainer.TrainConfig(**_cfg(**jax_kw)))
    assert str(e.value) == got[1]


def test_tp_outside_a_process_group_raises():
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    with pytest.raises(ValueError, match="parallel.spawn"):
        Trainer(TrainConfig(device="cpu", **_cfg(tensor_parallel=2)))


def test_cli_train_and_eval_tp_on_the_cpu(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    common = ["--model", "bnn-mlp-small", "--infl-ratio", "1",
              "--backend", "xla", "--device", "cpu", "--batch-size", "32",
              "--data-dir", str(tmp_path / "none"),
              "--synthetic-sizes", "256", "64",
              "--checkpoint-dir", str(tmp_path / "ck")]
    assert main(["train", "--epochs", "1", "--tp", "2", *common]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["total_steps"] == 8 and row["comm_bytes_per_step"] > 0
    assert main(["eval", "--tp", "2", *common]) == 0
    tp_eval = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["eval", *common]) == 0
    plain = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tp_eval["test_acc"] == plain["test_acc"] == row["test_acc"]
    assert abs(tp_eval["test_loss"] - plain["test_loss"]) < 1e-6
