"""The port's pipelined transformer models (``parallel/pipeline_model.py``,
``Trainer(pipeline_parallel=N)``, ``lm_demo.run(pp=N)``, ``cli --pp``)
against the JAX package's.

Small ViTs and LMs (``tests/torch_vit_util.py``, ``torch_lm_util.py``:
every parameter redrawn from a numpy seed) run pipelined in 2 or 4 gloo
ranks on the CPU (``parallel.spawn``, one module-scoped spawn per world,
``tests/torch_mp_util.py``) and in the JAX package on its forced CPU
devices:
  * ``split_block_params`` / ``merge_block_params`` /
    ``pipeline_params`` give JAX's ``{"blocks", "rest"}`` layout bitwise;
    the stages' gathered tree too;
  * the ViT's and the LM's pipelined eval forward against JAX's
    ``make_pipelined_apply`` (atol 1e-5), a partial batch padded;
  * with dropout, the train forward bitwise its rng-matched oracle, and
    the missing-seed error;
  * the pipelined ViT ``Trainer`` (pp 2, and data 2 x pipe 2) three SGD
    steps against the JAX Trainer's sequential steps from the same state
    (losses rtol 1e-5; parameters atol 5e-5 and rtol 1e-5: the gradients
    sum over microbatches, measured 1.4e-5 on a LayerNorm scale that
    three steps moved by 4), and its checkpoint read by
    the JAX ``load_checkpoint`` into a ``pipeline_parallel=2`` trainer's
    template; resume bitwise the uninterrupted run;
  * ``remat`` bitwise the plain pipelined step, ``grad_accum=2`` against
    JAX's sequential steps with it;
  * ``lm_demo.run(pp=2)`` against ``lm_demo.run`` (losses rtol 1e-5;
    parameters atol 1e-5 but for the key bias, whose exact-zero gradient
    Adam turns into moves of up to lr: held to 2 lr a step), its errors,
    and ``cli train --pp`` / ``cli lm --pp``;
  * the JAX validation errors word for word.
"""

import functools
import json

import jax
import numpy as np
import pytest
from flax import serialization
from jax.sharding import Mesh as JMesh

from distributed_mnist_bnns_tpu.parallel import make_pipelined_apply as j_apply
from distributed_mnist_bnns_tpu.parallel import (
    merge_block_params as j_merge,
)
from distributed_mnist_bnns_tpu.parallel import pipeline_params as j_pp
from distributed_mnist_bnns_tpu.parallel import (
    split_block_params as j_split,
)
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt
from distributed_mnist_bnns_tpu_torch.examples import lm_demo
from distributed_mnist_bnns_tpu_torch.parallel import (
    merge_block_params,
    pipeline_params,
    sequential_params,
    spawn,
    split_block_params,
)
from tests import torch_mp_util as util
from tests.torch_lm_util import jax_lm, numpy_params
from tests.torch_vit_util import (
    VIT,
    assert_trees_close,
    images,
    jax_vit,
    np_tree,
    redraw,
    vit_params,
)

VIT4 = dict(VIT, depth=4)
FWD_CASES = {2: [("vit", 2, 8), ("vit", 4, 8), ("vit", 4, 5),
                 ("lm", 2, 4)],
             4: [("vit", 4, 8)]}
STEPS, BATCH, LR = 3, 8, 0.05
LM_KW = dict(steps=3, seq_len=16, batch=4, vocab=32, embed_dim=32, depth=2,
             num_heads=2, lr=1e-3, log_every=1, attention="xla")


def _jmodel(kind):
    if kind == "lm":
        return jax_lm(max_len=16)
    return jax_vit(**VIT4)


@functools.lru_cache(maxsize=None)
def _fwd_inputs(kind, n_micro, b):
    jm = _jmodel(kind)
    if kind == "lm":
        params = numpy_params(jm, seed=b)
        x = np.random.RandomState(b).randint(0, 32, (b, 16)).astype(np.int64)
        kw = {"num_heads": 2}
    else:
        params = vit_params(jm, seed=b)
        x = images(b, b)
        kw = {"num_heads": 2}
    return jm, params, x, kw


def _cfg(**kw):
    return dict(model="bnn-vit-tiny", model_kwargs=dict(VIT), backend="xla",
                optimizer="sgd", learning_rate=LR, batch_size=BATCH, seed=0,
                **kw)


@functools.lru_cache(maxsize=None)
def _jax_steps(grad_accum=1):
    """The JAX Trainer's sequential steps from redrawn params: (initial
    params, losses, final params)."""
    jt = jtrainer.Trainer(jtrainer.TrainConfig(**_cfg(
        grad_accum=grad_accum)))
    params = redraw(jt.state.params, seed=21)
    state = jt.state.replace(params=params)
    xs, ys = _batches()
    losses = []
    for x, y in zip(xs, ys):
        state, m = jt.train_step(state, x, y, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return params, losses, np_tree(state.params)


def _batches():
    rng = np.random.RandomState(22)
    return (rng.rand(STEPS, BATCH, 28, 28, 1).astype(np.float32),
            rng.randint(0, 10, (STEPS, BATCH)).astype(np.int32))


RAISES = [
    # (port config, JAX config or None, exception, phrase), world 2
    (dict(model="bnn-mlp-small", pipeline_parallel=2, model_kwargs={}),
     dict(model="bnn-mlp-small", pipeline_parallel=2, model_kwargs={}),
     "ValueError", "has no block stack"),
    (dict(pipeline_parallel=2, model_kwargs=dict(VIT, depth=3)),
     dict(pipeline_parallel=2, model_kwargs=dict(VIT, depth=3)),
     "ValueError", "not divisible by pipeline stages"),
    (dict(pipeline_parallel=2, grad_compress="sign"),
     dict(pipeline_parallel=2, grad_compress="sign"), "ValueError",
     "requires pipeline_parallel=1"),
    (dict(pipeline_parallel=2, elastic=True),
     dict(pipeline_parallel=2, elastic=True), "ValueError",
     "elastic=True requires"),
    (dict(pipeline_parallel=2, tensor_parallel=2),
     dict(pipeline_parallel=2, tensor_parallel=2), "ValueError",
     "does not compose with tensor_parallel"),
    (dict(pipeline_parallel=2, grad_accum=3),
     dict(pipeline_parallel=2, grad_accum=3), "ValueError",
     "not divisible by grad_accum=3"),
    (dict(pipeline_parallel=4), None, "ValueError", "needs 4 devices"),
]
RAISES4 = [
    (dict(pipeline_parallel=2, data_parallel=2, batch_size=6),
     dict(pipeline_parallel=2, data_parallel=2, batch_size=6), "ValueError",
     "not divisible by data_parallel=2 x microbatches=2"),
    (dict(pipeline_parallel=2, data_parallel=2, dp_mode="fsdp"),
     dict(pipeline_parallel=2, data_parallel=2, dp_mode="fsdp"),
     "ValueError", "composes with dp_mode='gspmd' only"),
]


@functools.lru_cache(maxsize=None)
def _port(world, root):
    cases = [(kind, _fwd_inputs(kind, m, b)[1], _fwd_inputs(kind, m, b)[2],
              m, _fwd_inputs(kind, m, b)[3])
             for kind, m, b in FWD_CASES[world]]
    params, _, _ = _jax_steps()
    xs, ys = _batches()
    variables = {"params": pipeline_params(params)}
    jobs = [("fwd", "pipelined_forward_run", (cases,)),
            ("steps", "steps_run", (_port_cfg(world), variables, xs, ys))]
    if world == 2:
        jobs += [("remat", "steps_run", (dict(_port_cfg(2), remat=True),
                                         variables, xs, ys)),
                 ("accum", "steps_run", (dict(_port_cfg(2), grad_accum=2),
                                         variables, xs, ys))]
    if world == 2:
        vp = vit_params(jax_vit(**VIT4), seed=30)
        jobs += [
            ("dropout", "pipelined_dropout_run", (vp, images(31, 8), 2, 7)),
            ("resume", "resume_run", (_port_cfg(2), f"{root}/resume", xs, ys,
                                      1)),
            ("raises", "raises_run", ([_port_kw(c) for c, *_ in RAISES],)),
            ("lm", "lm_pp_run", (dict(LM_KW, mlp_ratio=2, scale=False,
                                      seed=0, corpus=None),)),
        ]
    else:
        jobs.append(("raises", "raises_run",
                     ([_port_kw(c) for c, *_ in RAISES4],)))
    return spawn(util.jobs_rank, world, backend="gloo", device="cpu",
                 args=(jobs,))


def _port_kw(kw):
    return {**_cfg(), **kw, "model_kwargs": kw.get("model_kwargs",
                                                   _cfg()["model_kwargs"])}


def _port_cfg(world):
    kw = _cfg(pipeline_parallel=2)
    if world == 4:
        kw["data_parallel"] = 2
    return kw


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pp_ckpt"))


@pytest.fixture(scope="module")
def port(ckpt_root):
    return lambda world: _port(world, ckpt_root)


def test_split_and_merge_are_jax_layout():
    params = vit_params(jax_vit(**VIT4), seed=1)
    stacked, rest, names = split_block_params(params)
    j_stacked, j_rest, j_names = j_split(params)
    assert names == j_names
    assert_trees_close(stacked, np_tree(j_stacked), atol=0)
    assert_trees_close(rest, np_tree(j_rest), atol=0)
    assert_trees_close(merge_block_params(stacked, rest, names), params,
                       atol=0)
    assert_trees_close(np_tree(j_merge(j_stacked, j_rest, j_names)),
                       merge_block_params(stacked, rest, names), atol=0)
    assert_trees_close(sequential_params(pipeline_params(params), 4), params,
                       atol=0)
    assert_trees_close(pipeline_params(params), np_tree(j_pp(params)),
                       atol=0)


def test_split_without_blocks_raises():
    with pytest.raises(ValueError, match="no TransformerBlock"):
        split_block_params({"Dense_0": {}})


@pytest.mark.parametrize("world,i", [(2, 0), (2, 1), (2, 2), (2, 3),
                                     (4, 0)])
def test_pipelined_forward_matches_jax(port, world, i):
    kind, m, b = FWD_CASES[world][i]
    jm, params, x, _ = _fwd_inputs(kind, m, b)
    mesh = JMesh(np.array(jax.devices()[:world]), ("pipe",))
    want = j_apply(jm, mesh, jm.depth, n_micro=m)({"params": j_pp(params)},
                                                  x)
    for rank in port(world):
        got = rank["fwd"][i]
        np.testing.assert_allclose(got["y"], np.asarray(want), atol=1e-5,
                                   rtol=0)
        assert_trees_close(got["tree"], np_tree(j_pp(params)), atol=0)


def test_train_forward_matches_the_rng_oracle(port):
    for rank in port(2):
        got = rank["dropout"]
        np.testing.assert_array_equal(got["y"], got["want"])
        assert "needs the step's seed" in got["missing"]


@pytest.mark.parametrize("world", [2, 4])
def test_pipelined_trainer_steps_match_jax(port, world):
    _, losses, params = _jax_steps()
    got = port(world)[0]["steps"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert set(got["state"]["params"]) == {"blocks", "rest"}
    assert_trees_close(sequential_params(got["state"]["params"], 2), params,
                       atol=5e-5, rtol=1e-5)
    for rank in port(world):
        assert rank["steps"]["losses"] == got["losses"]
        # this stage's blocks only: one block of the two a rank
        shapes = rank["steps"]["shapes"]
        assert sum(k.startswith("stage.blocks.") for k in shapes) == sum(
            k.startswith("stage.blocks.0.") for k in shapes) > 0


def test_pp_remat_is_bitwise_and_grad_accum_matches_jax(port):
    """``remat`` under PP checkpoints each stage (the pipeline's sends and
    receives run once): bitwise the plain step; ``grad_accum=2`` against
    the JAX Trainer's sequential steps with it."""
    plain, remat = port(2)[0]["steps"], port(2)[0]["remat"]
    assert remat["losses"] == plain["losses"]
    assert_trees_close(remat["state"], plain["state"], atol=0)
    _, losses, params = _jax_steps(grad_accum=2)
    got = port(2)[0]["accum"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert_trees_close(sequential_params(got["state"]["params"], 2), params,
                       atol=5e-5, rtol=1e-5)


def test_pp_checkpoint_is_read_by_jax_and_resumes(port, ckpt_root):
    res = port(2)[0]["resume"]
    assert "checkpoint.msgpack" in res["files"]
    assert_trees_close(res["resumed"], res["uninterrupted"], atol=0)
    template = jtrainer.Trainer(jtrainer.TrainConfig(
        **_cfg(pipeline_parallel=2))).state
    restored = jckpt.load_checkpoint(template, f"{ckpt_root}/resume")
    tree = np_tree(serialization.to_state_dict(restored))
    assert_trees_close(tree, res["saved"], atol=0)
    assert int(tree["step"]) == 1


@pytest.mark.parametrize("world,i", [(2, i) for i in range(len(RAISES))]
                         + [(4, i) for i in range(len(RAISES4))])
def test_validation_errors_as_jax_raises(port, world, i):
    cases = RAISES if world == 2 else RAISES4
    _, jax_kw, kind, phrase = cases[i]
    got = port(world)[0]["raises"][i]
    assert got is not None and got[0] == kind and phrase in got[1], got
    if jax_kw is None:
        return
    with pytest.raises(ValueError) as e:
        jtrainer.Trainer(jtrainer.TrainConfig(**{**_cfg(), **jax_kw}))
    assert str(e.value) == got[1]


def test_lm_demo_pp_matches_the_sequential_run(port):
    seq = lm_demo.run(device="cpu", **LM_KW)
    got = port(2)[0]["lm"]
    np.testing.assert_allclose(got["history"], seq.history, rtol=1e-5)
    want = {}
    for name, p in seq.model.state_dict().items():
        want[name] = p.numpy()
    from distributed_mnist_bnns_tpu_torch.interop import lm_params_from_jax

    model = lm_params_from_jax(got["params"], num_heads=2, attention="xla")
    for name, p in model.state_dict().items():
        atol = (2 * LM_KW["lr"] * LM_KW["steps"]
                if name.endswith("attn.k.bias") else 1e-5)
        np.testing.assert_allclose(p.numpy(), want[name], atol=atol,
                                   err_msg=name)


def test_lm_demo_pp_errors():
    with pytest.raises(ValueError, match="--export requires the plain"):
        lm_demo.run(steps=1, pp=2, export="x.msgpack", device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm_demo.run(steps=1, pp=2, ring=True, device="cpu")


def test_cli_train_and_lm_pp_on_the_cpu(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    rc = main(["train", "--model", "bnn-vit-tiny", "--epochs", "1",
               "--batch-size", "16", "--backend", "xla", "--pp", "2",
               "--device", "cpu", "--data-dir", str(tmp_path / "none"),
               "--synthetic-sizes", "64", "32"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(row["train_loss"]) and row["total_steps"] == 4
    rc = main(["lm", "--steps", "2", "--pp", "2", "--device", "cpu",
               "--vocab", "32", "--embed-dim", "32", "--depth", "2",
               "--num-heads", "2", "--seq-len", "16", "--batch-size", "4"])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(row["loss_history"]) == 2
