"""Resume across a change of data-parallel world: the port's
``parallel/remesh.py`` and ``TrainConfig.elastic`` against the JAX
package's (``parallel/remesh.py``, ``tests/test_elastic.py``).

The fold rules run on the same numpy rows on both sides and agree
bitwise: the worker rows' groupwise mean (numpy's own mean, the same
code), the segment rows' position-preserving re-cut, for 8 -> 4,
8 -> 2, 4 -> 8 and with a width change. ``remesh_compress_state`` takes
the port's checkpointed optimizer state (flax's state-dict layout) and
gives JAX's result for ``SignCompressState`` and ``FsdpCompressState``
(Adam's segment moments inside), idempotent at the target world.

Trainer level, in gloo ranks on the CPU (``bnn-mlp-small`` at
``infl_ratio=1``, batch 32, 128 examples, Adam, ``sign_ef``, the flat
exchange and the compressed FSDP one): 4 ranks train an epoch and
checkpoint it; 2 ranks resume it with ``elastic=True``. Their rows just
after the restore equal JAX's ``remesh_compress_state`` of the saved
rows, and the epoch they then train is bitwise the epoch of 2 ranks
resumed, without ``elastic``, from a world-2 checkpoint that JAX's
re-placement wrote (JAX ``test_shrink_trajectory_bitwise_vs_fresh_
resume``). Without ``elastic`` the world-4 checkpoint raises
``CheckpointWorldMismatch``; the JAX Trainer's ``elastic=True``
validation errors are raised as JAX raises them.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import serialization
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.ops.comm_compress import make_plan as jplan
from distributed_mnist_bnns_tpu.parallel import remesh as jremesh
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu.train.optim import (
    FsdpCompressState,
    SignCompressState,
    sign_compress_fsdp,
)
from distributed_mnist_bnns_tpu_torch.ops.comm_compress import make_plan
from distributed_mnist_bnns_tpu_torch.parallel import (
    fold_worker_rows,
    mesh_topology,
    refold_segment_rows,
    remesh_compress_state,
    spawn,
)
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from distributed_mnist_bnns_tpu_torch.utils.checkpoint import (
    LATEST,
    read_meta,
    save_checkpoint,
)
from tests import torch_dp_util as util

N = 70 * 11 + 13
BUCKET = 32


def _rows(seed, shape, tail_from=None):
    rows = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    if tail_from is not None:    # the transforms' zero pad tail
        flat = rows.reshape(-1)
        flat[tail_from:] = 0.0
    return rows


FOLDS = [(8, 4, 5, 5), (8, 2, 5, 5), (4, 8, 5, 5), (8, 4, 5, 8),
         (8, 4, 8, 5)]


@pytest.mark.parametrize("old,new,width,new_width", FOLDS)
def test_fold_worker_rows_equals_jax(old, new, width, new_width):
    rows = _rows(old * width, (old, width))
    np.testing.assert_array_equal(
        fold_worker_rows(rows, new, new_width),
        jremesh.fold_worker_rows(rows, new, new_width))


@pytest.mark.parametrize("old,new,seg,new_seg", FOLDS)
def test_refold_segment_rows_equals_jax(old, new, seg, new_seg):
    rows = _rows(old * seg + 1, (old, seg))
    np.testing.assert_array_equal(
        refold_segment_rows(rows, new, new_seg),
        jremesh.refold_segment_rows(rows, new, new_seg))


def test_fold_rules_reject_what_jax_rejects():
    rows = _rows(0, (8, 5))
    for fn in (fold_worker_rows, jremesh.fold_worker_rows):
        with pytest.raises(ValueError, match="divide"):
            fn(rows, 3, 5)
    for fn in (refold_segment_rows, jremesh.refold_segment_rows,
               fold_worker_rows, jremesh.fold_worker_rows):
        with pytest.raises(ValueError, match="2-D"):
            fn(rows[0], 4, 5)


def _jax_state(kind, world, mode):
    """A JAX exchange state at ``world`` with random rows (pad tails
    zero), inside the chain's tuple as a Trainer's optimizer holds it."""
    params = {"w": jnp.zeros((70, 11)), "b": jnp.zeros((13,))}
    layout = "fsdp" if kind == "fsdp" else "dp"
    plan = jplan(N, world=world, mode=mode, bucket_size=BUCKET,
                 layout=layout)
    ef_w = plan.padded if mode == "sign_ef" else 0
    ef2_w = plan.seg if mode == "sign_ef" else 0
    ef = _rows(1, (world, ef_w))
    ef[:, N:] = 0.0
    ef2 = _rows(2, (world, ef2_w), tail_from=N)
    if kind == "dp":
        node = SignCompressState(ef_residual=ef, ef_residual2=ef2)
    else:
        st = sign_compress_fsdp(optax.adam(1e-3), mode=mode, world=world,
                                axis_name="data",
                                bucket_size=BUCKET).init(params)
        seeds = iter(range(10, 20))
        inner = jax.tree.map(
            lambda a: (_rows(next(seeds), a.shape, tail_from=N)
                       if np.ndim(a) == 2 else np.asarray(a)), st.inner)
        node = FsdpCompressState(ef_residual=ef, ef_residual2=ef2,
                                 inner=inner)
    return (optax.EmptyState(), node)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("new", [4, 2, 16])
@pytest.mark.parametrize("kind,mode", [("dp", "sign_ef"), ("fsdp", "sign_ef"),
                                       ("fsdp", "sign")])
def test_remesh_compress_state_equals_jax(kind, mode, new):
    """``remesh_compress_state`` on the state dict of a world-8 state:
    JAX's result, the same count of nodes re-placed, idempotent."""
    old = _jax_state(kind, 8, mode)
    layout = "fsdp" if kind == "fsdp" else "dp"
    want, n_want = jremesh.remesh_compress_state(
        old, jplan(N, world=new, mode=mode, bucket_size=BUCKET,
                   layout=layout))
    plan = make_plan(N, world=new, mode=mode, bucket_size=BUCKET,
                     layout=layout)
    got, n_got = remesh_compress_state(
        serialization.to_state_dict(old), plan)
    assert n_got == n_want == 1
    want_flat = _flat(serialization.to_state_dict(want))
    got_flat = _flat(got)
    assert got_flat.keys() == want_flat.keys()
    for k, v in want_flat.items():
        np.testing.assert_array_equal(got_flat[k], v, err_msg=k)
    again, n_again = remesh_compress_state(got, plan)
    assert n_again == 0 and _flat(again).keys() == got_flat.keys()


def test_remesh_rejects_rows_of_another_plan_as_jax():
    """Rows of another model (another gradient length) raise."""
    old = _jax_state("dp", 8, "sign_ef")
    plan_kw = dict(world=4, mode="sign_ef", bucket_size=BUCKET)
    with pytest.raises(ValueError, match="do not match"):
        jremesh.remesh_compress_state(old, jplan(N + 5000, **plan_kw))
    with pytest.raises(ValueError, match="do not match"):
        remesh_compress_state(serialization.to_state_dict(old),
                              make_plan(N + 5000, **plan_kw))


def test_mesh_topology_outside_a_group_is_jax_none():
    assert mesh_topology() == jremesh.mesh_topology(None) == (1, {})


# -- the trainer: world 4 -> world 2 ---------------------------------------------


SIZES = (128, 32)
BASE = dict(model_kwargs={"infl_ratio": 1, "dropout_rate": 0.0},
            batch_size=32, optimizer="adam", learning_rate=0.01,
            data_parallel="auto", compress_bucket_size=64,
            compress_chunks=2, grad_compress="sign_ef")
VARIANTS = {"dp": {}, "fsdp": dict(dp_mode="fsdp")}


def _as_jax_nodes(tree):
    """The exchange's nodes of a state dict as JAX's NamedTuples."""
    if not isinstance(tree, dict):
        return tree
    keys = set(tree)
    if keys == {"ef_residual", "ef_residual2"}:
        return SignCompressState(**tree)
    if keys == {"ef_residual", "ef_residual2", "inner"}:
        return FsdpCompressState(**tree)
    return {k: _as_jax_nodes(v) for k, v in tree.items()}


def _jax_world2_checkpoint(src, dst, variant):
    """``src``'s world-4 checkpoint re-placed by JAX's
    ``remesh_compress_state`` onto world 2 and written under ``dst`` as
    a world-2 checkpoint (the port's writer): the tree written."""
    with open(os.path.join(src, LATEST), "rb") as f:
        tree = msgpack.from_bytes(f.read())
    n = sum(np.asarray(v).size for v in _flat(tree["params"]).values())
    plan = jplan(n, world=2, mode="sign_ef", bucket_size=64, chunks=2,
                 layout="fsdp" if variant == "fsdp" else "dp")
    new, replaced = jremesh.remesh_compress_state(
        _as_jax_nodes(tree["opt_state"]), plan)
    assert replaced == 1
    tree = dict(tree, opt_state=serialization.to_state_dict(new))
    meta = read_meta(src)
    extra = {k: meta[k] for k in ("best_acc", "model") if k in meta}
    save_checkpoint(tree, dst, epoch=meta["epoch"],
                    extra_meta=dict(extra, world_size=2))
    return tree


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    write = [(v, "elastic_write_run", (dict(BASE, **kw), SIZES,
                                       str(root / f"w4-{v}")))
             for v, kw in VARIANTS.items()]
    spawn(util.jobs_rank, 4, backend="gloo", device="cpu", args=(write,))
    trees = {v: _jax_world2_checkpoint(str(root / f"w4-{v}"),
                                       str(root / f"w2-{v}"), v)
             for v in VARIANTS}
    jobs = []
    for v, kw in VARIANTS.items():
        cfg = dict(BASE, **kw)
        jobs += [
            (f"{v}/elastic", "elastic_resume_run", (
                dict(cfg, elastic=True), SIZES, str(root / f"w4-{v}"), 2)),
            (f"{v}/fresh", "elastic_resume_run", (
                cfg, SIZES, str(root / f"w2-{v}"), 2)),
            (f"{v}/strict", "elastic_resume_run", (
                cfg, SIZES, str(root / f"w4-{v}"), 2)),
        ]
    jobs.append(("topology", "topology_run", ()))
    per_rank = spawn(util.jobs_rank, 2, backend="gloo", device="cpu",
                     args=(jobs,))
    return {"trees": trees, "root": root,
            **{name: [r[name] for r in per_rank] for name, _, _ in jobs}}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_elastic_restore_rows_equal_jax_remesh(elastic, variant):
    """Just after the elastic restore at world 2, the optimizer state
    (error-feedback rows, and under FSDP the segment moments) is JAX's
    re-placement of the world-4 checkpoint's, on every rank."""
    want = _flat(elastic["trees"][variant]["opt_state"])
    for r in elastic[f"{variant}/elastic"]:
        got = {k[len("opt_state/"):]: v for k, v in r["restored"].items()
               if k.startswith("opt_state/")}
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_shrink_trajectory_bitwise_vs_fresh_resume(elastic, variant):
    """The epoch after the elastic restore is bitwise the epoch of a
    fresh world-2 run resumed from JAX's re-placement, on every rank."""
    for a, b in zip(elastic[f"{variant}/elastic"],
                    elastic[f"{variant}/fresh"]):
        assert a["steps"] == b["steps"] > 0
        assert a["losses"] == b["losses"]
        assert a["final"].keys() == b["final"].keys()
        for k, v in b["final"].items():
            assert np.array_equal(a["final"][k], v), k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_jax_loads_the_world4_checkpoint(elastic, variant):
    """The port's world-4 checkpoint (the exchange's rows, under FSDP its
    segment moments, in JAX's layout) restores in the JAX Trainer of the
    same configuration at ``data_parallel=4``, to the file's bytes."""
    from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt

    cfg = dict(BASE, **VARIANTS[variant])
    cfg.pop("device", None)
    jt = jtrainer.Trainer(jtrainer.TrainConfig(
        model="bnn-mlp-small", **{**cfg, "data_parallel": 4}))
    path = elastic["root"] / f"w4-{variant}"
    restored = jckpt.load_checkpoint(jt.state, str(path))
    assert serialization.to_bytes(restored) == (path / LATEST).read_bytes()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_world_mismatch_fails_fast_without_elastic(elastic, variant):
    for r in elastic[f"{variant}/strict"]:
        kind, msg = r["error"]
        assert kind == "CheckpointWorldMismatch"
        assert "world_size=4" in msg and "elastic" in msg


def test_mesh_topology_in_a_group_equals_jax(elastic):
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    for got in elastic["topology"]:
        assert tuple(got) == jremesh.mesh_topology(mesh)


@pytest.mark.parametrize("kw,phrase", [
    (dict(), "elastic=True requires checkpoint_dir"),
    (dict(device_data=True, checkpoint_dir="ck"),
     "elastic=True requires device_data=False"),
])
def test_elastic_validation_as_jax_raises(kw, phrase):
    with pytest.raises(ValueError, match=phrase):
        Trainer(TrainConfig(model="bnn-mlp-small", device="cpu",
                            elastic=True, **copy.deepcopy(kw)))
    with pytest.raises(ValueError, match=phrase):
        jtrainer.Trainer(jtrainer.TrainConfig(model="bnn-mlp-small",
                                              elastic=True, **kw))
