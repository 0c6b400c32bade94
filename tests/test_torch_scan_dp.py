"""The dispatch modes under data parallelism: ``scan_steps``,
``device_data``, ``grad_accum`` and ``remat`` in every data-parallel
step of the port (``train.capture.TrainScan`` over the DP steps of
``parallel/``), against the port's own per-step DP path and, for
``grad_accum``, against the JAX package's DP steps.

4 gloo ranks on the CPU (``parallel.spawn``; ``tests/torch_dp_util.py``),
``bnn-mlp-small`` at ``infl_ratio=1`` with dropout 0.3 (each rank's
generator in play), batch 16, 96 training examples (6 steps: with
``scan_steps=4`` one chunk of 4 and 2 one-step dispatches). On the CPU a
chunk runs eagerly (its plain version; on a card it is one CUDA graph
with the collectives inside). In each of the five modes (GSPMD, the
flat and two-level ``sign_ef`` exchange, fp32 FSDP, compressed FSDP):

* ``scan_steps=4`` is bitwise the per-step epoch: every tensor of the
  checkpointed state (parameters, statistics, optimizer state, error
  feedback), each rank's generator, the losses;
* ``remat`` is bitwise the plain step (the shard_map step too);
* ``device_data`` under GSPMD is bitwise the streaming epoch on each
  rank; under FSDP it warns and streams, as the JAX trainer does.

``grad_accum=2`` against the JAX Trainer's DP steps with
``grad_accum=2`` (dropout 0, the JAX initial weights, three steps of
``test_torch_data_parallel``'s batches), held to that file's bounds:
GSPMD and fp32 FSDP under SGD to atol 1e-5 (the microbatches are
slices of the global batch, as in the JAX GSPMD step), the flat
``sign_ef`` exchange under SGD with signs allowed to differ only in the
buckets of the dense biases. A capture on a gloo group raises and names
NCCL.
"""

import functools

import jax
import numpy as np
import pytest

from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from tests import test_torch_data_parallel as tdp
from tests import torch_dp_util as util

WORLD = 4
SIZES = (96, 32)
BASE = dict(model_kwargs={"infl_ratio": 1, "dropout_rate": 0.3},
            batch_size=16, optimizer="adam", learning_rate=0.01,
            data_parallel="auto", compress_bucket_size=64,
            compress_chunks=2, seed=3)
MODES = {
    "gspmd": {},
    "sign_ef": dict(grad_compress="sign_ef"),
    "hier": dict(grad_compress="sign_ef", dp_hosts=2),
    "fsdp": dict(dp_mode="fsdp"),
    "cfsdp": dict(dp_mode="fsdp", grad_compress="sign_ef"),
}
VARIANTS = {
    "step": {},
    "scan": dict(scan_steps=4),
    "remat": dict(remat=True),
}
ACCUM_RUNS = {
    # name: (port config, JAX config)
    "gspmd": (dict(optimizer="sgd"), dict(optimizer="sgd")),
    "fsdp": (dict(optimizer="sgd", dp_mode="fsdp"),
             dict(optimizer="sgd", dp_mode="fsdp")),
    "sign_ef": (dict(optimizer="sgd", grad_compress="sign_ef"),
                dict(optimizer="sgd", grad_compress="sign_ef")),
}


def _jobs():
    jobs = [(f"{m}/{v}", dict(BASE, **mkw, **vkw))
            for m, mkw in MODES.items() for v, vkw in VARIANTS.items()]
    for m in ("gspmd", "fsdp"):
        jobs.append((f"{m}/device", dict(BASE, **MODES[m],
                                         device_data=True)))
    return jobs


@functools.lru_cache(maxsize=None)
def _jax_accum(name):
    xs, ys = tdp._batches()
    t = jtrainer.Trainer(tdp._jax_cfg(data_parallel=WORLD, grad_accum=2,
                                      **ACCUM_RUNS[name][1]))
    state, key = t.state, jax.random.PRNGKey(0)
    init = tdp._variables(state)
    out = []
    for s in range(tdp.STEPS):
        state, m = t.train_step(state, xs[s], ys[s], key)
        out.append((float(m["loss"]), tdp._variables(state)))
    return init, out


@pytest.fixture(scope="module")
def port():
    xs, ys = tdp._batches()
    accum = [("trainer", tdp._port_cfg(grad_accum=2, **cfg),
              _jax_accum(name)[0]) for name, (cfg, _) in ACCUM_RUNS.items()]
    jobs = [("epochs", "epoch_states_run", (_jobs(), SIZES)),
            ("accum", "steps_rank", (accum, xs, ys)),
            ("shardmap_remat", "shardmap_remat_run",
             (dict(BASE, data_parallel=None), xs, ys)),
            ("guard", "capture_guard_run", ())]
    per_rank = spawn(util.jobs_rank, WORLD, backend="gloo", device="cpu",
                     args=(jobs,))
    return {name: [r[name] for r in per_rank] for name, _, _ in jobs}


def _assert_same(a, b, what, losses=None):
    """Bitwise the same state, generator and steps; the logged losses
    the same from ``losses`` on (None: none compared)."""
    assert a["steps"] == b["steps"], what
    if losses is not None:
        assert a["losses"][losses:] == b["losses"][losses:], what
    assert a["gen"] == b["gen"], what
    assert a["state"].keys() == b["state"].keys(), what
    for k, v in a["state"].items():
        assert np.array_equal(b["state"][k], v), (what, k)


@pytest.mark.parametrize("mode", list(MODES))
def test_scan_steps_is_bitwise_the_per_step_epoch(port, mode):
    """``scan_steps=4``: the same state, generators and losses as one
    step a dispatch, on every rank (the chunk logs its mean loss; the
    two one-step dispatches after it their own); the exchange's bytes
    the same."""
    for r in port["epochs"]:
        _assert_same(r[f"{mode}/step"], r[f"{mode}/scan"], mode, losses=-2)
        assert r[f"{mode}/scan"]["wire"] == r[f"{mode}/step"]["wire"]


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_is_bitwise_the_plain_dp_step(port, mode):
    for r in port["epochs"]:
        _assert_same(r[f"{mode}/step"], r[f"{mode}/remat"], mode, losses=0)


def test_remat_in_the_shardmap_step_is_bitwise(port):
    for r in port["shardmap_remat"]:
        plain, remat = r[False], r[True]
        assert plain["gen"] == remat["gen"]
        for a, b in zip(plain["runs"], remat["runs"]):
            assert a[:2] == b[:2]
            for k, v in a[2].items():
                assert np.array_equal(b[2][k], v), k


def test_device_data_under_gspmd_is_bitwise_the_streaming_epoch(port):
    """Each rank gathers its columns of the epoch's index matrix on the
    device: bitwise the streaming epoch of its rows."""
    for r in port["epochs"]:
        assert r["gspmd/device"]["on_device"]
        assert not r["gspmd/step"]["on_device"]
        _assert_same(r["gspmd/step"], r["gspmd/device"], "device_data")
        # one sync an epoch: the epoch's mean loss
        assert np.isclose(r["gspmd/device"]["losses"][0],
                          np.mean(r["gspmd/step"]["losses"]), rtol=1e-6)


def test_device_data_under_fsdp_streams(port):
    """FSDP over more than one rank keeps the streaming path (JAX
    ``test_device_data_fsdp_falls_back``): bitwise the FSDP epoch."""
    for r in port["epochs"]:
        assert not r["fsdp/device"]["on_device"] and r["fsdp/device"]["fsdp"]
        _assert_same(r["fsdp/step"], r["fsdp/device"], "fsdp device_data",
                     losses=0)


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_epochs_keep_ranks_equal_and_bytes_to_the_plan(port, mode):
    runs = port["epochs"]
    for v in VARIANTS:
        r0 = runs[0][f"{mode}/{v}"]
        for r in runs[1:]:
            for k, x in r0["state"].items():
                assert np.array_equal(r[f"{mode}/{v}"]["state"][k], x), k
        for r in runs:
            run = r[f"{mode}/{v}"]
            if mode != "hier":
                assert sum(run["wire"].values()) == run["steps"] * run["plan"]


@pytest.mark.parametrize("name", list(ACCUM_RUNS))
def test_grad_accum_dp_steps_match_jax(port, name):
    init, want = _jax_accum(name)
    ranks = [r[list(ACCUM_RUNS).index(name)] for r in port["accum"]]
    if name == "sign_ef":
        tdp._check_compressed(ranks, init, want, name)
    else:
        tdp._check_uncompressed(ranks[0], init, want, adam=False)
    for r in ranks[1:]:
        for s in range(tdp.STEPS):
            for k, v in ranks[0]["runs"][s][2].items():
                assert np.array_equal(r["runs"][s][2][k], v), k


def test_capture_on_a_gloo_group_raises_naming_nccl(port):
    for msg in port["guard"]:
        assert msg is not None and "NCCL" in msg and "'gloo'" in msg
