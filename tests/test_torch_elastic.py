"""Elastic data-parallel membership (``resilience/elastic.py``,
``cli train --elastic``) on gloo ranks on the CPU.

``run_elastic`` starts 2 ranks of the 1-bit exchange with error feedback
(``sign_ef``); chaos ``worker_lost@step=2,world=1`` stops both ranks in
lockstep at step 2 (a checkpoint), the supervisor respawns 1 rank, which
resumes it (the exchange's rows folded, ``parallel.remesh``);
``worker_restore@step=5`` regrows to 2 ranks. The final state is
bitwise the chain of fresh runs from the same checkpoint generations:
2 ranks preempted at step 2, 1 rank resumed and preempted at step 5, 2
ranks resumed to the end (the JAX test_shrink_trajectory_bitwise_vs_
fresh_resume, through both transitions). The supervisor's telemetry
holds a ``remesh`` event per transition and no ``restart``, and
``remesh_total`` counts a shrink and a grow. The trainer's refusals
(TP, PP, ``device_data``, no checkpoint directory) are JAX's, word for
word; a membership rule without ``elastic`` raises as JAX's does.
"""

import functools
import json
import os

import numpy as np
import pytest

from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch.obs import Telemetry
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.resilience import (
    RetryPolicy,
    reset_fire_counts,
    run_elastic,
)
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests import torch_elastic_util as util

SPEC = "worker_lost@step=2,world=1;worker_restore@step=5"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _state(ck):
    with open(os.path.join(ck, "checkpoint.msgpack"), "rb") as f:
        return dict(_leaves(msgpack.from_bytes(f.read())))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    reset_fire_counts()
    ck = str(root / "elastic")
    tel = Telemetry(str(root / "tel"), heartbeat=False)
    out = run_elastic(
        functools.partial(util.make_trainer,
                          {"checkpoint_dir": ck, "chaos": SPEC}),
        util.fit, world=2, backend="gloo", device="cpu",
        policy=RetryPolicy(max_restarts=0, max_preemptions=0),
        telemetry=tel)
    tel.close()
    ref = str(root / "ref")
    chain = [spawn(util.reference_rank, w, backend="gloo", device="cpu",
                   args=({"checkpoint_dir": ref, "chaos": chaos},))[0]
             for w, chaos in ((2, "preempt@step=2"), (1, "preempt@step=5"),
                              (2, None))]
    events = [json.loads(line)
              for line in open(root / "tel" / "events.jsonl")]
    return {"out": out, "ck": ck, "ref": ref, "chain": chain,
            "events": events, "tel": tel}


def test_shrink_and_regrow_bitwise_a_fresh_resume(runs):
    assert runs["out"] == {"step": 8, "world": 2}
    assert [(r["step"], r["preempted"]) for r in runs["chain"]] == [
        (2, True), (5, True), (8, False)]
    got, want = _state(runs["ck"]), _state(runs["ref"])
    assert got.keys() == want.keys()
    assert any("ef_residual" in k for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_remesh_events_and_counters(runs):
    ev = runs["events"]
    remesh = [e for e in ev if e["kind"] == "remesh"]
    assert [(e["direction"], e["world_from"], e["world_to"], e["step"])
            for e in remesh] == [("shrink", 2, 1, 2), ("grow", 1, 2, 5)]
    assert not [e for e in ev if e["kind"] == "restart"]
    reg = runs["tel"].registry
    assert reg.counter("remesh_total").value(direction="shrink") == 1
    assert reg.counter("remesh_total").value(direction="grow") == 1
    assert reg.gauge("world_size").value() == 2


REFUSALS = [dict(tensor_parallel=2), dict(pipeline_parallel=2),
            dict(device_data=True), dict(checkpoint_dir=None)]


@pytest.mark.parametrize("kw", REFUSALS)
def test_elastic_refusals_as_jax(kw, tmp_path):
    cfg = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
               batch_size=32, elastic=True, checkpoint_dir=str(tmp_path))
    cfg.update(kw)
    with pytest.raises(ValueError) as j:
        jtrainer.Trainer(jtrainer.TrainConfig(**cfg))
    with pytest.raises(ValueError) as e:
        Trainer(TrainConfig(device="cpu", **cfg))
    assert str(e.value) == str(j.value) and "elastic" in str(e.value)


def test_cli_train_elastic_shrinks_and_regrows(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    rc = main(["train", "--model", "bnn-mlp-small", "--infl-ratio", "1",
               "--backend", "xla", "--device", "cpu", "--batch-size", "32",
               "--epochs", "1", "--data-dir", str(tmp_path / "none"),
               "--synthetic-sizes", "256", "64", "--dp", "2",
               "--grad-compress", "sign_ef", "--elastic",
               "--checkpoint-dir", str(tmp_path / "ck"),
               "--telemetry-dir", str(tmp_path / "tel"), "--chaos", SPEC])
    assert rc == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["total_steps"] == 8 and row["data_parallel"] == 2
    kinds = [json.loads(line)["kind"]
             for line in open(tmp_path / "tel" / "events.jsonl")]
    assert kinds.count("remesh") == 2 and kinds.count("membership_change") == 2
