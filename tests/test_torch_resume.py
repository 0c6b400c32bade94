"""Resume and graceful stop of the port's trainer, as the JAX package's
``tests/test_resilience.py`` and ``tests/test_checkpoint.py`` hold its own.

``bnn-mlp-small`` at ``infl_ratio=1`` with its default dropout (0.3), so
the train-time generator's state matters; synthetic data of 128 rows,
batch 32: 4 steps an epoch, 2 epochs. A stop requested before a step
writes a mid-epoch checkpoint and raises ``Preempted``; ``resume``
continues at that step and the final state (params, batch stats,
optimizer state) is bitwise the uninterrupted run's; without the
generator state in the meta it is not. Also: a stop at an epoch
boundary, a stop at the last epoch's boundary (the run finishes),
rollback past a corrupt or truncated generation, a fresh start when
every generation is corrupt, and ``CheckpointTemplateMismatch`` for
another optimizer or model (``CheckpointWorldMismatch`` for other
shapes). ``cli train`` exits 75 on SIGTERM and ``--resume`` finishes the
run, bitwise. In 2 gloo ranks (``sign_ef``, one module-scoped spawn) a
stop requested on one rank mid-epoch stops both at the epoch boundary,
and the resume is bitwise; the JAX Trainer at data-parallel world 2
restores that run's checkpoint, error-feedback rows included.
"""

import os
import signal

import numpy as np
import pytest
from flax import serialization

from distributed_mnist_bnns_tpu.train import TrainConfig as JConfig
from distributed_mnist_bnns_tpu.train import Trainer as JTrainer
from distributed_mnist_bnns_tpu.utils import checkpoint as jckpt
from distributed_mnist_bnns_tpu_torch import cli
from distributed_mnist_bnns_tpu_torch.data import load_mnist
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.resilience import (
    PREEMPT_EXIT_CODE,
    Preempted,
)
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.utils import checkpoint as ck
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests import torch_dp_util as util

SIZES = (128, 32)


def _data():
    return load_mnist("/nonexistent", synthetic_sizes=SIZES)


def _config(tmp_path, **kw):
    kw = dict(dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
                   epochs=2, batch_size=32, backend="xla", seed=1,
                   device="cpu", checkpoint_dir=str(tmp_path / "ckpts")),
              **kw)
    return TrainConfig(**kw)


def _assert_same_state(a, b):
    sa, sb = util._full_state(a), util._full_state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.array_equal(sa[k], sb[k]), k


@pytest.fixture(scope="module")
def uninterrupted():
    t = Trainer(TrainConfig(model="bnn-mlp-small",
                            model_kwargs={"infl_ratio": 1}, epochs=2,
                            batch_size=32, backend="xla", seed=1,
                            device="cpu"))
    t.fit(_data())
    return t


def test_preempt_then_resume_matches_uninterrupted_run(uninterrupted,
                                                       tmp_path):
    """Stop requested once 5 steps are done: it lands before the 6th
    dispatch (epoch 1, batch 1), and the resumed run ends bitwise on the
    uninterrupted state."""
    data = _data()
    t1 = Trainer(_config(tmp_path))
    util.stop_after(t1, 5)
    with pytest.raises(Preempted) as e:
        t1.fit(data)
    assert (e.value.epoch, e.value.step) == (1, 5)
    assert e.value.exit_code == PREEMPT_EXIT_CODE == 75
    meta = ck.read_meta(str(tmp_path / "ckpts"))
    assert meta["epoch_in_progress"] == 1 and meta["batch_in_epoch"] == 1
    assert meta["preempted"] and meta["epoch"] == 0 and meta["step"] == 5
    assert meta["torch_rng_state"]["device"] == "cpu"
    assert "rng_key" not in meta
    t2 = Trainer(_config(tmp_path, resume=True))
    history = t2.fit(data)
    assert [h["epoch"] for h in history] == [1]
    assert history[0]["steps"] == 3
    assert t2.step == uninterrupted.step == 8
    _assert_same_state(t2, uninterrupted)


def test_resume_without_the_generator_state_draws_other_masks(
        uninterrupted, tmp_path):
    """The meta's generator state is what makes the resume bitwise: the
    same checkpoint with it removed (a JAX meta's ``rng_key`` instead)
    keeps the seed-derived generator and ends elsewhere."""
    data = _data()
    t1 = Trainer(_config(tmp_path))
    util.stop_after(t1, 5)
    with pytest.raises(Preempted):
        t1.fit(data)
    path = str(tmp_path / "ckpts")
    meta = ck.read_meta(path)
    del meta["torch_rng_state"]
    meta["rng_key"] = [0, 1]
    ck._write_meta(path, meta)
    t2 = Trainer(_config(tmp_path, resume=True))
    t2.fit(data)
    a = util._full_state(t2)
    b = util._full_state(uninterrupted)
    assert any(not np.array_equal(a[k], b[k]) for k in a)


def test_epoch_boundary_stop_never_marks_a_trained_epoch_in_progress(
        uninterrupted, tmp_path):
    data = _data()
    t1 = Trainer(_config(tmp_path))
    util.stop_after(t1, 4)          # during the last batch of epoch 0
    with pytest.raises(Preempted):
        t1.fit(data)
    meta = ck.read_meta(str(tmp_path / "ckpts"))
    assert meta["epoch"] == 0 and meta.get("epoch_in_progress") is None
    t2 = Trainer(_config(tmp_path, resume=True))
    assert [h["epoch"] for h in t2.fit(data)] == [1]
    _assert_same_state(t2, uninterrupted)


def test_boundary_stop_on_final_epoch_completes_instead_of_preempting(
        tmp_path):
    t = Trainer(_config(tmp_path, epochs=1))
    util.stop_after(t, 4)
    history = t.fit(_data())     # no Preempted
    assert [h["epoch"] for h in history] == [0]
    assert t.stop.requested


def test_resume_rolls_back_past_a_corrupt_generation(uninterrupted,
                                                     tmp_path, caplog):
    """The newest generation corrupted in place (the latest is a hardlink
    of it) or truncated: the resume restores the one before it and the
    run from there ends on the uninterrupted state."""
    data = _data()
    for damage in ("corrupt", "truncate"):
        cfg = dict(checkpoint_dir=str(tmp_path / damage))
        Trainer(_config(tmp_path, **cfg)).fit(data)
        latest = os.path.join(cfg["checkpoint_dir"], ck.LATEST)
        if damage == "corrupt":
            with open(latest, "r+b") as f:
                f.seek(100)
                f.write(b"\xff" * 64)
        else:
            os.truncate(latest, os.path.getsize(latest) // 2)
        caplog.clear()
        t = Trainer(_config(tmp_path, resume=True, **cfg))
        assert [h["epoch"] for h in t.fit(data)] == [1]
        assert "restored checkpoint_gen_0.msgpack" in caplog.text
        _assert_same_state(t, uninterrupted)


def test_resilient_load_raises_when_everything_is_corrupt(tmp_path):
    t = Trainer(_config(tmp_path))
    path = str(tmp_path / "allbad")
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax

    ck.save_checkpoint(train_state_to_jax(t), path, epoch=0)
    for name in os.listdir(path):
        if name.endswith(".msgpack"):
            os.truncate(os.path.join(path, name), 3)
    with pytest.raises(ck.CheckpointCorruptionError):
        ck.load_checkpoint_resilient(train_state_to_jax(t, values=False),
                                     path)


def test_trainer_resume_starts_fresh_when_unrecoverable(tmp_path, caplog):
    data = _data()
    Trainer(_config(tmp_path, epochs=1)).fit(data)
    path = str(tmp_path / "ckpts")
    for name in os.listdir(path):
        if name.endswith(".msgpack"):
            with open(os.path.join(path, name), "r+b") as f:
                f.write(b"\x00" * 32)
    t = Trainer(_config(tmp_path, resume=True))
    assert t.try_resume() == (0, 0)
    assert t.step == 0
    assert "every checkpoint generation" in caplog.text


def test_template_mismatch_raises_instead_of_rolling_back(tmp_path):
    """Intact bytes of another optimizer or model are not corruption:
    ``CheckpointTemplateMismatch``, in the resume and in ``restore``;
    leaves of other shapes ``CheckpointWorldMismatch``."""
    data = _data()
    Trainer(_config(tmp_path, epochs=1)).fit(data)
    path = str(tmp_path / "ckpts")
    sgd = Trainer(_config(tmp_path, optimizer="sgd", resume=True))
    with pytest.raises(ck.CheckpointTemplateMismatch):
        sgd.try_resume()
    with pytest.raises(ck.CheckpointTemplateMismatch):
        sgd.restore(path)
    conv = Trainer(_config(tmp_path, model="convnet", model_kwargs={},
                           resume=True))
    with pytest.raises(ck.CheckpointTemplateMismatch, match="holds a"):
        conv.try_resume()
    wide = Trainer(_config(tmp_path, model_kwargs={"infl_ratio": 2}))
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax

    template = train_state_to_jax(wide, values=False)
    with pytest.raises(ck.CheckpointWorldMismatch):
        ck.load_checkpoint_resilient(template, path)
    _, info = ck.load_checkpoint_resilient(template, path,
                                           on_shape_mismatch="return")
    assert info["shape_mismatches"] and info["digest_verified"]
    assert ck.read_meta(path)["generation"] == 0   # nothing pruned


def test_timing_csvs_and_results_log(tmp_path):
    t = Trainer(_config(tmp_path, timing_csv_prefix=str(tmp_path / "t"),
                        results_path=str(tmp_path / "results.csv")))
    history = t.fit(_data())
    batch = (tmp_path / "t_batch_time.csv").read_text().splitlines()
    epoch = (tmp_path / "t_epoch_time.csv").read_text().splitlines()
    assert batch[0] == "epoch,batch,seconds" and len(batch) == 1 + 8
    assert epoch[0] == "epoch,seconds" and len(epoch) == 1 + 2
    assert [float(r.split(",")[2]) > 0 for r in batch[1:]] == [True] * 8
    rows = t.results.load()
    assert [r["epoch"] for r in rows] == [0, 1]
    assert rows[1]["test_acc"] == pytest.approx(history[1]["test_acc"])
    assert (tmp_path / "results.html").exists()


def _cli_args(tmp_path, name, *extra):
    return ["train", "--model", "bnn-mlp-small", "--infl-ratio", "1",
            "--epochs", "2", "--batch-size", "32", "--synthetic-sizes",
            *map(str, SIZES), "--backend", "xla", "--seed", "1",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / name),
            *extra]


def test_cli_sigterm_exits_75_and_resume_finishes_bitwise(tmp_path,
                                                          monkeypatch):
    """SIGTERM to the process during the 3rd step: ``cli train`` writes a
    mid-epoch checkpoint and returns 75; ``--resume`` returns 0, and its
    final checkpoint is the uninterrupted run's, byte for byte."""
    assert cli.main(_cli_args(tmp_path, "whole")) == 0
    real = Trainer._make_train_step

    def signalling(self):
        step = real(self)

        def wrapped(*a):
            out = step(*a)
            if self.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    monkeypatch.setattr(Trainer, "_make_train_step", signalling)
    assert cli.main(_cli_args(tmp_path, "cut")) == PREEMPT_EXIT_CODE
    monkeypatch.setattr(Trainer, "_make_train_step", real)
    meta = ck.read_meta(str(tmp_path / "cut"))
    assert meta["batch_in_epoch"] == 3 and meta["epoch_in_progress"] == 0
    assert cli.main(_cli_args(tmp_path, "cut", "--resume")) == 0
    whole = (tmp_path / "whole" / ck.LATEST).read_bytes()
    assert (tmp_path / "cut" / ck.LATEST).read_bytes() == whole


# -- data parallel ------------------------------------------------------------

DP_CFG = dict(model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
              epochs=2, batch_size=32, data_parallel=2,
              grad_compress="sign_ef", compress_bucket_size=1024,
              compress_chunks=2, seed=1)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dp_resume"))
    return spawn(util.preempt_run, 2, backend="gloo", device="cpu",
                 args=(DP_CFG, SIZES, root, 1, 2))


def test_dp_sign_ef_stop_lands_at_the_epoch_boundary_and_resumes_bitwise(
        dp_runs):
    for r in dp_runs:
        assert r["stopped"] == {"epoch": 0, "step": 4}
        meta = r["meta_at_stop"]
        assert meta["epoch"] == 0 and meta["world_size"] == 2
        assert meta.get("epoch_in_progress") is None
        assert len(meta["torch_rng_state"]["ranks"]) == 2
        assert r["resumed_epochs"] == [1] and r["steps"] == (8, 8)
        a, b = r["uninterrupted"], r["resumed"]
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k
        ef = a["opt_state/inner_state/0/ef_residual"]
        assert ef.shape[0] == 2 and np.abs(ef).sum() > 0
    for k, v in dp_runs[0]["resumed"].items():
        assert np.array_equal(v, dp_runs[1]["resumed"][k]), k


def test_jax_trainer_restores_the_dp_checkpoint_with_its_ef_rows(dp_runs):
    jt = JTrainer(JConfig(model="bnn-mlp-small", model_kwargs={
        "infl_ratio": 1}, batch_size=32, backend="xla", data_parallel=2,
        grad_compress="sign_ef", compress_bucket_size=1024,
        compress_chunks=2, seed=1))
    path = dp_runs[0]["ckpt"]
    restored = jckpt.load_checkpoint(jt.state, path)
    with open(os.path.join(path, ck.LATEST), "rb") as f:
        data = f.read()
    assert serialization.to_bytes(restored) == data
    rows = msgpack.from_bytes(data)["opt_state"]["inner_state"]["0"]
    np.testing.assert_array_equal(
        np.asarray(restored.opt_state.inner_state[0].ef_residual),
        rows["ef_residual"])
    assert rows["ef_residual"].shape[0] == 2
