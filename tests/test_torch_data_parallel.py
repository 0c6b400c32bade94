"""The port's data-parallel training (``parallel/``, the data-parallel
``Trainer``, global-batch ``BatchNorm``) against the JAX package's.

``bnn-mlp-small`` at ``infl_ratio=1`` (784-64-64-64-10), dropout 0,
deterministic signs, backend xla, global batch 32; the JAX Trainer's
initial weights are carried into every rank with
``interop.params_from_jax``. The port runs in 2 or 4 gloo ranks on the
CPU (``parallel.spawn``, module-scoped: one spawn per world and kind runs
every case, ``tests/torch_dp_util.py``); the JAX side on as many of the
8 forced CPU devices.

Three steps, against the JAX steps of the same name:
  * ``make_dp_train_step`` (the JAX GSPMD step: global-batch BatchNorm)
    at world 2 and 4 under Adam, held as ``tests/test_torch_train.py``
    holds the single-device step: losses to rtol 1e-5; latents and
    statistics to atol 1e-5 (statistics also rtol 1e-5); the dense
    biases in front of a train-mode BatchNorm (an exact-zero gradient
    both frameworks compute as rounding noise, which Adam turns into
    moves up to lr) and the latents whose first gradient lies below 100
    Adam eps (at most 1% of a tensor) to the step bound 2 lr per step,
    and the running means with each side's bias contribution taken out.
  * ``make_shardmap_dp_train_step`` (per-rank BatchNorm over 16 rows)
    under SGD, everything to atol 1e-5. Under Adam, 98 of fc1's latents
    have first gradients below 100 eps on these inputs; the moves
    rounding decides for them by the second step changed the third
    step's loss by 1.4% (2.3333 against JAX's 2.3664), so the
    comparison runs where the update is linear in the gradient.
  * the compressed Trainer steps (``sign_ef`` and ``sign`` at world 2
    and 4, ``sign_ef`` two-level at 2 x 2) under SGD. Each gradient
    element enters the sign compression, and where it lies within
    rounding of 0 the two frameworks can give it either sign. The dense
    biases in front of a BatchNorm are such elements at every step: the
    test shows their first local gradient is at most 1e-5 of the mean
    |g| on every rank. Under SGD a step's move is -lr times the
    combined update, so its sign is the exchange's: the test allows a
    sign difference only in the buckets that hold a dense bias (3
    buckets of 64, aligned to the three bias vectors at these widths),
    none elsewhere at any step; holds those buckets to twice the sum of
    the steps' largest moves (a flip moves an element by 2 scale / world
    and, in the mean modes, its bucket's phase-2 scale); and the rest to
    atol 1e-5, the first step's loss to rtol 1e-5. Under Adam one flip
    would move a whole bucket by up to lr, and every later gradient
    with it.
Then: every rank bitwise equal; checkpoint -> ``restore`` -> 2 more
steps bitwise equal to 5 uninterrupted ones (error feedback in JAX's
``(world, padded)`` layout); the measured wire bytes of a fit equal to
``CommPlan`` / ``HierPlan`` per step; ``sign_ef`` within 2 points of the
uncompressed run (JAX ``test_compressed_dp_trains_within_2pct_of_
uncompressed``); a regime switch keeps the compression; and the
validation errors the JAX Trainer raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_mnist_bnns_tpu.parallel import (
    make_shardmap_dp_train_step as jshardmap_step,
)
from distributed_mnist_bnns_tpu.train import trainer as jtrainer
from distributed_mnist_bnns_tpu_torch.interop import params_from_jax
from distributed_mnist_bnns_tpu_torch.parallel import spawn
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from tests import torch_dp_util as util

ATOL = 1e-5
STAT_RTOL = 1e-5
ADAM_ILL = 100 * 1e-8
STEPS, BATCH, LR = 3, 32, 0.01
BUCKET, CHUNKS = 64, 2
BN_BIASES = ("fc1.bias", "fc2.bias", "fc3.bias")
MODEL_KW = {"infl_ratio": 1, "dropout_rate": 0.0}


def _np_tree(t):
    if hasattr(t, "items"):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.array(t)


def _batches(steps=STEPS, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (steps, BATCH, 28, 28, 1)) / 255.0 - 0.1307
    return ((x / 0.3081).astype(np.float32),
            rng.randint(0, 10, (steps, BATCH)).astype(np.int32))


def _jax_cfg(**kw):
    cfg = dict(model="bnn-mlp-small", model_kwargs=MODEL_KW, backend="xla",
               seed=0, batch_size=BATCH, learning_rate=LR,
               compress_bucket_size=BUCKET, compress_chunks=CHUNKS)
    cfg.update(kw)
    return jtrainer.TrainConfig(**cfg)


def _port_cfg(**kw):
    cfg = dict(model_kwargs=MODEL_KW, batch_size=BATCH, learning_rate=LR,
               data_parallel="auto", compress_bucket_size=BUCKET,
               compress_chunks=CHUNKS)
    cfg.update(kw)
    return cfg


def _variables(state):
    return _np_tree({"params": state.params,
                     "batch_stats": state.batch_stats})


# -- the JAX runs ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(kind, world, optimizer, grad_compress="none", dp_hosts=None):
    """(initial variables, per step (loss, variables after it))."""
    xs, ys = _batches()
    key = jax.random.PRNGKey(0)
    if kind == "shardmap":
        t = jtrainer.Trainer(_jax_cfg(optimizer=optimizer))
        step = jshardmap_step(
            t.clamp_mask, Mesh(np.array(jax.devices()[:world]), ("data",)))
    else:
        t = jtrainer.Trainer(_jax_cfg(
            optimizer=optimizer, data_parallel=world,
            grad_compress=grad_compress, dp_hosts=dp_hosts))
        step = t.train_step
    state = t.state
    init = _variables(state)
    out = []
    for s in range(STEPS):
        state, m = step(state, xs[s], ys[s], key)
        out.append((float(m["loss"]), _variables(state)))
    return init, out


# -- the port's runs ---------------------------------------------------------


STEP_RUNS = {
    # name: (kind, world, port config, JAX run)
    "gspmd-w2": ("trainer", 2, dict(optimizer="adam"),
                 ("gspmd", 2, "adam")),
    "gspmd-w4": ("trainer", 4, dict(optimizer="adam"),
                 ("gspmd", 4, "adam")),
    "shardmap-w2": ("shardmap", 2, dict(optimizer="sgd",
                                        data_parallel=None),
                    ("shardmap", 2, "sgd")),
    "sign_ef-w2": ("trainer", 2, dict(optimizer="sgd",
                                      grad_compress="sign_ef"),
                   ("gspmd", 2, "sgd", "sign_ef")),
    "sign-w2": ("trainer", 2, dict(optimizer="sgd", grad_compress="sign"),
                ("gspmd", 2, "sgd", "sign")),
    "sign_ef-w4": ("trainer", 4, dict(optimizer="sgd",
                                      grad_compress="sign_ef"),
                   ("gspmd", 4, "sgd", "sign_ef")),
    "sign-w4": ("trainer", 4, dict(optimizer="sgd", grad_compress="sign"),
                ("gspmd", 4, "sgd", "sign")),
    "hier-w4": ("trainer", 4, dict(optimizer="sgd", grad_compress="sign_ef",
                                   dp_hosts=2),
                ("gspmd", 4, "sgd", "sign_ef", 2)),
}


FIT_SIZES = (2048, 256)
FIT_JOBS = {
    # name: (world, port config, synthetic sizes)
    "fit-none": (2, dict(epochs=2, batch_size=64), FIT_SIZES),
    "fit-sign_ef": (2, dict(epochs=2, batch_size=64,
                            grad_compress="sign_ef"), FIT_SIZES),
    "fit-sign": (4, dict(epochs=2, batch_size=64, grad_compress="sign",
                         learning_rate=0.001), FIT_SIZES),
    "fit-regime": (2, dict(epochs=2, batch_size=64, grad_compress="sign_ef",
                           regime={0: {"optimizer": "adam",
                                       "learning_rate": 0.01},
                                   1: {"optimizer": "sgd",
                                       "learning_rate": 0.05}}),
                   (512, 128)),
    "fit-hier": (4, dict(epochs=1, batch_size=64, grad_compress="sign_ef",
                         dp_hosts=2), (512, 128)),
}
RESUME_JOBS = {
    "resume-sign_ef": (2, dict(optimizer="adam", grad_compress="sign_ef")),
    "resume-hier": (4, dict(optimizer="adam", grad_compress="sign_ef",
                            dp_hosts=2)),
}
RESUME_STEPS, RESUME_SPLIT = 5, 3
RAISES = [
    # (port config inside a 2-rank group, JAX config at data_parallel=2,
    #  exception, phrase of the message)
    (dict(batch_size=33), dict(batch_size=33), ValueError,
     "not divisible by data_parallel=2"),
    (dict(grad_compress="sign_ef", dp_hosts=3),
     dict(grad_compress="sign_ef", dp_hosts=3), ValueError, "must divide"),
    (dict(grad_compress="sign_ef", dp_hosts=1),
     dict(grad_compress="sign_ef", dp_hosts=1), ValueError,
     "no inter-host"),
    (dict(dp_hosts=2), dict(dp_hosts=2), ValueError,
     "requires grad_compress"),
    (dict(grad_compress="bogus"), dict(grad_compress="bogus"), ValueError,
     "unknown grad_compress"),
    (dict(dp_mode="zero"), dict(dp_mode="zero"), ValueError,
     "unknown dp_mode"),
    (dict(data_parallel=3), None, ValueError, "holds 2 ranks"),
    (dict(dp_mode="fsdp"), None, NotImplementedError, "queue 1 item 6"),
]


@pytest.fixture(scope="module")
def ckpt_root(tmp_path_factory):
    return tmp_path_factory.mktemp("dp_ckpt")


@functools.lru_cache(maxsize=None)
def _port_jobs(world, root):
    """Every port run of ``world`` ranks in one spawn: {job: per rank}."""
    xs, ys = _batches()
    names = [n for n, r in STEP_RUNS.items() if r[1] == world]
    step_jobs = [(STEP_RUNS[n][0], _port_cfg(**STEP_RUNS[n][2]),
                  _jax_run(*STEP_RUNS[n][3])[0]) for n in names]
    jobs = [("steps", "steps_rank", (step_jobs, xs, ys))]
    for name, (w, cfg, sizes) in FIT_JOBS.items():
        if w == world:
            jobs.append((name, "fit_run", (_port_cfg(
                model_kwargs={}, compress_bucket_size=1024,
                compress_chunks=4, **cfg), sizes)))
    rx, ry = _batches(RESUME_STEPS, seed=8)
    for name, (w, cfg) in RESUME_JOBS.items():
        if w == world:
            jobs.append((name, "resume_run", (
                _port_cfg(**cfg), f"{root}/{name}", rx, ry, RESUME_SPLIT)))
    if world == 2:
        jobs.append(("raises", "raises_run",
                     ([_port_cfg(**c) for c, *_ in RAISES],)))
    per_rank = spawn(util.jobs_rank, world, backend="gloo", device="cpu",
                     args=(jobs,))
    out = {name: [r[name] for r in per_rank] for name, _, _ in jobs}
    for i, name in enumerate(names):
        out[name] = [r[i] for r in out["steps"]]
    return out


@pytest.fixture(scope="module")
def port(ckpt_root):
    return lambda world: _port_jobs(world, str(ckpt_root))


def _as_state_dict(variables):
    sd = params_from_jax(variables).state_dict()
    return {k: v.numpy() for k, v in sd.items() if "num_batches" not in k}


def _bias_free_running_mean(history, init, name):
    """bn running mean with the dense bias's contribution taken out:
    each train step moves it by 0.1 * (batch mean of the GEMM + bias)."""
    bn = "bn" + name[2]
    rm = history[-1][f"{bn}.running_mean"].astype(np.float64)
    biases = [init[name]] + [h[name] for h in history[:-1]]
    for t, b in enumerate(biases):
        rm = rm - 0.1 * 0.9 ** (len(biases) - 1 - t) * b.astype(np.float64)
    return rm


def _tol(k):
    return dict(atol=ATOL, rtol=STAT_RTOL if "running" in k else 0.0)


def _check_uncompressed(got, want_init, want, adam):
    """The single-device step's bounds (tests/test_torch_train.py)."""
    w_sd = [_as_state_dict(v) for _, v in want]
    g_sd = [state for _, _, state in got["runs"]]
    init = _as_state_dict(want_init)
    first_grads = got["first_grads"]
    step_bound = 2 * LR * STEPS
    for s in range(STEPS):
        np.testing.assert_allclose(got["runs"][s][0], want[s][0], rtol=1e-5)
    for k, v in w_sd[-1].items():
        g = g_sd[-1][k]
        if not adam:
            np.testing.assert_allclose(g, v, **_tol(k), err_msg=k)
        elif k in BN_BIASES:
            assert np.abs(g - v).max() <= step_bound, k
        elif k.endswith("running_mean"):
            fc = "fc" + k[2] + ".bias"
            np.testing.assert_allclose(
                _bias_free_running_mean(g_sd, init, fc),
                _bias_free_running_mean(w_sd, init, fc), **_tol(k))
        elif k in first_grads:
            ill = np.abs(first_grads[k]) < ADAM_ILL
            assert ill.mean() <= 1e-2, (k, int(ill.sum()))
            assert (np.abs(g - v)[ill] <= step_bound).all(), k
            np.testing.assert_allclose(g[~ill], v[~ill], **_tol(k),
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, v, **_tol(k), err_msg=k)


DENSE_BIASES = ("BinarizedDense_0/bias", "BinarizedDense_1/bias",
                "BinarizedDense_2/bias")


def _bias_masks(order):
    """Per JAX flat element: is it a dense bias; does its bucket hold
    one."""
    padded = -(-order.n_params // BUCKET) * BUCKET
    bias = np.zeros(padded, bool)
    start = 0
    for path, p, _ in order.entries:
        bias[start:start + p.numel()] = path in DENSE_BIASES
        start += p.numel()
    bucket = np.repeat(bias.reshape(-1, BUCKET).any(-1), BUCKET)
    return bias[:order.n_params], bucket[:order.n_params]


def _check_compressed(got_ranks, want_init, want, name):
    """SGD under the sign compression: see the module docstring."""
    from distributed_mnist_bnns_tpu_torch.interop import JaxFlatOrder

    got = got_ranks[0]
    model = params_from_jax(want_init)
    order = JaxFlatOrder(model)
    named = dict(model.named_parameters())
    is_bias, near_bias = _bias_masks(order)

    def flat(sd):
        return order.flatten({named[k]: torch.from_numpy(np.asarray(v))
                              for k, v in sd.items() if k in named}).numpy()

    # The dense biases' gradient is rounding noise in every rank's first
    # local gradient: five orders below its mean magnitude.
    for r, rank in enumerate(got_ranks):
        g = np.abs(flat(rank["first_grads"]))
        assert g[is_bias].max() <= 1e-5 * g.mean(), (name, r)

    np.testing.assert_allclose(got["runs"][0][0], want[0][0], rtol=1e-5)
    states = [_as_state_dict(want_init)] + [st for _, _, st in got["runs"]]
    g_flats = [flat(st) for st in states]
    w_flats = [g_flats[0]] + [flat(_as_state_dict(v)) for _, v in want]
    # Under SGD a step's move is -lr times the combined update, so its
    # sign is the exchange's: no sign differs outside the buckets that
    # hold a dense bias, at any step.
    for s in range(STEPS):
        dg = g_flats[s + 1] - g_flats[s]
        dw = w_flats[s + 1] - w_flats[s]
        both = (dg != 0) & (dw != 0) & ~near_bias
        flips = np.flatnonzero(((dg > 0) != (dw > 0)) & both)
        assert flips.size == 0, (name, s, flips[:10])
    # a flipped element moves by at most twice a step's largest move
    bound = 2 * sum(np.abs(b - a).max() for a, b in zip(g_flats,
                                                          g_flats[1:]))
    diff = np.abs(g_flats[-1] - w_flats[-1])
    assert (diff[near_bias] <= bound).all(), (name, diff[near_bias].max(),
                                              bound)
    np.testing.assert_allclose(g_flats[-1][~near_bias],
                               w_flats[-1][~near_bias], atol=ATOL,
                               err_msg=name)
    # BatchNorm statistics: the running variances agree; the running
    # means take the dense biases in, held to their bound
    gs, ws = states[-1], _as_state_dict(want[-1][1])
    for k in gs:
        if "running_var" in k:
            np.testing.assert_allclose(gs[k], ws[k], **_tol(k), err_msg=k)
        elif "running_mean" in k:
            assert np.abs(gs[k] - ws[k]).max() <= bound, k


@pytest.mark.parametrize("name", ["gspmd-w2", "gspmd-w4", "shardmap-w2"])
def test_uncompressed_steps_match_jax(port, name):
    kind, world, cfg, jax_key = STEP_RUNS[name]
    init, want = _jax_run(*jax_key)
    _check_uncompressed(port(world)[name][0], init, want,
                        adam=cfg["optimizer"] == "adam")


@pytest.mark.parametrize("name", ["sign_ef-w2", "sign-w2", "sign_ef-w4",
                                  "sign-w4", "hier-w4"])
def test_compressed_trainer_steps_match_jax(port, name):
    kind, world, cfg, jax_key = STEP_RUNS[name]
    init, want = _jax_run(*jax_key)
    _check_compressed(port(world)[name], init, want, name)


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_every_rank_ends_bitwise_equal(port, name):
    world = STEP_RUNS[name][1]
    runs = port(world)[name]
    for r in range(1, world):
        for s in range(STEPS):
            assert runs[r]["runs"][s][:2] == runs[0]["runs"][s][:2]
            for k, v in runs[0]["runs"][s][2].items():
                assert np.array_equal(runs[r]["runs"][s][2][k], v), (r, k)


@pytest.mark.parametrize("name", list(FIT_JOBS))
def test_fit_ranks_bitwise_equal_and_wire_bytes_match_the_plan(port, name):
    """A fit on the synthetic split: every rank ends bitwise equal, and
    each rank's measured wire bytes per step equal the plan's (the fp32
    plan of the uncompressed run; the two levels when hierarchical)."""
    world = FIT_JOBS[name][0]
    runs = port(world)[name]
    r0 = runs[0]

    def metrics(history):
        return [{k: v for k, v in row.items() if "time" not in k}
                for row in history]

    for r in runs[1:]:
        assert metrics(r["history"]) == metrics(r0["history"])
        assert r["loss_history"] == r0["loss_history"]
        for k, v in r0["state"].items():
            assert np.array_equal(r["state"][k], v), k
    for r in runs:
        total = sum(r["wire"].values())
        assert total == r["steps"] * r["plan"] if r["hier"] is None else (
            total == r["steps"] * sum(r["hier"]))
        if r["hier"] is not None:
            intra = sum(n for k, n in r["wire"].items()
                        if k.startswith("intra/"))
            assert intra == r["steps"] * r["hier"][0]
            assert total - intra == r["steps"] * r["hier"][1]
    assert all(np.isfinite(r0["loss_history"]))


def test_compressed_dp_trains_within_2pct_of_uncompressed(port):
    """JAX ``test_compressed_dp_trains_within_2pct_of_uncompressed`` at
    world 2: sign_ef reaches within 2 accuracy points of the uncompressed
    run, its wire bytes at most 1/16 of fp32's."""
    base = port(2)["fit-none"][0]
    comp = port(2)["fit-sign_ef"][0]
    assert comp["history"][-1]["test_acc"] >= \
        base["history"][-1]["test_acc"] - 2.0
    assert comp["plan"] <= base["plan"] / 16
    assert comp["ef_rows"] == {"ef_residual": (2, comp["ef_rows"][
        "ef_residual"][1]), "ef_residual2": (2, comp["ef_rows"][
        "ef_residual2"][1])}


def test_sign_majority_mode_also_learns(port):
    """JAX ``test_sign_majority_mode_also_learns`` (lr 0.001) at world 4:
    a vote of 4 ties less often than one of 2 (a tie decodes as -1)."""
    r = port(4)["fit-sign"][0]
    assert r["history"][-1]["test_acc"] > r["before"]["test_acc"] + 10.0


def test_regime_optimizer_switch_keeps_compression(port):
    """An optimizer class switch rebuilds the optimizer with the
    exchange kept (fresh error feedback, two rows at world 2)."""
    r = port(2)["fit-regime"][0]
    assert r["optimizer"] == "SGD"
    assert set(r["ef_rows"]) == {"ef_residual", "ef_residual2"}
    assert r["ef_rows"]["ef_residual"][0] == 2


@pytest.mark.parametrize("name", list(RESUME_JOBS))
def test_checkpoint_restore_resumes_bitwise(port, name):
    """Three steps, a checkpoint (rank 0 writes; the error feedback of
    every rank in JAX's layout), a fresh trainer restored from it and
    two more steps: bitwise the five uninterrupted steps, optimizer
    moments and every rank's error feedback included."""
    world = RESUME_JOBS[name][0]
    for r in port(world)[name]:
        a, b = r["uninterrupted"], r["resumed"]
        assert a["step"] == b["step"] == RESUME_STEPS
        assert r["files"] == ["latest.pt"]
        for part in ("state", "ef", "moments"):
            assert a[part].keys() == b[part].keys() and a[part], part
            for k, v in a[part].items():
                assert np.array_equal(b[part][k], v), (part, k)
        rows = 2 if name == "resume-hier" else world
        assert a["ef"]["ef_residual"].shape[0] == rows
        assert np.abs(a["ef"]["ef_residual"]).sum() > 0


@pytest.mark.parametrize("i", range(len(RAISES)),
                         ids=[c[3] for c in RAISES])
def test_validation_errors_as_jax_raises(port, i):
    """Inside a 2-rank group each config raises what the JAX Trainer
    raises for it at data_parallel=2 (same type, same phrase)."""
    cfg, jax_cfg, exc, phrase = RAISES[i]
    got = port(2)["raises"][0][i]
    assert got is not None and got[0] == exc.__name__, got
    assert phrase in got[1], got
    if jax_cfg is not None:
        with pytest.raises(exc, match=phrase):
            jtrainer.Trainer(_jax_cfg(data_parallel=2, **jax_cfg))


def test_data_parallel_outside_a_process_group_raises():
    """A trainer asked for two ranks in a process of its own cannot
    train data-parallel: it says how to start the ranks."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        Trainer(TrainConfig(model="bnn-mlp-small", device="cpu",
                            data_parallel=2))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        Trainer(TrainConfig(model="bnn-mlp-small", device="cpu",
                            dp_mode="fsdp"))
    t = Trainer(TrainConfig(model="bnn-mlp-small", device="cpu",
                            data_parallel="auto", grad_compress="sign_ef"))
    assert t.world == 1 and t.comm_plan.world == 1
    assert t.comm_plan.wire_bytes_per_step == 0


def test_spawn_checks_the_backend_and_the_cards():
    from distributed_mnist_bnns_tpu_torch.parallel import check_world

    with pytest.raises(ValueError, match="unknown backend"):
        check_world(2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="runs on device 'cuda'"):
        check_world(1, backend="nccl", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            check_world(1, backend="gloo", device="cuda")


def test_spawn_without_a_device_runs_on_the_card(monkeypatch):
    """``spawn`` with no ``device`` means the card: without one it raises
    before it starts a process, over gloo as over nccl, and never falls
    back to the CPU."""
    import distributed_mnist_bnns_tpu_torch.parallel.distributed as pd

    def no_processes(*a, **k):
        raise AssertionError("spawn started processes")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pd.mp, "start_processes", no_processes)
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn(util.jobs_rank, 2, backend=backend)


def test_cli_train_dp_runs_gloo_ranks_on_the_cpu(capsys):
    """``cli train --dp 2 --device cpu --grad-compress sign_ef`` starts
    its two gloo ranks itself and prints rank 0's result, the measured
    wire bytes per step equal to the plan's."""
    import json

    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import make_plan
    from distributed_mnist_bnns_tpu_torch.train import Trainer as T

    assert cli.main(["--log-level", "WARNING", "train", "--model",
                     "bnn-mlp-small", "--infl-ratio", "1", "--epochs", "1",
                     "--synthetic-sizes", "256", "64", "--device", "cpu",
                     "--dp", "2", "--grad-compress", "sign_ef"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    n = sum(p.numel() for p in T(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
        device="cpu")).model.parameters())
    plan = make_plan(n, world=2, mode="sign_ef")
    assert row["data_parallel"] == 2 and row["steps"] == 256 // 64
    assert row["comm_bytes_per_step"] == plan.wire_bytes_per_step
    assert np.isfinite(row["train_loss"])


def test_cli_train_dp_auto_raises_without_a_card():
    from distributed_mnist_bnns_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "--dp", "auto", "--grad-compress", "sign_ef"])
