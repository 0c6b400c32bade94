"""The port's device accounting against the JAX package's: analytic and
counted MACs (``dense_macs_per_example`` on bnn-mlp-large,
``module_macs_per_example`` against the JAX jaxpr walk on convnet and
bnn-cnn), the peak table's backend rule, MFU, the cost ledger's counted
train-step FLOPs reconciled with the analytic walk within the JAX
test's factor, the memory census, and a ``torch.profiler`` capture read
back by ``summarize_capture`` (on the CPU, and a synthetic trace of the
card's kernels for the attribution to ``jg_step`` regions). CPU only."""

import gzip
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import distributed_mnist_bnns_tpu.obs as jobs
from distributed_mnist_bnns_tpu.models import get_model as jget_model

import distributed_mnist_bnns_tpu_torch.obs as pobs
from distributed_mnist_bnns_tpu_torch.models import get_model
from distributed_mnist_bnns_tpu_torch.obs import profile as pprofile

H100 = "NVIDIA H100 80GB HBM3"


def _jax_params(name, **kw):
    model = jget_model(name, **kw)
    v = model.init({"params": jax.random.PRNGKey(0),
                    "dropout": jax.random.PRNGKey(1)},
                   jnp.zeros((2, 28, 28, 1)), train=False)
    return model, v


def test_dense_macs_of_bnn_mlp_large_equal_jax():
    _, v = _jax_params("bnn-mlp-large")
    port = get_model("bnn-mlp-large")
    want = jobs.dense_macs_per_example(v["params"])
    assert pobs.dense_macs_per_example(port) == want
    assert want == 784 * 3072 + 3072 * 1536 + 1536 * 768 + 768 * 10
    # the analytic step: 3 x 2 x MACs x batch, the same method name
    p = pobs.train_step_flops("bnn-mlp-large", port, 64)
    j = jobs.train_step_flops("bnn-mlp-large", v["params"], 64)
    assert p == j == (6.0 * want * 64, "analytic_3x_dense_gemms")


@pytest.mark.parametrize("name", ["convnet", "bnn-cnn"])
def test_module_macs_equal_the_jaxpr_walk(name):
    model, v = _jax_params(name)
    want = jobs.jaxpr_macs_per_example(model.apply, v, (28, 28, 1))
    port = get_model(name)
    assert pobs.module_macs_per_example(port, (28, 28, 1)) == want > 0
    p = pobs.train_step_flops(name, port, 32, input_shape=(28, 28, 1))
    assert p == (6.0 * want * 32,
                 "analytic_3x_conv_and_dense_from_flop_counter")
    assert port.training   # counted on a copy: the model is untouched


def test_peak_table_keeps_the_jax_backend_rule():
    for backend in ("bf16", "xla", "xnor", "pallas_xnor", "int8"):
        peak, prec = pobs.chip_peak(H100, backend)
        _, jprec = jobs.chip_peak("TPU v5 lite", backend)
        assert prec == jprec
        assert peak == (2 * 989.4e12 if backend == "int8" else 989.4e12)
    assert pobs.chip_peak("TPU v5 lite") == (None, "unknown")
    assert pobs.device_peak_flops(torch.device("cpu")) == \
        (jobs.flops.NOMINAL_HOST_PEAK, "nominal")
    assert pobs.peak_for_default_device() == (1e11, "nominal")
    for args in ((3.2e9, 1.5e-3, 989.4e12), (1e9, 0.0, 1.0),
                 (None, 1.0, 1.0), (2e12, 0.5, 1e12, 4)):
        assert pobs.mfu(*args) == jobs.mfu(*args)


def test_memory_census_on_the_cpu():
    assert pobs.device_memory_stats() is None
    keep = torch.ones(1 << 16)
    mem = pobs.device_memory_stats(live_fallback=True)
    assert mem["0"]["source"] == "live_arrays"
    assert mem["0"]["bytes_in_use"] >= keep.numel() * 4


@pytest.mark.parametrize("backend", ["xla", "bf16"])
def test_counted_train_step_flops_reconcile_with_the_analytic_walk(backend):
    """The JAX invariant (tests/test_device_obs.py): one train step's
    counted FLOPs and the 3 x 2 x MACs walk agree within 4x either
    way."""
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    bs = 32
    tr = Trainer(TrainConfig(model="bnn-mlp-small", batch_size=bs,
                             optimizer="adam", learning_rate=0.01,
                             backend=backend, seed=0, device="cpu"))
    analytic, method = pobs.train_step_flops("bnn-mlp-small", tr.model, bs)
    assert method == "analytic_3x_dense_gemms"
    ledger = pobs.CostLedger(registry=pobs.MetricsRegistry(), enabled=True)
    x = torch.zeros((bs, 28, 28, 1))
    y = torch.zeros((bs,), dtype=torch.int64)
    loss, _ = ledger.measure("train_step", tr.train_step, tr.model,
                             tr.optimizer, x, y, device=tr.device)
    assert torch.isfinite(loss)
    row = ledger.costs("train_step")
    assert 0.25 <= row["flops"] / analytic <= 4.0, (row, analytic)
    assert row["bytes_accessed"] > 0
    assert row["hbm"]["argument_bytes"] >= x.nbytes + y.nbytes
    ledger.observe("train_step", 0.004, n=2)
    snap = ledger.snapshot()["train_step"]
    assert snap["dispatches"] == 2 and snap["mean_dispatch_ms"] == 2.0
    assert snap["mfu"] == pobs.mfu(row["flops"], 0.002, 1e11)
    off = pobs.CostLedger(registry=pobs.MetricsRegistry(), enabled=False)
    assert off.measure("p", lambda a: a + 1, 1) == 2
    assert off.costs("p") is None and off.record("p", {}) is None


def test_profile_capture_on_the_cpu_summarises(tmp_path):
    reg = pobs.MetricsRegistry()
    pm = pprofile.ProfileManager(registry=reg)
    tel = pobs.Telemetry(str(tmp_path / "tel"), heartbeat=False)
    pm.start(str(tmp_path / "cap"))
    with pytest.raises(pobs.ProfileBusyError):
        pm.start(str(tmp_path / "other"))
    a = torch.ones(32, 32)
    for _ in range(3):
        with pprofile.step_annotation("train_step", "feedbeef12345678"):
            a = a @ a / 32
    summary = pm.stop(telemetry=tel)
    assert not pm.active and summary["files"] == 1
    assert reg.counter(pprofile.PROFILE_CAPTURES_TOTAL).total() == 1
    cap = pobs.summarize_capture(str(tmp_path / "cap"))
    assert set(cap) >= {"dir", "trace_json", "events", "annotated_steps",
                        "trace_ids", "compile_ms", "other_ms", "top_ops"}
    assert cap["annotated_steps"] == 3
    assert cap["trace_ids"] == ["feedbeef12345678"]
    assert any(op["name"] == pprofile.STEP_MARKER for op in cap["top_ops"])
    assert "annotated steps 3" in pobs.render_capture_summary(cap)
    tel.close()
    ev = [e for e in pobs.load_events(str(tmp_path / "tel" / "events.jsonl"))
          if e["kind"] == "profile_capture"]
    assert ev and ev[0]["dir"] == str(tmp_path / "cap")
    assert ev[0]["files"] == 1 and ev[0]["trace_json"] == summary[
        "trace_json"]
    with pytest.raises(ValueError):
        pm.capture(0, artifact_dir=str(tmp_path / "x"))
    with pytest.raises(FileNotFoundError):
        pobs.summarize_capture(str(tmp_path / "empty"))


def test_kernels_are_attributed_to_their_jg_step_regions(tmp_path):
    """A synthetic trace of the card's streams: the package's kernels by
    counter name, and those whose launch (a runtime or driver event of
    the same correlation id, a graph launch for a replay's kernels) lies
    in a jg_step region of the launching thread."""
    names = {
        "void xnor_gemm_kernel<0, 8>(float const*, int const*)": "xnor",
        "void xnor_gemm_kernel<1, 4>(float const*)": "xnor_sign",
        "void xnor_gemm_kernel<2, 1>(float const*)": "xnor_affine",
        "xnor_unpack_kernel(float const*)": "xnor_unpack",
        "void paged_attn_kernel<64, 1>(float const*)": "paged_attn",
        "void flash_fwd_kernel<64>(float const*)": "flash_fwd",
        "void flash_bwd_dq_kernel<64>(float const*)": "flash_bwd_dq",
        "void flash_bwd_dkv_kernel<64>(float const*)": "flash_bwd_dkv",
        "ampere_sgemm_128x64_nn": None,
    }
    for name, want in names.items():
        assert pprofile.port_kernel(name) == want, name
    k1 = "void xnor_gemm_kernel<0, 8>(float const*, int const*)"
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "jg_step", "tid": 1,
         "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation",
         "name": "jg_trace:abcd1234/train_step", "tid": 1, "ts": 101.0,
         "dur": 40.0},
        # an eager launch inside the region, a graph launch (two
        # kernels) inside it, and an eager launch after it
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC",
         "tid": 1, "ts": 110.0, "dur": 2.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuGraphLaunch",
         "tid": 1, "ts": 120.0, "dur": 2.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "tid": 1, "ts": 200.0, "dur": 2.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": k1, "tid": 7, "ts": 130.0,
         "dur": 3.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": k1, "tid": 7, "ts": 140.0,
         "dur": 3.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": k1, "tid": 7, "ts": 145.0,
         "dur": 3.0, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": k1, "tid": 7, "ts": 210.0,
         "dur": 3.0, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "ampere_sgemm_128x64_nn",
         "tid": 7, "ts": 150.0, "dur": 9.0, "args": {"correlation": 7}},
    ]
    os.makedirs(tmp_path / "cap")
    with gzip.open(tmp_path / "cap" / "h_1_2.pt.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": ev}, f)
    cap = pobs.summarize_capture(str(tmp_path / "cap"))
    assert cap["kernel_launches"] == {"xnor": 4}
    assert cap["kernel_launches_in_steps"] == {"xnor": 3}
    assert cap["annotated_steps"] == 1 and cap["trace_ids"] == ["abcd1234"]
    assert cap["top_kernels"][0] == {"name": k1, "count": 4,
                                     "total_ms": 0.012}
    assert "xnor x4 (3)" in pobs.render_capture_summary(cap)


def test_cli_profile_reads_a_capture(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    pm = pprofile.ProfileManager(registry=pobs.MetricsRegistry())
    pm.start(str(tmp_path))
    with pprofile.step_annotation("p", "00ff00ff00ff00ff"):
        torch.ones(8) + 1
    pm.stop()
    assert main(["profile", str(tmp_path), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["annotated_steps"] == 1
    assert main(["profile", str(tmp_path / "none")]) == 2


def test_the_trainer_banks_its_train_step_row(tmp_path):
    """With the ledger armed, the first eager dispatch is counted and
    banked as ``train_step`` (a ``program_cost`` event), and every
    dispatch feeds its time; disarmed, nothing is counted."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.obs.costs import (
        arm_ledger,
        get_ledger,
    )
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    ledger = arm_ledger(True)
    try:
        td = str(tmp_path / "tel")
        t = Trainer(TrainConfig(model="bnn-mlp-small",
                                model_kwargs={"infl_ratio": 1}, epochs=1,
                                batch_size=32, device="cpu",
                                telemetry_dir=td))
        t.fit(load_mnist(None, synthetic_sizes=(128, 32)))
        row = ledger.snapshot()["train_step"]
    finally:
        arm_ledger(False)
    assert not get_ledger().enabled
    analytic, _ = pobs.train_step_flops("bnn-mlp-small", t.model, 32)
    assert 0.25 <= row["flops"] / analytic <= 4.0
    assert row["dispatches"] >= 4 and row["model"] == "bnn-mlp-small"
    rows = [e for e in pobs.load_events(os.path.join(td, "events.jsonl"))
            if e["kind"] == "program_cost"]
    assert [r["program"] for r in rows] == ["train_step", "train_step"]
    assert rows[-1]["final"] and rows[-1]["dispatches"] >= 4
