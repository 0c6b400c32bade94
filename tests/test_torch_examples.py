"""The port's examples (``examples/demos.py``, ``examples/accuracy_report.py``)
on the CPU, held to the JAX package's.

The three demos run in one spawn of 2 gloo ranks (the rank side in
``tests/torch_examples_util.py``), from JAX's toy state and batch (``_toy_state`` and ``_toy_batch`` of the JAX demos, carried
across as numpy), and each returns the loss JAX's demo returns on its
8-device CPU mesh: the data-parallel demos to rtol 1e-5, the
tensor-parallel one to atol 1e-4 (the DP and TP parity tests'
tolerances). Both sides build the model without dropout, whose masks
the two packages draw differently.

The report's rows, sweep and sections are held to JAX's ``run`` on the
same histories (both sides' trainers stubbed, so nothing trains); the
port's also runs for real on a tiny synthetic split, written to a path
of the test's own.
"""

import functools
import json
import os
import re

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch.examples import accuracy_report, demos


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, restored after: the
    suite runs in parallel workers, whose default pools oversubscribe
    the CPU (a first training step here took seconds with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_demos_over_gloo_ranks_return_jax_losses(tmp_path):
    """The port's ranks start beside JAX's toy state and demos, and take
    that state (pickled to a file they wait for) when it is made."""
    import pickle
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import jax

    import distributed_mnist_bnns_tpu.examples.demos as jd
    from distributed_mnist_bnns_tpu.models import bnn_mlp_small
    from distributed_mnist_bnns_tpu_torch.parallel import spawn
    from tests.torch_examples_util import demos_rank

    path = str(tmp_path / "toy.pkl")
    box = {}
    ranks = threading.Thread(target=lambda: box.update(out=spawn(
        demos_rank, 2, backend="gloo", device="cpu", args=(path,))))
    ranks.start()
    real = jd.bnn_mlp_small
    jd.bnn_mlp_small = functools.partial(bnn_mlp_small, dropout_rate=0.0)
    # the three JAX demos in threads beside the toy state made here: most
    # of their time is XLA's compiles, which run outside the GIL
    pool = ThreadPoolExecutor(3)
    try:
        want = {name: pool.submit(getattr(jd, name)) for name in (
            "demo_basic", "demo_checkpoint", "demo_model_parallel")}
        state, _ = jd._toy_state(seed=0)
        variables = jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        batches = tuple(tuple(np.asarray(a) for a in jd._toy_batch(
            n, seed=0)) for n in (64, 32))
        with open(path + ".tmp", "wb") as f:
            pickle.dump((variables, batches), f)
        os.replace(path + ".tmp", path)
        want = {name: f.result() for name, f in want.items()}
    finally:
        pool.shutdown()
        jd.bnn_mlp_small = real
        ranks.join()
    assert jax.device_count() == 8 and set(want) == {
        n for n in dir(demos) if n.startswith("demo_")}
    got = box["out"]
    assert got[0] == got[1]
    for name, loss in got[0].items():
        tol = (dict(atol=1e-4, rtol=0) if name == "demo_model_parallel"
               else dict(rtol=1e-5, atol=0))
        np.testing.assert_allclose(loss, want[name], **tol, err_msg=name)


def _data(n_train, n_test):
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    return load_mnist("/nonexistent-mnist", synthetic_sizes=(n_train,
                                                              n_test))


def _headings(text):
    """The report's headings, table headers and the JSON block's keys."""
    lines = [ln for ln in text.splitlines()
             if ln.startswith("#") or ln.startswith("| model")
             or ln.startswith("| train images")]
    block = json.loads(text.split("```json\n", 1)[1].split("\n```", 1)[0])
    keys = [sorted(r) for r in block]
    sweep = block[-1].get("train_size_sweep")
    return lines, keys, [sorted(s) for s in sweep or []]


def test_report_runs_on_the_data_it_names(tmp_path):
    data = _data(256, 64)
    out = str(tmp_path / "port.md")
    rows = accuracy_report.run(["bnn-mlp-small"], 1, 64, 0.01, [0], out,
                               device="cpu", data=data)
    r = rows[0]
    assert np.isfinite(r["test_loss"]) and len(r["epoch_times_s"]) == 1
    assert 0.0 <= r["test_acc"] <= 100.0
    with open(out) as f:
        text = f.read()
    assert "`synthetic`" in text and "synthetic data" in text


def test_report_rows_and_sections_match_jax(tmp_path, monkeypatch):
    """Both reports over the same histories (each side's trainer stubbed,
    so nothing trains): the same rows, sweep and sections."""
    import distributed_mnist_bnns_tpu.data as jdata
    import distributed_mnist_bnns_tpu.train as jtrain
    from distributed_mnist_bnns_tpu.data.common import (
        ImageClassData as JaxData,
    )
    from distributed_mnist_bnns_tpu.examples import (
        accuracy_report as jreport,
    )

    hist = [{"test_acc": 81.25, "test_acc_top5": 99.5, "test_loss": 0.75,
             "epoch_time_s": 1.5}]

    class Fit:
        def __init__(self, *a, **kw):
            pass

        def fit(self, _data):
            return hist

    data = _data(256, 64)
    models = ["bnn-mlp-large", "fp32-mlp-large"]
    monkeypatch.setattr(accuracy_report, "_trainer", Fit)
    out = str(tmp_path / "port.md")
    rows = accuracy_report.run(models, 1, 64, 0.01, [0, 1], out,
                               sweep_sizes=[128], device="cpu", data=data)
    monkeypatch.setattr(jtrain, "Trainer", Fit)
    monkeypatch.setattr(jdata, "load_mnist", lambda: JaxData(
        data.train_images, data.train_labels, data.test_images,
        data.test_labels, source=data.source))
    jout = str(tmp_path / "jax.md")
    jreport.run(models, 1, 64, 0.01, [0, 1], jout, sweep_sizes=[128])
    with open(out) as f:
        port_text = f.read()
    with open(jout) as f:
        jax_text = f.read()
    assert _headings(port_text) == _headings(jax_text)
    block = jax_text.split("```json\n", 1)[1].split("\n```", 1)[0]
    assert rows == json.loads(block)
    assert re.findall(r"Data: `(\w+)`", port_text) == re.findall(
        r"Data: `(\w+)`", jax_text) == ["synthetic"]
    assert "accuracy gap" in port_text and "accuracy gap" in jax_text


def test_oversized_sweep_is_refused_with_jaxs_error(tmp_path):
    from distributed_mnist_bnns_tpu.data.common import (
        ImageClassData as JaxData,
    )
    from distributed_mnist_bnns_tpu.examples import (
        accuracy_report as jreport,
    )

    data = _data(64, 16)
    with pytest.raises(ValueError) as jax_err:
        jreport._train_size_sweep(
            JaxData(data.train_images, data.train_labels, data.test_images,
                    data.test_labels), [32, 1000], 1, 64, 0.01, [0], 1)
    out = tmp_path / "r.md"
    with pytest.raises(ValueError) as port_err:
        accuracy_report.run(["bnn-mlp-small"], 1, 64, 0.01, [0], str(out),
                            sweep_sizes=[32, 1000], device="cpu", data=data)
    assert str(port_err.value) == str(jax_err.value)
    assert not out.exists()       # refused before any training
