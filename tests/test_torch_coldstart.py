"""The port's cold-start worker (``aot/coldstart.py``) on the CPU: its JSON
line and its split in each mode, held to the JAX worker's keys.

One mode runs as a real process (a torch process start costs seconds);
the other two run through ``main()`` in this process. On the CPU no
program launches a kernel, so ``compiles`` is 0 both cold and warm and
what moves is ``aot_status``: a miss against the empty store, then a
hit against the store it filled.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from distributed_mnist_bnns_tpu_torch.aot import coldstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX worker's keys (distributed_mnist_bnns_tpu/aot/coldstart.py)
JAX_KEYS = {"mode", "aot", "aot_status", "boot_s", "first_s", "compiles"}
SPLIT_KEYS = {"interp_s", "import_s", "cuda_init_s", "libs_s", "rest_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, restored after: the
    suite runs in parallel workers, whose default pools oversubscribe
    the CPU (a first training step here took seconds with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    return coldstart.make_tiny_artifacts(str(tmp_path_factory.mktemp("cs")))


def _lines(text):
    rows = [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]
    split = [r["coldstart_split"] for r in rows if "coldstart_split" in r]
    return split[-1], rows[-1]


def _check(split, rec, mode, status):
    assert JAX_KEYS <= set(rec) and set(split) == SPLIT_KEYS
    assert (rec["mode"], rec["aot"], rec["aot_status"]) == (mode, True,
                                                            status)
    assert rec["compiles"] == 0 and rec["nvcc_s"] == {}
    assert 0 < rec["boot_s"] <= rec["first_s"]
    assert split["cuda_init_s"] == 0.0 and split["libs_s"] == 0.0
    parts = split["import_s"] + split["rest_s"]
    assert split["import_s"] >= 0 and abs(parts - rec["boot_s"]) < 0.01


def test_serve_mode_in_a_process_miss_then_hit(artifacts, tmp_path,
                                               capsys):
    store, kdir = str(tmp_path / "store"), str(tmp_path / "kernels")
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.aot."
            "coldstart", "--mode", "serve", "--artifact", artifacts[0],
            "--store", store, "--device", "cpu"]
    env = dict(os.environ, JG_KERNEL_DIR=kdir, OMP_NUM_THREADS="1")
    out = subprocess.run(argv, capture_output=True, text=True, cwd=REPO,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    split, rec = _lines(out.stdout)
    _check(split, rec, "serve", "miss")
    assert split["interp_s"] > 0 and split["import_s"] > 0   # torch's
    assert os.listdir(os.path.join(store, "classifier_predict"))
    assert coldstart.main(argv[3:]) == 0      # warm: the filled store
    _check(*_lines(capsys.readouterr().out), "serve", "hit")


@pytest.mark.parametrize("mode", ["lm", "train"])
def test_mode_in_process_miss_then_hit(artifacts, tmp_path, capsys, mode):
    store = str(tmp_path / "store")
    argv = ["--mode", mode, "--store", store, "--device", "cpu"]
    if mode == "lm":
        argv += ["--artifact", artifacts[1]]
    else:
        argv += ["--train-batch-size", "8"]
    for status in ("miss", "hit"):
        assert coldstart.main(argv) == 0
        split, rec = _lines(capsys.readouterr().out)
        _check(split, rec, mode, status)
    if mode == "lm":
        assert rec["first_kind"] == "token"


def test_no_aot_is_disabled(artifacts, tmp_path, capsys):
    assert coldstart.main(["--mode", "train", "--store", str(tmp_path),
                           "--device", "cpu", "--no-aot",
                           "--train-batch-size", "8"]) == 0
    _, rec = _lines(capsys.readouterr().out)
    assert (rec["aot"], rec["aot_status"]) == (False, "disabled")
    assert not os.listdir(str(tmp_path))
