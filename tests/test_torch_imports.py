"""Import hygiene of the PyTorch port: no module of the port, and not
``chip_smoke.py``, imports JAX, flax, optax, msgpack (the port carries
its own codec, ``utils/msgpack.py``) or the JAX package; and the
port's kernel build stays out of what git commits."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_mnist_bnns_tpu_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "msgpack",
          "distributed_mnist_bnns_tpu"}


def _sources():
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py"))
             + [REPO / "tests" / "torch_dp_util.py",
                REPO / "tests" / "torch_mp_util.py"])
    assert len(files) > 20
    # the modules of the captured step (train.capture), of remat, of
    # FSDP and of the re-placement across worlds, of model parallelism,
    # the timing scripts and the rank sides of the spawned tests
    assert {PORT / "train" / "capture.py", PORT / "ops" / "remat.py",
            PORT / "parallel" / "fsdp.py",
            PORT / "parallel" / "remesh.py",
            PORT / "parallel" / "mesh.py",
            PORT / "parallel" / "model_parallel.py",
            PORT / "parallel" / "pipeline.py",
            PORT / "parallel" / "pipeline_model.py",
            PORT / "parallel" / "tp_pipeline.py",
            REPO / "scripts" / "torch_mp_timing.py"} <= set(files)
    # and the telemetry package, every module of the JAX obs/ it ports
    assert {PORT / "obs" / f"{m}.py" for m in (
        "__init__", "registry", "events", "heartbeat", "flops",
        "recompile", "trace", "telemetry", "costs", "profile",
        "summary")} <= set(files)
    # and the analyses: the linter, the concurrency pack, the scheduler
    # and the lockstep checker (their framework-free lines are the
    # port's own copies)
    assert {PORT / "analysis" / m for m in (
        "__init__.py", "sched.py", "spmd.py", "lint/__init__.py",
        "lint/core.py", "lint/rules.py", "concurrency/__init__.py",
        "concurrency/rules.py")} <= set(files)
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__") and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(REPO))
)
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in BANNED]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(BANNED)!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_load_packed_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from distributed_mnist_bnns_tpu_torch.infer import load_packed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_packed(str(tmp_path / "absent.msgpack"), device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_packed(str(tmp_path / "absent.msgpack"))


def test_kernel_build_dir_is_ignored_and_sources_ship():
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    assert (PORT / "csrc" / "xnor_gemm.cu").is_file()
    assert {src for _, src in _kernels.KERNELS.values()} == {
        "xnor_gemm.cu", "xnor_unpack.cu", "paged_attn.cu", "flash_attn.cu",
        "flash_bwd.cu",
    }
    if shutil.which("git") is None:
        pytest.skip("git not available")
    probe = os.path.join(_kernels.BUILD_DIR, "libx.so")
    out = subprocess.run(
        ["git", "check-ignore", "-q", probe], cwd=REPO, timeout=60,
    )
    assert out.returncode == 0, "the kernel build directory is not ignored"


def test_signature_table_covers_every_kernel_and_source():
    """Every kernel's symbol has argtypes under its own source, the table
    names no symbol that no kernel uses, and every source exists and
    defines its symbols with C linkage."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    by_source = {}
    for symbol, source in _kernels.KERNELS.values():
        by_source.setdefault(source, set()).add(symbol)
    assert {s: set(t) for s, t in _kernels.SIGNATURES.items()} == by_source
    for source, symbols in by_source.items():
        text = (PORT / "csrc" / source).read_text()
        assert 'extern "C"' in text
        for symbol in symbols:
            assert f"int {symbol}(" in text, (source, symbol)
    assert set(_kernels.LAUNCHES) == set(_kernels.KERNELS)


def test_library_name_follows_source_and_flags(monkeypatch):
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    a = _kernels._lib_path("xnor_gemm.cu")
    assert a == _kernels._lib_path("xnor_gemm.cu")
    assert a.startswith(_kernels.BUILD_DIR) and a.endswith(".so")
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    assert _kernels._lib_path("xnor_gemm.cu") != a
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS


def test_library_name_follows_every_header(monkeypatch, tmp_path):
    """A source may include any header in csrc/: editing, adding or
    removing one gives every source's library a new name, so a stale
    build is never loaded."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "b.cu").write_text("// no include\n")
    header = tmp_path / "common.cuh"
    header.write_text("constexpr int X = 1;\n")
    monkeypatch.setattr(_kernels, "CSRC_DIR", str(tmp_path))
    before = {s: _kernels._lib_path(s) for s in ("a.cu", "b.cu")}
    header.write_text("constexpr int X = 2;\n")
    edited = {s: _kernels._lib_path(s) for s in ("a.cu", "b.cu")}
    (tmp_path / "more.h").write_text("#pragma once\n")
    added = {s: _kernels._lib_path(s) for s in ("a.cu", "b.cu")}
    for s in ("a.cu", "b.cu"):
        assert len({before[s], edited[s], added[s]}) == 3, s
    assert _kernels._lib_path("a.cu") == added["a.cu"]
    # the repository's own headers are hashed too
    monkeypatch.undo()
    headers = [f for f in os.listdir(_kernels.CSRC_DIR)
               if f.endswith(_kernels.HEADER_SUFFIXES)]
    assert headers, "csrc/ has no shared header"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build()


def test_the_data_parallel_modules_are_scanned():
    """The data-parallel modules are among the files held to no JAX
    import, and the torch.distributed ones among those imported."""
    names = {str(p.relative_to(PORT)) for p in _sources() if PORT in p.parents}
    assert {"parallel/__init__.py", "parallel/distributed.py",
            "parallel/data_parallel.py", "ops/comm_compress.py"} <= names
