"""Build, load and launch the package's CUDA kernels; count launches.

The sources live in ``csrc/``. Each is compiled at first use by ``nvcc``
into a shared library with a plain C interface, under ``_build/`` beside
this package (listed in ``.gitignore``), and loaded with ``ctypes``. The
library's file name carries a hash of the source, of every header in
``csrc/`` (a source may include any of them) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded. Nothing
here runs at import time: the CPU tests import every module, and this
module must import on a machine that has no ``nvcc``.

``LAUNCHES`` counts, per kernel, the launches the wrappers made. It is
incremented where a kernel is launched and nowhere else, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel name -> (C launcher symbol, source file). One source holds the
# three epilogues of the packed GEMM, one the flash-attention forward and
# one its two backward kernels.
KERNELS = {
    "xnor": ("xnor_gemm_none", "xnor_gemm.cu"),
    "xnor_sign": ("xnor_gemm_sign", "xnor_gemm.cu"),
    "xnor_affine": ("xnor_gemm_affine", "xnor_gemm.cu"),
    "xnor_unpack": ("xnor_unpack", "xnor_unpack.cu"),
    "paged_attn": ("paged_attn", "paged_attn.cu"),
    "flash_fwd": ("flash_fwd", "flash_attn.cu"),
    "flash_bwd_dq": ("flash_bwd_dq", "flash_bwd.cu"),
    "flash_bwd_dkv": ("flash_bwd_dkv", "flash_bwd.cu"),
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# Source file -> {C launcher symbol: argtypes}. Pointers and the stream are
# c_void_p (a bare Python int would be cut to 32 bits); every launcher
# returns a cudaError_t as int.
SIGNATURES = {
    "xnor_gemm.cu": {
        # x, w, out, m, n, k, ldw, bn, share, rule, stream
        "xnor_gemm_none": [_P] * 3 + [_I] * 7 + [_P],
        # x, w, a, t, bias, out, m, n, k, ldw, bn, share, rule, stream
        "xnor_gemm_sign": [_P] * 6 + [_I] * 7 + [_P],
        # x, w, a, c, bias, out, m, n, k, ldw, bn, share, rule, stream
        "xnor_gemm_affine": [_P] * 6 + [_I] * 7 + [_P],
    },
    "xnor_unpack.cu": {
        # x, w, out, m, n, ldw, k, stream
        "xnor_unpack": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "paged_attn.cu": {
        # q, qpos, k_pool, v_pool, tables, out, S, C, H, D, page_size, P,
        # num_pages, scale, stream
        "paged_attn": [_P] * 6 + [_I] * 7 + [_F, _P],
    },
    "flash_attn.cu": {
        # q, k, v, out, lse, B, H, Lq, Lk, D, causal, scale, stream
        "flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
    },
    "flash_bwd.cu": {
        # q, k, v, dout, lse, coeff, dq, B, H, Lq, Lk, D, causal, scale,
        # stream
        "flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _P],
        # q, k, v, dout, lse, coeff, dk, dv, B, H, Lq, Lk, D, causal,
        # scale, stream
        "flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _P],
    },
}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_lock = threading.Lock()          # guards _libs and the builds it starts
_count_lock = threading.Lock()    # guards LAUNCHES
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return path


HEADER_SUFFIXES = (".cuh", ".h")


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR)
                     if f.endswith(HEADER_SUFFIXES))
    for name in (source, *headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _compile(source: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half


def build(sources: Optional[list] = None) -> Dict[str, float]:
    """Compile every source not built yet, one ``nvcc`` per source, all
    started together. Returns {source: seconds} for the sources this
    call compiled."""
    todo = []
    for source in sorted(set(sources or (s for _, s in KERNELS.values()))):
        out = _lib_path(source)
        if not os.path.exists(out):
            todo.append((source, out))
    threads, errors, seconds = [], [], {}

    def run(source: str, out: str) -> None:
        t0 = time.perf_counter()
        try:
            _compile(source, out)
        except RuntimeError as e:
            errors.append(e)
            return
        seconds[source] = time.perf_counter() - t0

    for source, out in todo:
        th = threading.Thread(target=run, args=(source, out))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return seconds


def _library(source: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        path = _lib_path(source)
        if not os.path.exists(path):
            build([source])
        lib = ctypes.CDLL(path)
        for symbol, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
        return lib


def _check(t: torch.Tensor, device: torch.device, dtype: torch.dtype,
           shape: tuple, what: str) -> None:
    if t.device != device or t.dtype != dtype \
            or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{what}: want contiguous {device} {dtype} of shape {shape}, got "
            f"{t.device} {t.dtype} {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}"
        )


def _launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher on PyTorch's current stream of
    the device of the tensors it was given, raise on a launch error, and
    count the launch."""
    symbol, source = KERNELS[name]
    lib = _library(source)
    err = getattr(lib, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    with _count_lock:
        LAUNCHES[name] += 1


# How K1-K3 pack x (csrc/xnor_gemm.cu): bit = x > 0, pack_bits(x) bit for
# bit; or bit = x >= 0, pack_bits(binarize_ste(x)) bit for bit (-0.0 gives
# 1, NaN 0). Either reads a subnormal x as 0, as pack_bits does.
PACK_GT0, PACK_GE0 = 0, 1

XNOR_BLOCK_M = 16        # rows a block (one m16 tile)
XNOR_BLOCK_NS = (128, 64, 32)   # columns a block (one n8 tile per warp)
XNOR_MIN_BLOCKS = 48     # the widest tile that still gives this many blocks
XNOR_MAX_SHARE = 8       # blocks of a cluster sharing x (the portable limit)
XNOR_SHARE_BYTES = 8192  # fp32 x a block loads, about, where sharing allows


def xnor_tiling(m: int, k: int, n: int, block_n: int = 0,
                max_share: int = XNOR_MAX_SHARE):
    """(block_n, share) of K1-K3 at (M, K, N).

    ``block_n`` is the widest of ``XNOR_BLOCK_NS`` that still gives
    ``XNOR_MIN_BLOCKS`` blocks, else the narrowest; a non-zero
    ``block_n`` is taken as it is (scripts/torch_xnor_variants.py
    compares tiles).
    ``share`` consecutive column tiles form a cluster that packs each row
    of x once: each block loads and packs 1/share of it (about
    ``XNOR_SHARE_BYTES`` of fp32) and stores the words into every block
    of the cluster. It is the largest divisor of the tile count (no idle
    block) that is at most ``max_share`` and K's words. A cluster's blocks
    run on one GPC, about 16 SMs of the H100 at one block each: clusters of
    12 left the 96 blocks of (32, 3072, 1536) at block_n 32 two waves
    (10.0 us, against 5.9 at 8; scripts/torch_xnor_variants.py)."""
    tiles_m = -(-m // XNOR_BLOCK_M)
    if not block_n:
        block_n = next((bn for bn in XNOR_BLOCK_NS[:-1]
                        if -(-n // bn) * tiles_m >= XNOR_MIN_BLOCKS),
                       XNOR_BLOCK_NS[-1])
    if block_n not in XNOR_BLOCK_NS:
        raise ValueError(f"block_n {block_n} not in {XNOR_BLOCK_NS}")
    tiles = -(-n // block_n)
    want = -(-4 * min(m, XNOR_BLOCK_M) * k // XNOR_SHARE_BYTES)
    most = max(1, min(want, max_share, -(-k // 32)))
    share = max(d for d in range(1, min(most, tiles) + 1) if tiles % d == 0)
    return block_n, share


def xnor_gemm(
    name: str, x: torch.Tensor, wp: torch.Tensor, k: int, n: int,
    va: Optional[torch.Tensor] = None, vb: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, *, rule: int = PACK_GT0,
) -> torch.Tensor:
    """Launch packed-GEMM kernel ``name`` ("xnor", "xnor_sign" or
    "xnor_affine") on PyTorch's current stream.

    x: (M, K) contiguous fp32 activations, packed inside the kernel by
    ``rule`` (``PACK_GT0`` or ``PACK_GE0``); wp: (KW_p >= KW, N_p >= n)
    int32 K-major packed weights; va/vb/bias: (n,) fp32 epilogue vectors
    (a, t) for the sign epilogue, (a, c) for the affine one. Returns
    (M, n) fp32. Does not synchronise."""
    if not x.is_cuda:
        raise ValueError(f"x lies on {x.device}, not on a CUDA device")
    dev = x.device
    m = x.shape[0] if x.dim() == 2 else -1
    _check(x, dev, torch.float32, (m, k), "x")
    if rule not in (PACK_GT0, PACK_GE0):
        raise ValueError(f"unknown pack rule {rule}")
    kw = -(-k // 32)
    if wp.dim() != 2 or wp.shape[0] < kw or wp.shape[1] < n:
        raise ValueError(
            f"packed w {tuple(wp.shape)} does not cover ({kw} words, {n})"
        )
    _check(wp, dev, torch.int32, tuple(wp.shape), "packed w")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    vecs = []
    if name != "xnor":
        for v, what in ((va, "a"), (vb, "t/c"), (bias, "bias")):
            _check(v, dev, torch.float32, (n,), what)
            vecs.append(v.data_ptr())
    bn, share = xnor_tiling(m, k, n)
    _launch(name, x.data_ptr(), wp.data_ptr(), *vecs, out.data_ptr(),
            m, n, k, wp.shape[1], bn, share, rule,
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def xnor_unpack(x: torch.Tensor, wp: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Launch K7 on PyTorch's current stream: (M, K) fp32 x times the
    ±1 weights packed in ``wp`` ((KW_p >= KW, N_p >= n) int32, K-major)
    -> (M, n) fp32. Does not synchronise."""
    if not x.is_cuda:
        raise ValueError(f"x lies on {x.device}, not on a CUDA device")
    dev = x.device
    m = x.shape[0]
    _check(x, dev, torch.float32, (m, k), "x")
    kw = -(-k // 32)
    if wp.dim() != 2 or wp.shape[0] < kw or wp.shape[1] < n:
        raise ValueError(
            f"packed w {tuple(wp.shape)} does not cover ({kw} words, {n})"
        )
    _check(wp, dev, torch.int32, tuple(wp.shape), "packed w")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    _launch("xnor_unpack", x.data_ptr(), wp.data_ptr(), out.data_ptr(),
            m, n, wp.shape[1], k, torch.cuda.current_stream(dev).cuda_stream)
    return out


# K8 keeps a block's table row in shared memory beside its staged K/V
# tiles; 16384 ids fit at every head dim (csrc/paged_attn.cu, Layout).
PAGED_MAX_TABLE = 16384


def paged_attn(q4: torch.Tensor, qpos: torch.Tensor, k_pool: torch.Tensor,
               v_pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Launch K8 on PyTorch's current stream: queries (S, C, H, D) fp32
    at positions ``qpos`` (S, C) int32 attend through page ``tables``
    (S, P) int32 over the (num_pages, page_size, H, D) fp32 pools ->
    (S, C, H, D) fp32. A cluster of 8 blocks serves up to 16 queries of
    a (head, slot). Does not synchronise; the K/V writes this step made
    on the same stream are ordered before it."""
    if not q4.is_cuda:
        raise ValueError(f"q lies on {q4.device}, not on a CUDA device")
    dev = q4.device
    s, c, h, d = q4.shape
    num_pages, ps = k_pool.shape[0], k_pool.shape[1]
    if d > 128:
        raise ValueError(f"head_dim {d} > 128 is not supported by the kernel")
    if tables.dim() == 2 and tables.shape[1] > PAGED_MAX_TABLE:
        raise ValueError(
            f"a table row of {tables.shape[1]} pages does not fit the "
            f"kernel's shared memory (at most {PAGED_MAX_TABLE})"
        )
    _check(q4, dev, torch.float32, (s, c, h, d), "q")
    _check(qpos, dev, torch.int32, (s, c), "qpos")
    _check(k_pool, dev, torch.float32, (num_pages, ps, h, d), "k pool")
    _check(v_pool, dev, torch.float32, (num_pages, ps, h, d), "v pool")
    if tables.dim() != 2 or tables.shape[0] != s:
        raise ValueError(f"tables must be ({s}, P), got {tuple(tables.shape)}")
    _check(tables, dev, torch.int32, tuple(tables.shape), "tables")
    out = torch.empty_like(q4)
    if q4.numel() == 0:
        return out
    _launch("paged_attn", q4.data_ptr(), qpos.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), out.data_ptr(),
            s, c, h, d, ps, tables.shape[1], num_pages, d ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    return out


def _flash_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Check (B, Lq, H, D) q and (B, Lk, H, D) k, v for the flash kernels;
    return (device, B, Lq, Lk, H, D)."""
    if not q.is_cuda:
        raise ValueError(f"q lies on {q.device}, not on a CUDA device")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(
            f"q, k, v must be (B, L, H, D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}"
        )
    dev = q.device
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d > 128 or min(b, lq, lk, h, d) == 0:
        raise ValueError(
            f"the flash kernels take 1 <= head_dim <= 128 and non-empty "
            f"operands, got q {tuple(q.shape)}, k {tuple(k.shape)}"
        )
    _check(q, dev, torch.float32, (b, lq, h, d), "q")
    _check(k, dev, torch.float32, (b, lk, h, d), "k")
    _check(v, dev, torch.float32, (b, lk, h, d), "v")
    return dev, b, lq, lk, h, d


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool):
    """Launch K4 on PyTorch's current stream: (B, Lq, H, D) fp32 q
    against (B, Lk, H, D) k, v -> out (B, Lq, H, D) and lse (B, Lq, H),
    both fp32. Does not synchronise."""
    dev, b, lq, lk, h, d = _flash_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, lq, h), dtype=torch.float32, device=dev)
    _launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, lq, lk, d, int(causal),
            d ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    return out, lse


def _flash_bwd_operands(q, k, v, dout, lse, coeff):
    dev, b, lq, lk, h, d = _flash_operands(q, k, v)
    _check(dout, dev, torch.float32, (b, lq, h, d), "dout")
    _check(lse, dev, torch.float32, (b, lq, h), "lse")
    _check(coeff, dev, torch.float32, (b, lq, h), "coeff")
    return dev, b, lq, lk, h, d


def flash_bwd_dq(q, k, v, dout, lse, coeff, causal: bool) -> torch.Tensor:
    """Launch K5 on PyTorch's current stream: dq (B, Lq, H, D) fp32 from
    the forward's operands, the cotangent ``dout`` of out, its ``lse``
    and ``coeff = g_lse - rowsum(dout * out)`` ((B, Lq, H) fp32 each).
    Does not synchronise."""
    dev, b, lq, lk, h, d = _flash_bwd_operands(q, k, v, dout, lse, coeff)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), coeff.data_ptr(), dq.data_ptr(),
            b, h, lq, lk, d, int(causal), d ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, coeff, causal: bool):
    """Launch K6 on PyTorch's current stream: (dk, dv), each (B, Lk, H,
    D) fp32, from the operands K5 takes. Does not synchronise."""
    dev, b, lq, lk, h, d = _flash_bwd_operands(q, k, v, dout, lse, coeff)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), coeff.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, lq, lk, d, int(causal), d ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    return dk, dv
