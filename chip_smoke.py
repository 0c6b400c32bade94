"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. the card: exit non-zero without CUDA; print the card's name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compile every kernel from ``csrc/`` (one ``nvcc`` per
     source, all started together);
  3. kernels: each packed-GEMM kernel (K1 none, K2 sign, K3 affine
     epilogue) against its plain PyTorch version on the card,
     ``torch.equal``, at the serving paths' shapes (K1 at every (K, N)
     of the LM's projections and at the MLP's layer 2), at ragged and
     multi-chunk shapes, and with g < 0, g == 0 and exact tie columns;
     K7 (fused bitplane-unpack GEMM, bf16 ``mma.sync`` on an exact
     three-piece split of x) the same way on ±1 x and to rtol 1e-5 on
     real x, two runs bitwise equal; K8 (paged attention) against the
     gather path to atol = rtol = 1e-5 in decode, prefill and verify
     shapes over scrambled, reused and null pages. Then CUDA-graph
     timings of each kernel at its main path's shape (K7 also at M = 1
     and 64), its plain version, one PyTorch library call computing the
     same function, and the bound;
  4. MLP slice: ``bnn-mlp-large`` at full width (784-3072-1536-768-10)
     from a seeded ``torch.Generator`` with random BN statistics,
     frozen, exported, ``load_packed`` on ``cuda``, checked against the
     live eval model, then served by the port's HTTP server (batch 32)
     and queried through the port's client; the launch counters are
     zeroed just before this phase and read just after it. Then the
     frozen predictor's time per batch of 32 on the host clock and, from
     ``torch.profiler``, its device time and largest kernels;
  5. LM slice: the ``BinarizedLM`` of ``bench.py --lm-serve-bench``
     (vocab 256, max_len 256, embed 256, depth 4, 4 heads, MLP 512)
     from a seeded ``torch.Generator`` with random biases and LayerNorm
     parameters, frozen and exported; a 60-token
     sequence teacher-forced through the paged decoder (K7 prefill, K1
     decode projections, K8 attention) and the contiguous decoder on the
     card; then the continuous-batching server (4 slots, pages of 16)
     answers 6 concurrent greedy ``/generate`` requests (prompts of 5 to
     150 tokens, 32 new tokens each, one sent as text), each stream
     equal to the decoder driven directly for that prompt alone. The
     counters are zeroed just before the requests and read just after:
     K1 and K8 must have launched, and K7 24 times (4 blocks x 6
     projections) per prefill chunk. Then decode-iteration and
     prefill-chunk times, device time from ``torch.profiler``, and the
     requests' time to first token and time per token;
  6. flash attention: K4 (forward: exact fp32 scores, P V in 3xTF32 on
     the tensor cores), K5 (dq) and K6 (dk, dv; 3xTF32) against their
     plain versions on the card at
     the six shapes of ``tests_tpu/test_hardware_kernels.py``, at the
     training width (B, H, L, D) = (8, 4, 1024, 64), causal, and at two
     ragged head dims: out and lse to atol = rtol = 2e-5, the gradients
     (g_lse != 0) to ``FLASH_GRAD_TOL``; two runs of each kernel bitwise
     equal. Then CUDA-graph timings at the training width against the
     plain versions, PyTorch's fp32 memory-efficient attention (SDPA's
     forward for K4; its backward kernel, also in a CUDA graph, for K5,
     K6 and the port's whole backward, ``flash_bwd_total``) and the
     bound;
  7. LM training: the ``bench.py --lm-bench`` step (vocab 256, max_len
     1024, embed 256, depth 4, 4 heads, MLP 512, batch 8 x 1024, Adam
     1e-3, latent clamp). One step with flash attention against one with
     the exact softmax from the same seeded weights (random biases and
     LayerNorm parameters) and batch: losses within 1e-4 relative, each
     parameter's gradient within ``LM_GRAD_RTOL`` in relative L2 norm
     (the key bias's, exactly 0 in exact arithmetic, printed). Then
     ``examples/lm_demo.py::run`` trains 20 steps on the periodic corpus
     with flash attention and exports the model, the counters zeroed
     just before and read just after: each flash kernel launched
     depth x steps times, every loss finite, the last below the first.
     A second run from the same seed must give a bitwise-equal loss
     history, as the JAX package's training does; the token embedding's
     one-hot weight gradient, which makes it so, is timed against
     PyTorch's embedding backward.
     The artifact's full forward is held against the trained model.
     Then step time on the host clock and device time from
     ``torch.profiler``.

The last lines are the per-kernel JSON lines, the card's name and power
limit, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the lowest
# precision the data sheet lists; a ±1 GEMM counts 2*M*N*K operations
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores (data sheet)
H100_TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core peak (data sheet);
# an fp32-accurate product in 3xTF32 takes three TF32 products
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak (data sheet);
# fp32 x times a ±1 weight is exact in three bf16 products (x in three
# pieces, ±1 exact in bf16)
# The card's rates for fp32-accurate products of fp32 operands: fp32 on
# the CUDA cores, or TF32 on the tensor cores over three (3xTF32).
FP32_RATES = {"fp32 CUDA cores": H100_FP32_OPS_PER_S,
              "3xTF32 tensor cores": H100_TF32_OPS_PER_S / 3}

MAIN_M = 32  # the MLP server's micro-batch: the shape its path runs
LAYER2 = (3072, 1536)  # (K, N) of K2 in bnn-mlp-large
LAYER3 = (1536, 768)   # (K, N) of K3

LM_WIDTH = dict(vocab=256, max_len=256, embed_dim=256, depth=4,
                num_heads=4, mlp_ratio=2)
LM_SLOTS = 4           # decode rows: K1's M on the LM path
LM_CHUNK = 16          # prefill rows: K7's M on the LM path
LM_PAGE = 16
LM_MLP1 = (256, 512)   # (K, N) of the LM's widest projection
# (K, N) of every packed LM projection: q/k/v/out, mlp1, mlp2
LM_PROJ = ((256, 256), LM_MLP1, (512, 256))
LM_PROMPTS = (5, 16, 17, 40, 100, 150)
LM_NEW_TOKENS = 32
LM_TEXT = "chip_smoke: text!"   # 17 bytes: the request sent as "text"

# (B, H, Lq, Lk, D, causal): the six shapes tests_tpu holds the Pallas
# kernels to on the TPU, then the training width, which is timed.
FLASH_SHAPES = (
    (2, 4, 256, 256, 64, False), (2, 4, 256, 256, 64, True),
    (1, 2, 512, 512, 128, True), (1, 1, 7, 7, 16, False),
    (1, 2, 200, 333, 64, False), (1, 2, 96, 128, 64, True),
    (8, 4, 1024, 1024, 64, True),
)
# Head dims that are no multiple of 8 (D = 36: 16-byte copies, a zero-filled
# tail) and of 4 (D = 7: 4-byte copies), checked before FLASH_SHAPES.
FLASH_EDGE_SHAPES = ((1, 2, 33, 40, 36, False), (1, 3, 70, 99, 7, True))
# The gradients sum up to 1024 products of O(1) terms in another order
# than the plain version's einsums, so they agree to fp32 rounding of
# such sums, not bitwise.
FLASH_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# The flash LM step's gradients against the exact-softmax step's, each
# parameter in relative L2 norm: ten times the kernels' own gradient
# tolerance, for four blocks of attention backward stacked.
LM_GRAD_RTOL = 1e-3
# bench.py --lm-bench (_bench_lm, bench.py:840-909; widths :1739-1743)
LM_TRAIN = dict(vocab=256, embed_dim=256, depth=4, num_heads=4, mlp_ratio=2)
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_LR, LM_TRAIN_STEPS = 1024, 8, 1e-3, 20

_SRC = "distributed_mnist_bnns_tpu_torch/csrc/"
_TPU = "distributed_mnist_bnns_tpu/ops/"
KERNEL_ROWS = {
    # name -> (TPU kernel it replaces, source, timed (M, K, N))
    "xnor": (_TPU + "xnor_gemm.py:81", _SRC + "xnor_gemm.cu",
             (LM_SLOTS, *LM_MLP1)),
    "xnor_sign": (_TPU + "xnor_gemm.py:124", _SRC + "xnor_gemm.cu",
                  (MAIN_M, *LAYER2)),
    "xnor_affine": (_TPU + "xnor_gemm.py:149", _SRC + "xnor_gemm.cu",
                    (MAIN_M, *LAYER3)),
    "xnor_unpack": (_TPU + "xnor_gemm.py:374", _SRC + "xnor_unpack.cu",
                    (LM_CHUNK, *LM_MLP1)),
    "paged_attn": (_TPU + "paged_kv.py:355", _SRC + "paged_attn.cu", None),
    "flash_fwd": (_TPU + "flash_attention.py:53", _SRC + "flash_attn.cu",
                  None),
    "flash_bwd_dq": (_TPU + "flash_attention.py:307",
                     _SRC + "flash_bwd.cu", None),
    "flash_bwd_dkv": (_TPU + "flash_attention.py:353",
                      _SRC + "flash_bwd.cu", None),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def _pm1(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.where(torch.rand(*shape, generator=gen) > 0.5, 1.0, -1.0)


def _sign_vectors(gen, n: int, o_row: torch.Tensor):
    """(a, t, bias) of K2 from BN parameters with g > 0, g < 0 and
    g == 0 columns, through the port's own folding; every fourth column
    gets a threshold equal to row 0's value, an exact >= tie."""
    from distributed_mnist_bnns_tpu_torch.infer import _bn_sign_epilogue

    g = torch.randn(n, generator=gen)
    g[::5] = 0.0
    g[1::3] = -g[1::3].abs()
    params = {"scale": g, "bias": torch.randn(n, generator=gen)}
    stats = {"mean": torch.randn(n, generator=gen) * 8.0,
             "var": torch.rand(n, generator=gen) * 50.0 + 1.0}
    a, t = _bn_sign_epilogue(params, stats)
    bias = torch.randn(n, generator=gen)
    ties = torch.arange(n) % 4 == 0
    t = torch.where(ties, a * (o_row.cpu() + bias), t)
    return a, t, bias


def _affine_vectors(gen, n: int):
    a = torch.randn(n, generator=gen) / 16.0
    a[::7] = 0.0
    c = torch.randn(n, generator=gen)
    bias = torch.randn(n, generator=gen)
    return a, c, bias


def _graph_ms(fn, iters: int = 50, reps: int = 15) -> float:
    """Median device time of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host
    launch overhead is not in the number. Operands stay in L2 between
    calls, as the serving path's weights do from batch to batch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _events_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Median time of one ``fn()``: ``iters`` eager calls between CUDA
    events, ``reps`` times (for a call a CUDA graph may not capture)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _roofline(nbytes: float, ops: float, rates: dict):
    """Least time (ms) of a function that moves ``nbytes`` and does
    ``ops`` operations: the larger of the bytes against HBM bandwidth and
    the operations at the fastest of ``rates`` (name -> per second).
    Returns (ms, "bytes" or "operations", the peak that bounds)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    peak = max(rates, key=rates.get)
    t_ops = ops / rates[peak] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "HBM"
    return t_ops, "operations", peak


def _bound(name: str, m: int, k: int, n: int):
    """K1-K3's bound: packed x and the real weight words read once, the
    epilogue vectors read once, the fp32 output written once; 2*M*N*K ±1
    operations at the int8 tensor-core peak."""
    kw = -(-k // 32)
    vecs = 0 if name == "xnor" else 3
    nbytes = 4 * (m * kw + kw * n + vecs * n + m * n)
    return _roofline(nbytes, 2.0 * m * n * k,
                     {"int8 tensor cores": H100_INT8_OPS_PER_S})


def kernel_phase(name: str, device: torch.device, gen: torch.Generator):
    """Compare packed-GEMM kernel ``name`` (K1-K3) with its plain
    version at every listed shape; time it at the main paths' (K, N).
    Returns the timing rows and the largest absolute difference seen."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    main_m, *main_kn = KERNEL_ROWS[name][2]
    main_kn = tuple(main_kn)
    ms = sorted({1, main_m, MAIN_M, 256})
    shapes = [(m, *main_kn) for m in ms]
    if name == "xnor":
        # every (K, N) the LM decode path gives K1, and the MLP's layer 2
        shapes += [(m, k, n) for m in ms for k, n in LM_PROJ
                   if (k, n) != main_kn]
        shapes += [(m, *LAYER2) for m in (1, MAIN_M, 256)]
    shapes += [(17, 100, 130), (5, 31, 1), (3, 4160, 200), (9, 9000, 257)]
    max_err = 0.0
    rows = []
    for m, k, n in shapes:
        x = _pm1(gen, m, k).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        xp = pack_bits(x)
        if name == "xnor":
            vecs = ()
            entry = xg.xnor_matmul_packed
            plain = xg.xnor_gemm_plain
        elif name == "xnor_sign":
            o_row = xg.xnor_gemm_plain(xp[:1], wp, k)[0, :n]
            vecs = _sign_vectors(gen, n, o_row)
            entry = xg.xnor_matmul_packed_sign
            plain = xg.xnor_sign_plain
        else:
            vecs = _affine_vectors(gen, n)
            entry = xg.xnor_matmul_packed_affine
            plain = xg.xnor_affine_plain
        vecs = tuple(v.to(device) for v in vecs)
        got = entry(x, wp, k, n, *vecs)
        want = plain(xp, wp, k, *vecs)[:, :n]
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name} at (M={m}, K={k}, N={n}) differs from its plain "
                f"version: max |diff| = {err}"
            )
        if name == "xnor_sign":
            ties = (torch.arange(n, device=device) % 4 == 0)
            if not bool((got[0][ties] == 1.0).all()):
                raise AssertionError(f"{name}: an exact tie did not give +1")
        if (k, n) != main_kn:
            continue
        vf = tuple(v.to(torch.float32).contiguous() for v in vecs)
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": name, "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(
                lambda: _kernels.xnor_gemm(name, xp, wp, k, n, *vf)),
            "entry_ms": _graph_ms(lambda: entry(x, wp, k, n, *vecs)),
            "plain_ms": _graph_ms(lambda: plain(xp, wp, k, *vecs)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            name, m, k, n)
        rows.append(row)
        print(json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows, max_err


def _unpack_bound(m: int, k: int, n: int):
    """K7's bound: fp32 x, the real weight words and the fp32 output moved
    once; 2*M*N*K fp32-accurate operations at the fastest rate for them,
    which with ±1 weights includes bf16 on the tensor cores over three."""
    nbytes = 4 * (m * k + -(-k // 32) * n + m * n)
    return _roofline(nbytes, 2.0 * m * n * k, {
        **FP32_RATES, "3xbf16 tensor cores": H100_BF16_OPS_PER_S / 3})


def unpack_phase(device: torch.device, gen: torch.Generator):
    """K7 against its plain version: ``torch.equal`` on ±1 x at the LM
    path's shapes, ragged and multi-chunk ones; rtol 1e-5 on real x; two
    runs bitwise equal. Returns (timing rows at the prefill shape and at
    M = 1 and 64, the prefill row first; largest |diff| on ±1 x)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg

    shapes = [(m, k, n) for m in (1, LM_CHUNK, 64) for k, n in LM_PROJ]
    shapes += [(17, 100, 130), (LM_CHUNK, 4160, 257)]
    max_err = 0.0
    for m, k, n in shapes:
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        x = _pm1(gen, m, k).to(device)
        got = xg.xnor_matmul_fused_unpack(x, wp, k, n)
        want = xg.fused_unpack_plain(x, wp, k, n)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"xnor_unpack at (M={m}, K={k}, N={n}) on ±1 x differs "
                f"from its plain version: max |diff| = {err}"
            )
        # Real x: both sum in fp32 in other orders. An entry that cancels
        # to near 0 keeps no relative precision, so the absolute term is
        # rtol times the typical size of an entry (sqrt(K) for unit x).
        xr = torch.randn(m, k, generator=gen).to(device)
        got_r = xg.xnor_matmul_fused_unpack(xr, wp, k, n)
        want = xg.fused_unpack_plain(xr, wp, k, n)
        torch.testing.assert_close(got_r, want, rtol=1e-5,
                                   atol=1e-5 * k ** 0.5)
        again = (xg.xnor_matmul_fused_unpack(x, wp, k, n),
                 xg.xnor_matmul_fused_unpack(xr, wp, k, n))
        torch.cuda.synchronize()
        if not (torch.equal(again[0], got) and torch.equal(again[1], got_r)):
            raise AssertionError(
                f"xnor_unpack at (M={m}, K={k}, N={n}): two runs differ")
    rows = []
    _, k, n = KERNEL_ROWS["xnor_unpack"][2]
    for m in (LM_CHUNK, 1, 64):
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        x = _pm1(gen, m, k).to(device)
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": "xnor_unpack", "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(lambda: _kernels.xnor_unpack(x, wp, k, n)),
            "plain_ms": _graph_ms(lambda: xg.fused_unpack_plain(x, wp, k, n)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _unpack_bound(
            m, k, n)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows, max_err


def _paged_case(gen, device, s, c, qpos, tables, num_pages, h=4, d=64):
    """Pools full of random rows (every page, the null page included,
    holds another sequence's old K/V), queries (S, C, H, D)."""
    k_pool = torch.randn(num_pages, LM_PAGE, h, d, generator=gen)
    v_pool = torch.randn(num_pages, LM_PAGE, h, d, generator=gen)
    q = torch.randn(s, c, h, d, generator=gen)
    return [t.to(device) for t in (
        q, torch.as_tensor(qpos, dtype=torch.int32), k_pool, v_pool,
        torch.as_tensor(tables, dtype=torch.int32))]


def _paged_bound(qpos: torch.Tensor, n_table: int, h: int, d: int):
    """Least time of one paged-attention call: q and the output once,
    and each slot's K/V rows at positions <= its largest query position
    (not the whole table); 4*H*D fp32-accurate operations per (query,
    visible key)."""
    s, c = qpos.shape
    keys = (qpos.max(dim=1).values + 1).clamp(max=n_table * LM_PAGE)
    nbytes = 4 * (2 * s * c * h * d + 2 * int(keys.sum()) * h * d)
    visible = (qpos + 1).clamp(min=0, max=n_table * LM_PAGE)
    flops = 4.0 * h * d * int(visible.sum())
    return _roofline(nbytes, flops, FP32_RATES)


def paged_phase(device: torch.device, gen: torch.Generator):
    """K8's three entries against the gather path (the plain versions)
    on the card, atol = rtol = 1e-5, over page boundaries, scrambled
    tables, reused pages, null pages and positions up to 255 with P = 16;
    then decode timings at a full (qpos 255) and a short (qpos 20)
    context. Returns (timing rows, largest |diff|)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import paged_kv as pk

    num_pages, n_table = LM_SLOTS * 16 + 1, 16
    alloc = pk.PageAllocator(num_pages)
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    tables = torch.zeros(LM_SLOTS, n_table, dtype=torch.int32)
    tables[0] = perm[:16]                         # full: positions 0..255
    tables[1, :2] = perm[16:18]                   # 17 positions
    tables[2, :1] = perm[18:19]                   # one page
    # slot 3 stays all null: an inactive slot at position 0
    first = alloc.alloc(5)
    alloc.free(first)
    reused = torch.as_tensor(alloc.alloc(5)[::-1], dtype=torch.int32)
    max_err = 0.0

    def check(what, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not (torch.isfinite(got).all() and torch.allclose(
                got, want, atol=1e-5, rtol=1e-5)):
            raise AssertionError(f"paged_attn {what}: max |diff| = {err}")

    # decode, S = 4, C = 1, at page boundaries and the last position
    for pos in ([255, 16, 15, 0], [15, 0, 3, 0], [128, 10, 0, 0]):
        q, qpos, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 1,
                                          [[p] for p in pos], tables,
                                          num_pages)
        check(f"decode {pos}",
              pk.paged_attention_kernel(q[:, 0], kp, vp, tb, qpos[:, 0]),
              pk.paged_attention(q[:, 0], kp, vp, tb, qpos[:, 0]))
    # prefill, S = 1, C = 16: whole chunks, a ragged last chunk whose
    # padding queries lie past the length, queries past the table's end
    for start, table in ((240, tables[0]), (32, tables[0]), (0, reused),
                         (72, reused)):
        qp = list(range(start, start + LM_CHUNK))
        q, qpos, kp, vp, tb = _paged_case(gen, device, 1, LM_CHUNK, [qp],
                                          table[None], num_pages)
        check(f"prefill start {start}",
              pk.paged_prefill_attention_kernel(q[0], kp, vp, tb[0], qpos[0]),
              pk.paged_prefill_attention(q[0], kp, vp, tb[0], qpos[0]))
    # verify, S = 4, C = 4: windows straddling page boundaries
    base = torch.as_tensor([252, 14, 13, 0], dtype=torch.int32)
    q, _, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 4, [[0] * 4] * 4,
                                   tables, num_pages)
    base = base.to(device)
    check("verify", pk.paged_verify_attention_kernel(q, kp, vp, tb, base),
          pk.paged_verify_attention(q, kp, vp, tb, base))

    rows = []
    full = torch.zeros(LM_SLOTS, n_table, dtype=torch.int32)
    for s_ in range(LM_SLOTS):
        full[s_] = perm[16 * s_:16 * s_ + 16]
    for pos in (255, 20):
        q, qpos, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 1,
                                          [[pos]] * LM_SLOTS, full, num_pages)
        h, d = q.shape[2], q.shape[3]
        kc, vc = pk.gather_kv(kp, tb), pk.gather_kv(vp, tb)  # (S, L, H, D)
        mask = (torch.arange(kc.shape[1], device=device)[None, None, :]
                <= qpos[:, :, None])[:, None]                # (S, 1, C, L)
        qs, ks, vs = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        lib = torch.nn.functional.scaled_dot_product_attention
        got = _kernels.paged_attn(q, qpos, kp, vp, tb)
        yard = lib(qs, ks, vs, attn_mask=mask).transpose(1, 2)
        log(f"paged_attn at qpos {pos}: max |diff| to the SDPA yardstick "
            f"{(yard - got).abs().max().item():.3g}")
        row = {
            "kernel": "paged_attn", "s": LM_SLOTS, "c": 1, "p": n_table,
            "qpos": pos,
            "kernel_ms": _graph_ms(
                lambda: _kernels.paged_attn(q, qpos, kp, vp, tb)),
            "plain_ms": _graph_ms(
                lambda: pk.paged_attn_plain(q, qpos, kp, vp, tb)),
            "library_ms": _graph_ms(lambda: lib(qs, ks, vs, attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _paged_bound(
            qpos, n_table, h, d)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows, max_err


def _random_bn_stats(model, gen) -> None:
    """Non-trivial eval statistics: running means and variances on the
    scale of each layer's pre-activations, scales with negative and
    exactly-zero entries, non-zero biases."""
    fan_in = (784, model.hidden[0], model.hidden[1])
    with torch.no_grad():
        for bn, fi in zip((model.bn1, model.bn2, model.bn3), fan_in):
            c = bn.num_features
            bn.running_mean.copy_(torch.randn(c, generator=gen) * fi ** 0.5 / 4)
            bn.running_var.copy_((torch.rand(c, generator=gen) + 0.5) * fi / 4)
            w = torch.randn(c, generator=gen)
            w[::11] = 0.0
            bn.weight.copy_(w)
            bn.bias.copy_(torch.randn(c, generator=gen) * 0.5)


def slice_phase(device: torch.device, gen: torch.Generator,
                model_name: str = "bnn-mlp-large", batch: int = MAIN_M):
    """Freeze, export, load and serve ``model_name``; check every answer.
    Returns (counts of launches in the phase, timing dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client

    model = get_model(model_name, generator=gen)
    _random_bn_stats(model, gen)
    model.eval()
    # Pixels are multiples of 1/256: exact in bf16 and fp32, so the live
    # model's bf16 first layer and the frozen fp32 one give equal sums.
    images = torch.randint(0, 256, (batch, 28, 28, 1), generator=gen) / 256.0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.pt")
        _kernels.reset_launches()
        info = export_packed(model, path)
        fn, _ = load_packed(path, device=device)
        frozen = fn(images)
        live = model.to(device)(images.to(device))
        torch.cuda.synchronize()
        diff = (frozen - live).abs().max().item()
        if not (torch.equal(frozen.argmax(-1), live.argmax(-1))
                and diff <= 1e-4 and frozen.shape == (batch, 10)
                and bool(torch.isfinite(frozen).all())):
            raise AssertionError(
                f"frozen vs live eval: max |diff| = {diff}, argmax equal "
                f"{torch.equal(frozen.argmax(-1), live.argmax(-1))}"
            )
        log(f"frozen == live eval (max |diff| {diff:.3g}); {info}")

        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=batch,
            default_deadline_ms=30000.0, stall_timeout_s=30.0,
        ))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        try:
            code, body = client.healthz(base)
            if code != 200 or json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {code} {body[:200]!r}")
            imgs = images.numpy()
            answers = []
            lat = []
            for i, n_req in enumerate((1, batch, 3, batch, 7)):
                x = np.roll(imgs, -5 * i, axis=0)[:n_req]
                t0 = time.perf_counter()
                code, body = client.predict(base, x.tolist())
                lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"/predict: {code} {body[:200]!r}")
                answers.append((x, json.loads(body)))
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        counts = dict(_kernels.LAUNCHES)
        if not stats["flushed"]:
            raise AssertionError(f"drain did not flush: {stats}")
        # Checked after the counts are read: these predictor calls are
        # the reference, not the path under test.
        for x, out in answers:
            n_req = x.shape[0]
            padded = np.zeros((batch, 28, 28, 1), np.float32)
            padded[:n_req] = x
            want = fn(padded)[:n_req].cpu().numpy()
            got = np.asarray(out["log_probs"], np.float32)
            if out["argmax"] != want.argmax(-1).tolist() \
                    or not np.allclose(got, want, atol=1e-6, rtol=0):
                raise AssertionError(
                    f"/predict of {n_req} differs from the predictor: "
                    f"max |diff| {np.abs(got - want).max()}"
                )
        served = sum(x.shape[0] for x, _ in answers)
        log(f"served {served} examples in {len(answers)} requests, each "
            f"equal to the predictor; drain {stats}")

    x32 = images.to(device)
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, top, _ = _profile_device_ms(lambda: fn(x32))
    t0 = time.perf_counter()
    json.dumps({"images": imgs.tolist()})
    timing = {
        "predict_ms_batch": statistics.median(ms),
        "predict_device_ms_batch": device_ms,
        "predict_device_busy_share": (
            None if device_ms is None else device_ms / statistics.median(ms)
        ),
        "predict_top_device_ms": top,
        "request_ms_median": statistics.median(lat) * 1e3,
        "request_json_encode_ms_batch": (time.perf_counter() - t0) * 1e3,
    }
    return counts, timing


def _profile_device_ms(fn, calls: int = 20, top: int = 6):
    """Device time of one ``fn()`` from ``torch.profiler``: the sum of
    the CUDA kernels' own times over ``calls`` calls, the ``top``
    largest kernels (name, ms per call, launches per call) and the
    kernels launched per call. A ``record_function`` range mirrored on
    the device timeline (the optimizer's step) is no kernel and is left
    out. (None, [], 0) when the profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # One warm-up call inside the profiler, not counted: the device trace
    # starts late and would lose the first kernels of the window.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None, [], 0
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total_us = sum(e.self_device_time_total for e in kernels)
    largest = [[e.key[:70], e.self_device_time_total / calls / 1e3,
                e.count / calls] for e in kernels[:top]]
    return (total_us / calls / 1e3, largest,
            sum(e.count for e in kernels) / calls)


def _random_lm_params(model, gen) -> None:
    """Non-zero biases and LayerNorm parameters. At init every bias is 0,
    so every projection's output is an integer: attention scores are
    multiples of 1/8 and tie exactly, a tied pair of opposite values
    cancels to nearly 0, and the sign a binarized projection then takes
    rests on rounding, which differs between any two attention codes.
    A trained model (and this one) has no such ties."""
    from distributed_mnist_bnns_tpu_torch.models.transformer import LayerNorm

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.copy_(1.0 + 0.2 * torch.randn(
                    mod.weight.shape, generator=gen))
                mod.bias.normal_(0.0, 0.2, generator=gen)
            elif getattr(mod, "bias", None) is not None:
                mod.bias.normal_(0.0, 0.5, generator=gen)


def _drive_alone(dec, prompt, n_new: int, chunk_ms=None):
    """Greedy tokens of ``prompt`` through the paged decoder ``dec``
    driven as the engine drives it, with slot 0 active and the other
    slots idle (all-null tables at position 0). ``chunk_ms`` collects
    the host-clock time of each prefill chunk (synchronised)."""
    from distributed_mnist_bnns_tpu_torch.ops.paged_kv import pages_needed

    plen = len(prompt)
    total = min(plen + n_new, dec.max_len)
    table = np.zeros((dec.slots, dec.max_pages), np.int32)
    table[0, :pages_needed(total, dec.page_size)] = np.arange(
        1, 1 + pages_needed(total, dec.page_size))
    pools = dec.init_pools()
    padded = -(-plen // dec.prefill_chunk) * dec.prefill_chunk
    toks = np.zeros(padded, np.int32)
    toks[:plen] = prompt
    for start in range(0, padded, dec.prefill_chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools, lp = dec.prefill(pools, toks[start:start + dec.prefill_chunk],
                                table[0], start, plen)
        torch.cuda.synchronize()
        if chunk_ms is not None:
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
    out = [int(lp[plen - 1 - (padded - dec.prefill_chunk)].argmax())]
    tokens = np.zeros(dec.slots, np.int32)
    positions = np.zeros(dec.slots, np.int32)
    pos = plen
    while len(out) < n_new and pos + 1 <= total - 1:
        tokens[0], positions[0] = out[-1], pos
        pools, lp = dec.decode(pools, tokens, table, positions)
        out.append(int(lp[0].argmax()))
        pos += 1
    return out


def lm_slice_phase(device: torch.device, gen: torch.Generator):
    """Freeze, export and serve the LM; check the paged decoder against
    the contiguous one and every stream against the decoder driven
    alone. Returns (launch counts of the requests, timing dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
    )
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_lm_decoder,
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    model = BinarizedLM(**LM_WIDTH, generator=gen).eval()
    _random_lm_params(model, gen)
    vocab = LM_WIDTH["vocab"]
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in LM_PROMPTS]
    text_i = LM_PROMPTS.index(len(LM_TEXT))
    prompts[text_i] = [b % vocab for b in LM_TEXT.encode("utf-8")]
    seq = torch.randint(0, vocab, (60,), generator=gen).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.pt")
        info = export_packed(model, path)
        frozen = load_frozen(path)
        log(f"LM artifact: {info['frozen_weight_bytes']} packed bytes, "
            f"compression {info['compression']}")

        # Teacher forcing: 48 prompt positions in 3 prefill chunks, then
        # 12 decode steps, against the contiguous decoder position by
        # position (a reference, not the serving path).
        dec = make_paged_lm_decoder(frozen, slots=LM_SLOTS,
                                    page_size=LM_PAGE,
                                    prefill_chunk=LM_CHUNK, device=device)
        pools = dec.init_pools()
        table = np.zeros((dec.slots, dec.max_pages), np.int32)
        table[0, :4] = [7, 3, 11, 5]
        paged = []
        for start in range(0, 48, LM_CHUNK):
            pools, lp = dec.prefill(pools, seq[start:start + LM_CHUNK],
                                    table[0], start, 48)
            paged.append(lp)
        for t in range(48, 60):
            toks = np.zeros(dec.slots, np.int32)
            poss = np.zeros(dec.slots, np.int32)
            toks[0], poss[0] = seq[t], t
            pools, lp = dec.decode(pools, toks, table, poss)
            paged.append(lp[:1])
        paged = torch.cat(paged)
        init, step = make_lm_decoder(frozen, device=device)
        caches = init(1)
        ref = []
        for t in range(60):
            caches, lp = step(caches, seq[None, t], t)
            ref.append(lp)
        ref = torch.cat(ref)
        torch.cuda.synchronize()
        per_pos = (paged - ref).abs().amax(dim=-1)
        diff = per_pos.max().item()
        agree = (paged.argmax(-1) == ref.argmax(-1)).float().mean().item()
        # A sign flipped by a last-ulp attention difference moves a whole
        # position's log-probs, so the limit holds position by position,
        # with the same room as the argmax: 95% of positions within 1e-3.
        close = (per_pos <= 1e-3).float().mean().item()
        print(json.dumps({"lm_teacher_forced": 60,
                          "max_abs_logprob_diff": diff,
                          "share_within_1e-3": close,
                          "argmax_agreement": agree}), flush=True)
        if not (bool(torch.isfinite(paged).all()) and agree >= 0.95
                and close >= 0.95):
            raise AssertionError(
                f"paged vs contiguous decoder: argmax agreement {agree}, "
                f"positions within 1e-3 {close}, max |diff| {diff}, "
                f"finite {bool(torch.isfinite(paged).all())}"
            )

        srv = LMServer(LMServeConfig(
            artifact=path, device=str(device), port=0, slots=LM_SLOTS,
            page_size=LM_PAGE, prefill_chunk=LM_CHUNK,
        ))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        results = [None] * len(prompts)

        def ask(i):
            body = LM_TEXT if i == text_i else prompts[i]
            t0 = time.perf_counter()
            code, resp = lc.open_stream(base, body,
                                        max_new_tokens=LM_NEW_TOKENS,
                                        deadline_ms=120000.0)
            events, stamps = [], []
            if code == 200:
                for ev in lc.iter_lines(resp):
                    events.append(ev)
                    stamps.append(time.perf_counter())
            results[i] = (code, events, t0, stamps)

        try:
            code, body = lc.healthz(base)
            if code != 200 or json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {code} {body[:200]!r}")
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(len(prompts))]
            _kernels.reset_launches()
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            counts = dict(_kernels.LAUNCHES)
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        eng = srv.engine
        if not stats["flushed"] or eng.allocator.free_count() \
                != eng.allocator.capacity:
            raise AssertionError(f"drain left pages in use: {stats}")
        log(f"served {len(prompts)} concurrent streams; drain {stats}")

        # Checked after the counts are read: these calls are the
        # reference, not the path under test.
        chunk_ms = []
        ttft, per_token = [], []
        for i, prompt in enumerate(prompts):
            code, events, t0, stamps = results[i]
            if code != 200 or not events or not events[-1].get("done") \
                    or events[-1]["status"] != "ok":
                raise AssertionError(f"stream {i}: {code} {events[-1:]}")
            got = [ev["token"] for ev in events[:-1]]
            want = _drive_alone(
                dec, prompt, LM_NEW_TOKENS,
                chunk_ms if len(prompt) == max(LM_PROMPTS) else None,
            )
            if got != want:
                raise AssertionError(
                    f"stream {i} (prompt {len(prompt)}) differs from the "
                    f"decoder driven alone:\n{got}\n{want}"
                )
            ttft.append((stamps[0] - t0) * 1e3)
            per_token.append((stamps[-2] - stamps[0]) * 1e3 / (len(got) - 1))
        log("every stream equals the decoder driven alone")

        # Device time of one decode iteration with every slot active and
        # of one prefill chunk.
        pools = dec.init_pools()
        tables = np.zeros((dec.slots, dec.max_pages), np.int32)
        tables[:, :8] = np.arange(1, 1 + 8 * dec.slots).reshape(dec.slots, 8)
        toks = np.arange(dec.slots, dtype=np.int32)
        poss = np.full(dec.slots, 100, np.int32)
        decode_ms, decode_top, _ = _profile_device_ms(
            lambda: dec.decode(pools, toks, tables, poss))
        chunk = np.arange(LM_CHUNK, dtype=np.int32)
        prefill_ms, prefill_top, _ = _profile_device_ms(
            lambda: dec.prefill(pools, chunk, tables[0], 96, 112))
    iter_ms = list(eng.iter_ms)
    timing = {
        "decode_iteration_ms_median": statistics.median(iter_ms),
        "decode_iterations": len(iter_ms),
        "decode_device_ms": decode_ms,
        "decode_top_device_ms": decode_top,
        "prefill_chunk_ms_median": statistics.median(chunk_ms),
        "prefill_chunk_device_ms": prefill_ms,
        "prefill_top_device_ms": prefill_top,
        "ttft_ms_median": statistics.median(ttft),
        "per_token_ms_median": statistics.median(per_token),
    }
    if decode_ms is not None:
        timing["decode_device_busy_share"] = (
            decode_ms / timing["decode_iteration_ms_median"])
    if prefill_ms is not None:
        timing["prefill_device_busy_share"] = (
            prefill_ms / timing["prefill_chunk_ms_median"])
    return counts, timing


def _flash_bound(name: str, b: int, h: int, lq: int, lk: int, d: int,
                 causal: bool):
    """Least time (ms) of one flash kernel's work: its operands read once
    and its outputs written once against HBM bandwidth, and 4D (K4), 6D
    (K5) or 8D (K6) fp32-accurate operations per unmasked (query, key)
    pair at the faster of ``FP32_RATES``."""
    if causal:
        pairs = sum(min(lk, i + lk - lq + 1) for i in range(lq))
    else:
        pairs = lq * lk
    pairs *= b * h
    qd, kd, rows = b * h * lq * d, b * h * lk * d, b * h * lq
    words, per_pair = {
        "flash_fwd": (2 * qd + 2 * kd + rows, 4),          # q k v -> out lse
        "flash_bwd_dq": (3 * qd + 2 * kd + 2 * rows, 6),   # q do k v lse c -> dq
        "flash_bwd_dkv": (2 * qd + 4 * kd + 2 * rows, 8),  # -> dk dv
    }[name]
    return _roofline(4 * words, per_pair * d * pairs, FP32_RATES)


def _library_bwd(q, k, v, g_out):
    """A call of the kernel SDPA's autograd runs for an fp32 causal
    backward (PyTorch's memory-efficient attention, CUTLASS) on
    (B, L, H, D) q, k, v, from its own forward's out and lse; it returns
    (dq, dk, dv). Called directly so that a CUDA graph captures it."""
    ops = torch.ops.aten
    lq, lk = q.shape[1], k.shape[1]
    causal_top_left = 1  # equal to bottom-right alignment at Lq == Lk
    out, lse, seed, offset, _, _ = ops._efficient_attention_forward(
        q, k, v, None, None, None, None, None, 0.0, causal_top_left, True)
    return lambda: ops._efficient_attention_backward(
        g_out, q, k, v, None, out, None, None, lq, lk, lse, 0.0, seed,
        offset, causal_top_left, False)[:3]


def _sdpa_kernels(qs, ks, vs) -> list:
    """Names of the largest CUDA kernels of one causal SDPA forward and
    backward: which of PyTorch's attention backends ran."""
    qs, ks, vs = (x.detach().requires_grad_() for x in (qs, ks, vs))
    lib = torch.nn.functional.scaled_dot_product_attention
    _, top, _ = _profile_device_ms(
        lambda: lib(qs, ks, vs, is_causal=True).sum().backward(), calls=1,
        top=3)
    return [name for name, _, _ in top]


def flash_phase(device: torch.device, gen: torch.Generator):
    """K4, K5 and K6 against their plain versions at
    ``FLASH_EDGE_SHAPES`` and ``FLASH_SHAPES``; two runs bitwise equal;
    timings at the training width. Returns ({kernel: timing row},
    {kernel: largest |diff|})."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import flash_attention as fa

    max_err = dict.fromkeys(FLASH, 0.0)

    def check(name, got, want, tol):
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        max_err[name] = max(max_err[name], err)
        for g, w in zip(got, want):
            if not (bool(torch.isfinite(g).all())
                    and torch.allclose(g, w, **tol)):
                raise AssertionError(
                    f"{name} at {shape} differs from its plain version: "
                    f"max |diff| = {err}")

    for shape in FLASH_EDGE_SHAPES + FLASH_SHAPES:
        b, h, lq, lk, d, causal = shape
        q, k, v, g_out = (torch.randn(b, n, h, d, generator=gen).to(device)
                          for n in (lq, lk, lk, lq))
        g_lse = (0.5 * torch.randn(b, lq, h, generator=gen)).to(device)
        out, lse = _kernels.flash_fwd(q, k, v, causal)
        check("flash_fwd", (out, lse), fa.flash_fwd_plain(q, k, v, causal),
              dict(atol=2e-5, rtol=2e-5))
        coeff = (g_lse - (g_out * out).sum(dim=-1)).contiguous()
        args = (q, k, v, g_out, lse, coeff, causal)
        dq = _kernels.flash_bwd_dq(*args)
        dk, dv = _kernels.flash_bwd_dkv(*args)
        check("flash_bwd_dq", (dq,), (fa.flash_bwd_dq_plain(*args),),
              FLASH_GRAD_TOL)
        check("flash_bwd_dkv", (dk, dv), fa.flash_bwd_dkv_plain(*args),
              FLASH_GRAD_TOL)
        again = (*_kernels.flash_fwd(q, k, v, causal),
                 _kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y)
                   for x, y in zip((out, lse, dq, dk, dv), again)):
            raise AssertionError(f"flash kernels at {shape}: two runs differ")
        log(f"flash {shape}: K4/K5/K6 within tolerance of their plain "
            f"versions, two runs bitwise equal")

    # Timings at the training width (the last shape's tensors). The
    # library backward is the call SDPA's autograd makes, checked against
    # autograd's gradients so that the graph times the same work.
    lib = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gos = g_out.transpose(1, 2).contiguous()
    qg, kg, vg = (x.detach().requires_grad_() for x in (qs, ks, vs))
    want = torch.autograd.grad(lib(qg, kg, vg, is_causal=True),
                               (qg, kg, vg), gos)
    lib_bwd = _library_bwd(q, k, v, g_out)
    got = lib_bwd()
    lib_err = max((g.transpose(1, 2) - w).abs().max().item()
                  for g, w in zip(got, want))
    port_err = max((g - w).abs().max().item() for g, w in zip(
        got, fa._backward(q, k, v, out, lse, g_out, torch.zeros_like(lse),
                          causal)))
    log(f"library backward: max |diff| {lib_err:.3g} to SDPA's autograd, "
        f"{port_err:.3g} to the port's (g_lse = 0)")
    if not all(torch.allclose(g.transpose(1, 2), w, **FLASH_GRAD_TOL)
               for g, w in zip(got, want)):
        raise AssertionError(f"the library backward is not SDPA's: {lib_err}")
    lib_bwd_ms = _graph_ms(lib_bwd, iters=20, reps=10)
    sdpa = _sdpa_kernels(qs, ks, vs)
    log(f"SDPA (fp32, causal) ran: {sdpa}")
    plain = {
        "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, causal),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(*args),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(*args),
    }
    kernel = {
        "flash_fwd": lambda: _kernels.flash_fwd(q, k, v, causal),
        "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(*args),
        "flash_bwd_dkv": lambda: _kernels.flash_bwd_dkv(*args),
    }
    rows = {}
    for name in FLASH:
        row = {
            "kernel": name, "b": b, "h": h, "lq": lq, "lk": lk, "d": d,
            "causal": causal,
            "kernel_ms": _graph_ms(kernel[name], iters=20, reps=10),
            "plain_ms": _graph_ms(plain[name], iters=5, reps=5),
            "library_ms": (_graph_ms(lambda: lib(qs, ks, vs, is_causal=True),
                                     iters=20, reps=10)
                           if name == "flash_fwd" else lib_bwd_ms),
            "library": ("scaled_dot_product_attention forward"
                        if name == "flash_fwd" else
                        "memory-efficient attention backward (dq, dk, dv)"),
            "sdpa_kernels": sdpa,
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _flash_bound(
            name, *shape)
        rows[name] = row
        print(json.dumps(row), flush=True)
    # The port's whole backward as the training step runs it: coeff, K5
    # and K6, against the library's.
    total = {
        "kernel": "flash_bwd_total", "b": b, "h": h, "lq": lq, "lk": lk,
        "d": d, "causal": causal,
        "kernel_ms": _graph_ms(lambda: fa._backward(
            q, k, v, out, lse, g_out, g_lse, causal), iters=20, reps=10),
        "library_ms": lib_bwd_ms,
        "library": "memory-efficient attention backward (dq, dk, dv)",
        "bound_ms": sum(rows[n]["bound_ms"] for n in FLASH[1:]),
    }
    total["vs_library"] = total["kernel_ms"] / total["library_ms"]
    print(json.dumps(total), flush=True)
    return rows, max_err


def lm_train_phase(device: torch.device, gen: torch.Generator):
    """Flash vs exact-softmax step parity (loss and gradients), then 20
    steps through ``examples.lm_demo.run`` with export, twice from one
    seed, its artifact against the trained model, and step timings. Returns (launch counts of the run,
    timing dict)."""
    import copy

    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import (
        BinarizedLM,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.models.transformer import (
        embed_weight_grad,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    vocab, draw = lm_demo.token_stream(LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                       LM_TRAIN["vocab"], seed=0)
    toks = torch.from_numpy(draw()).to(device)

    # One step with each attention from the same weights and batch.
    models = {}
    for att in ("flash", "xla"):
        if not models:
            m = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention=att,
                            generator=gen)
            _random_lm_params(m, gen)
            state = copy.deepcopy(m.state_dict())
        else:
            m = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention=att)
            m.load_state_dict(state)
        models[att] = m.to(device)
    losses, grads = {}, {}
    for att, m in models.items():
        opt = lm_demo.make_optimizer(m, LM_TRAIN_LR)
        losses[att] = float(lm_demo.train_step(
            m, opt, list(latent_clamp_mask(m).values()), toks))
        grads[att] = {n: p.grad for n, p in m.named_parameters()}
    pf = dict(models["flash"].named_parameters())
    n_far = n_all = 0
    for name, p in models["xla"].named_parameters():
        n_far += int(((p - pf[name]).abs() > 1e-5).sum())
        n_all += p.numel()
    rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    # The gradients of that step: K5 and K6 recompute the scores in 3xTF32
    # against K4's lse of exact fp32 scores, autograd differentiates the
    # exact softmax. Each parameter's gradient is held to LM_GRAD_RTOL in
    # relative L2 norm, except the key bias's: adding a vector to every
    # key moves each query row's scores by one constant, so its exact
    # gradient is 0 and both sides give rounding noise (printed).
    grad_rel = {n: ((grads["flash"][n] - g).norm() / g.norm()).item()
                for n, g in grads["xla"].items()}
    held = {n: r for n, r in grad_rel.items()
            if not n.endswith("attn.k.bias")}
    worst = max(held, key=held.get)
    flat = {att: torch.cat([g.flatten() for g in gs.values()])
            for att, gs in grads.items()}
    key_bias = {att: sum(g.norm().item() for n, g in gs.items()
                         if n.endswith("attn.k.bias"))
                for att, gs in grads.items()}
    print(json.dumps({
        "lm_train_step_parity": losses, "loss_rel_diff": rel,
        "share_params_over_1e-5": n_far / n_all,
        "grad_rel_l2_worst": [worst, held[worst]],
        "grad_rel_l2_all": ((flat["flash"] - flat["xla"]).norm()
                            / flat["xla"].norm()).item(),
        "key_bias_grad_l2": key_bias}), flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"flash vs xla step: losses {losses}")
    if not held[worst] <= LM_GRAD_RTOL:
        raise AssertionError(
            f"flash vs xla step: {worst}'s gradient differs by "
            f"{held[worst]} (relative L2) > {LM_GRAD_RTOL}")
    del models, grads, flat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_trained.pt")
        _kernels.reset_launches()
        res = lm_demo.run(
            steps=LM_TRAIN_STEPS, seq_len=LM_TRAIN_SEQ,
            batch=LM_TRAIN_BATCH, lr=LM_TRAIN_LR, seed=0, attention="flash",
            log_every=1, export=path, device=device, **LM_TRAIN,
        )
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
        hist = res.history
        if not (len(hist) == LM_TRAIN_STEPS and all(np.isfinite(hist))
                and hist[-1] < hist[0]):
            raise AssertionError(f"training losses: {hist}")
        want = LM_TRAIN["depth"] * LM_TRAIN_STEPS
        if any(counts[name] != want for name in FLASH):
            raise AssertionError(
                f"flash launches {[counts[n] for n in FLASH]}, want {want}")
        log(f"trained {LM_TRAIN_STEPS} steps: loss {hist[0]:.4f} -> "
            f"{hist[-1]:.4f}; flash launches {want} each")
        again = lm_demo.run(
            steps=LM_TRAIN_STEPS, seq_len=LM_TRAIN_SEQ,
            batch=LM_TRAIN_BATCH, lr=LM_TRAIN_LR, seed=0, attention="flash",
            log_every=1, device=device, **LM_TRAIN,
        ).history
        print(json.dumps({"lm_train_runs_bitwise_equal": again == hist,
                          "loss_history_second_run": again}), flush=True)
        if again != hist:
            raise AssertionError(
                f"two training runs from seed 0 differ:\n{hist}\n{again}")
        log("a second run from seed 0 gave a bitwise-equal loss history")

        # What the bitwise-equal runs cost: the token embedding's weight
        # gradient as the model computes it (one-hot product) against
        # PyTorch's embedding backward, which is not bitwise equal from run
        # to run, at the step's shape.
        g = torch.randn(*toks.shape, LM_TRAIN["embed_dim"],
                        generator=gen).to(device)
        n_vocab = LM_TRAIN["vocab"]
        print(json.dumps({"embed_weight_grad_ms": {
            "one_hot": _events_ms(
                lambda: embed_weight_grad(toks, g, n_vocab)),
            "embedding_backward": _events_ms(
                lambda: torch.ops.aten.embedding_dense_backward(
                    g, toks, n_vocab, -1, False))}}), flush=True)

        # The artifact against the trained model in eval mode: the twin
        # with exact-softmax attention runs the frozen forward's own
        # attention code, so it agrees everywhere; the flash model only
        # where no binarized input sits within rounding of 0.
        fn, _ = load_packed(path, device=device)
        model = res.model.eval()
        twin = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention="xla")
        twin.load_state_dict(model.state_dict())
        twin = twin.to(device).eval()
        x = toks[:2]
        with torch.no_grad():
            frozen, live, live_x = fn(x), model(x), twin(x)
        torch.cuda.synchronize()
        d_x = (frozen - live_x).abs().max().item()
        per_pos = (frozen - live).abs().amax(dim=-1)
        close = (per_pos <= 1e-4).float().mean().item()
        agree = (frozen.argmax(-1) == live.argmax(-1)).float().mean().item()
        print(json.dumps({"export_vs_live_xla_max_abs": d_x,
                          "export_vs_live_flash_max_abs":
                              per_pos.max().item(),
                          "export_vs_live_flash_share_within_1e-4": close,
                          "export_vs_live_flash_argmax_agreement": agree}),
              flush=True)
        if not (d_x <= 1e-4 and close >= 0.99 and agree >= 0.99
                and bool(torch.isfinite(frozen).all())):
            raise AssertionError(
                f"exported LM vs the trained model: {d_x}, {close}, {agree}")

    # Step time and device time, continuing from the trained model.
    model = res.model.train()
    opt = lm_demo.make_optimizer(model, LM_TRAIN_LR)
    latents = list(latent_clamp_mask(model).values())
    step = lambda: lm_demo.train_step(model, opt, latents, toks)  # noqa: E731
    ms = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 3:
            ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, top, n_kernels = _profile_device_ms(step, calls=5, top=12)
    step_ms = statistics.median(ms)
    timing = {
        "train_step_ms_median": step_ms,
        "train_tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / step_ms * 1e3,
        "train_step_device_ms": device_ms,
        "train_step_device_busy_share": (
            None if device_ms is None else device_ms / step_ms),
        "train_step_top_device_ms": top,
        "train_step_kernels": n_kernels,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_history": hist,
    }
    return counts, timing


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    built = _kernels.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "sources": built}), flush=True)

    gen = torch.Generator().manual_seed(0)
    results = {}
    for name in ("xnor", "xnor_sign", "xnor_affine"):
        rows, max_err = kernel_phase(name, device, gen)
        m, k, n = KERNEL_ROWS[name][2]
        results[name] = (next(r for r in rows if (r["m"], r["k"], r["n"])
                              == (m, k, n)), max_err)
        torch.cuda.synchronize()
        log(f"{name}: equal to its plain version at every shape")
    unpack_rows, unpack_err = unpack_phase(device, gen)
    results["xnor_unpack"] = (unpack_rows[0], unpack_err)
    log("xnor_unpack: equal to its plain version on ±1 x at every shape, "
        "two runs bitwise equal")
    paged_rows, paged_err = paged_phase(device, gen)
    results["paged_attn"] = (paged_rows[0], paged_err)
    log("paged_attn: within 1e-5 of the gather path at every case")

    mlp_counts, timing = slice_phase(device, gen)
    print(json.dumps({"slice": "bnn-mlp-large", "launches": mlp_counts,
                      **timing}), flush=True)
    for name in ("xnor_sign", "xnor_affine"):
        if mlp_counts[name] == 0:
            raise AssertionError(f"the MLP path never launched {name}")
    lm_counts, lm_timing = lm_slice_phase(device, gen)
    print(json.dumps({"slice": "bnn-lm", "launches": lm_counts,
                      **lm_timing}), flush=True)
    for name in ("xnor", "xnor_unpack", "paged_attn"):
        if lm_counts[name] == 0:
            raise AssertionError(f"the LM path never launched {name}")
    # Prompts of M >= FUSED_UNPACK_MIN_M rows go to K7: every prefill
    # chunk, once per packed projection (4 a block, 2 in its MLP).
    chunks = sum(-(-n // LM_CHUNK) for n in LM_PROMPTS)
    want = chunks * LM_WIDTH["depth"] * 6
    if lm_counts["xnor_unpack"] != want:
        raise AssertionError(
            f"K7 launched {lm_counts['xnor_unpack']} times on the LM path, "
            f"want {want} ({chunks} prefill chunks)")

    flash_rows, flash_err = flash_phase(device, gen)
    for name in FLASH:
        results[name] = (flash_rows[name], flash_err[name])
    log("flash: K4/K5/K6 within tolerance of their plain versions at "
        "every shape")
    train_counts, train_timing = lm_train_phase(device, gen)
    print(json.dumps({"slice": "bnn-lm-train", "launches": train_counts,
                      **train_timing}), flush=True)

    kernels = []
    for name, (replaces, source, _) in KERNEL_ROWS.items():
        row, max_err = results[name]
        if name == "paged_attn":
            shape = [row["s"], row["c"], row["p"], row["qpos"]]
        elif name in FLASH:
            shape = [row["b"], row["h"], row["lq"], row["lk"], row["d"],
                     row["causal"]]
        else:
            shape = [row["m"], row["k"], row["n"]]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (mlp_counts[name] + lm_counts[name]
                         + train_counts[name]),
            "launches_mlp_path": mlp_counts[name],
            "launches_lm_path": lm_counts[name],
            "launches_train_path": train_counts[name],
            "max_abs_err": max_err,
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": row["bound_peak"],
            "library_ms": row["library_ms"],
            "shape": shape,
        }
        print(json.dumps({"kernel": name, "kernel_ms": entry["ms"],
                          "plain_ms": entry["plain_ms"],
                          "library_ms": entry["library_ms"],
                          "launches": entry["launches"]}), flush=True)
        kernels.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
