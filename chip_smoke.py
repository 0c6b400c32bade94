"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. the card: exit non-zero without CUDA; print the card's name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compile every kernel from ``csrc/`` (one ``nvcc`` per
     source, all started together);
  3. kernels: each packed-GEMM kernel (K1 none, K2 sign, K3 affine
     epilogue; each packs fp32 x itself) against its plain PyTorch
     version (``pack_bits`` then the GEMM) on the card, ``torch.equal``,
     at the serving paths' shapes (K1 at every (K, N) of the LM's
     projections and at the MLP's layer 2), at ragged and multi-chunk
     shapes, and with g < 0, g == 0 and exact tie columns: on ±1 x, and
     on raw x with zeros, -0.0, NaN, ±inf and subnormals under both pack
     rules (x > 0; x >= 0, the LM's binarizing K1 entry), two runs
     ``torch.equal``; K1 is timed at M = 1, 4, 16, 32, 64 and 256, each
     row with its entry's time (``entry_ms``);
     K7 (fused bitplane-unpack GEMM, bf16 ``mma.sync`` on an exact
     three-piece split of x) the same way on ±1 x and to rtol 1e-5 on
     real x, two runs bitwise equal; K8 (paged attention) against the
     gather path to atol = rtol = 1e-5 in decode, prefill (16 and 20
     queries) and verify shapes over scrambled, reused and null pages,
     at head dims 64, 36, 7 and 128, then every query of a 4-slot decode
     call and of two 16-query prefill chunks against the same query
     launched alone, and two runs, ``torch.equal``. Then CUDA-graph
     timings of each kernel at its main path's shapes (K7 also at M = 1
     and 64; K8 at decode, prefill and verify), its plain version, one
     PyTorch library call computing the same function, and the bound;
     and the floor under any launch, an in-place add on one element
     (``launch_floor_ms``);
  4. MLP slice: ``bnn-mlp-large`` at full width (784-3072-1536-768-10)
     from a seeded ``torch.Generator`` with random BN statistics,
     frozen, exported, ``load_packed`` on ``cuda``, checked against the
     live eval model, then served by the port's HTTP server (batch 32)
     and queried through the port's client; the launch counters are
     zeroed just before this phase and read just after it. Then the
     frozen predictor's time per batch of 32 on the host clock and, from
     ``torch.profiler``, its device time, kernel launches and largest
     kernels;
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
     K1 24 times (4 blocks x 6 projections) per decode iteration, K7 24
     times per prefill chunk and K8 once a layer per decode iteration and
     per prefill chunk. Then decode-iteration and prefill-chunk times,
     device time and kernel launches from ``torch.profiler``, and the
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
     ``torch.profiler``;
  8. MLP training: ``train.Trainer`` trains ``bnn-mlp-large`` (Adam
     0.01, batch 64, seed 0, backend bf16, dropout 0.3) one epoch of the
     synthetic 60,000/10,000 split (937 steps), evaluated before and
     after: every logged loss finite, the epoch's train loss below the
     first logged one, test accuracy above 55 and up by 20 points (the
     JAX package's convergence test). The trained model is checkpointed,
     exported through ``cli export --checkpoint-dir`` and served by
     ``load_packed`` on a batch of 32 (K2 and K3, counted) against the
     live eval model: argmax equal, log-probs within 1e-4. Two runs of 50
     steps from one seed with dropout give bitwise-equal loss histories
     and parameters. 20 steps on each of the xla, int8, xnor and
     pallas_xnor backends (dropout 0) give bitwise-equal loss histories
     and parameters, and the pallas_xnor run launches K1 exactly 40
     times (layers 2 and 3; layer 1 runs xla). Then the step time and
     examples per second on the host clock twice: of the epoch above,
     in this process after phases 1-7, and of the same training (seed
     0, one epoch) run through ``cli train`` in a process of its own,
     which must also converge; and the device time, kernels per step and
     busy share (against both step times) of a bf16 and a pallas_xnor
     step from ``torch.profiler``, K1's share beside the cuBLAS GEMMs.
     The first is the step in a process that has run phases 1-7
     (``torch.profiler`` sessions, objects left alive); the second is
     the step a user of ``cli train`` sees
     (``scripts/torch_mlp_train_timing.py`` times the step before and
     after each earlier phase);
  9. data-parallel MLP training (``parallel/``, ``train.Trainer`` with
     ``data_parallel``; ``MLP_TRAIN`` with dropout 0): (a) one NCCL rank
     a card, 50 steps of the 1-bit exchange with error feedback
     (``sign_ef``): every rank's state bitwise equal, and at world 1
     equal to a single-process ``Trainer(grad_compress="sign_ef")``;
     then ``cli train --dp auto --grad-compress sign_ef`` one epoch in a
     process of its own, which must converge; (b) 4 gloo ranks sharing
     card 0 (16 rows each of the global batch of 64): the first 300
     steps of the epoch (``DP_EPOCH_STEPS``) uncompressed (global-batch
     BatchNorm, DDP) and again with ``sign_ef``, each passing phase 8's
     convergence thresholds (which 300 steps in one process meet too,
     checked beside), ``sign_ef`` within 2 points of the uncompressed
     run, then 200 steps of ``sign`` (majority vote, lr 0.001); (c) 20
     steps of (b)'s ``sign_ef`` on pallas_xnor and on xla (bf16 rounds
     layer 1's raw pixels, which the ±1 backends take in fp32), bitwise
     equal, K1 launched exactly 2 x 20 times in every rank (counted in
     each rank, zeroed just before the run); (d) 20 steps of the
     two-level exchange (2 hosts x 2). In every run the ranks end
     bitwise equal, every logged loss is finite, and each rank's wire
     bytes per step, measured from the buffers its collectives were
     handed, equal ``CommPlan.wire_bytes_per_step`` (the fp32 plan
     uncompressed; ``HierPlan``'s intra and inter bytes in (d)). Each
     run prints its step time on the host clock, examples per second,
     the exchange's time per step from CUDA events around the
     optimizer's transform and the wire bytes;
 10. the conv families: (a) K1 against its plain version, ``torch.equal``,
     on ±1 x and on patches with zero taps, two runs equal, at the conv
     path's shapes (``CNN_K1_SHAPES``: conv2's patch GEMM (B*196, 576,
     128) and the dense layer (B, 6272, 1024; 196 words, packed to 256)
     at batch 32 and 64), each timed in a CUDA graph beside its plain
     version, bf16 ``torch.matmul`` and its bound; (b) ``bnn-cnn`` at
     its defaults (widths 64, 128, hidden 1024) trained through
     ``train.Trainer`` on bf16 for the 200 steps of a synthetic
     12,800/2,048 split (loss falls, test accuracy above 55 and up 20
     points), two bf16 runs of 30 steps bitwise equal, 20 steps each on
     xla, xnor and pallas_xnor from one seed (K1 exactly twice a
     pallas_xnor step, the counters zeroed just before and read just
     after; pallas_xnor and xnor, one lowering, bitwise equal; the
     trained model's logits on pallas_xnor equal to those on xla), and
     each step's device time, kernels and K1 time from ``torch.profiler``;
     (c) the trained model through ``cli export --checkpoint-dir``,
     ``load_packed`` on the card against the live model (first conv
     fp32; argmax equal, atol 1e-4; K1 exactly twice a batch), served
     over HTTP at batch 32 (K1 twice per predictor batch, the warm-up
     included; every answer equal to the predictor), with the
     predictor's host and device time a batch; (d) ``convnet`` and
     ``deep-cnn``, 200 steps each at fp32 and at bf16 (the loss falls),
     step and device times, then ``scripts/torch_conv_fp32_check.py`` in
     a process of its own: ``cli train --model convnet``, which sets no
     TF32 flag, must give conv outputs within fp32 rounding of a float64
     conv; (e) 20 steps of ``convnet`` uncompressed and of ``bnn-cnn``
     with ``sign_ef`` on pallas_xnor over 2 gloo ranks sharing card 0
     (and ``convnet`` over NCCL, one rank a card, where there are two or
     more cards): ranks bitwise equal, wire bytes a step equal to the
     plan's, K1 twice a step in each rank. K1's launches on these paths
     enter the kernels line as ``launches_conv_path``, and its conv-shape
     rows as ``conv_shapes``.

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
# MLP training: the flagship's MIGRATION.md recipe, one epoch of the
# synthetic 60,000/10,000 split (937 steps of 64).
MLP_TRAIN = dict(model="bnn-mlp-large", batch_size=64, optimizer="adam",
                 learning_rate=0.01, seed=0)
MLP_SYNTH = (60000, 10000)
MLP_DET_STEPS = 50          # two runs from one seed, dropout on
MLP_BACKEND_STEPS = 20      # per backend, dropout 0, deterministic signs
MLP_TRAIN_BACKENDS = ("xla", "int8", "xnor", "pallas_xnor")
# the JAX test_trainer_end_to_end_convergence thresholds
MLP_MIN_ACC, MLP_MIN_GAIN = 55.0, 20.0
# Data-parallel training (phase 9): MLP_TRAIN, dropout 0.
DP_NCCL_STEPS = 50          # (a) sign_ef, one NCCL rank a card
DP_GLOO_RANKS = 4           # (b)-(d) gloo ranks sharing card 0: 16 rows each
# (b) the epoch cut to its first 300 steps: the whole 937 took phase 9
# to 366 s on an H100 80GB HBM3 at 700 W (gloo moves each collective
# through the host; the uncompressed step took 130 ms, the sign_ef one
# 107). Phase 8's convergence thresholds hold, and 300 single-process
# steps must meet them too (checked beside).
DP_EPOCH_STEPS = 300
DP_SIGN_STEPS, DP_SIGN_LR = 200, 0.001   # (b) majority vote (JAX's lr)
DP_SHORT_STEPS = 20         # (c) K1 under DP, (d) two-level
DP_HOSTS = 2                # (d) 2 hosts x 2 local ranks
# Conv families (phase 10): bnn-cnn at its defaults (widths 64, 128,
# hidden 1024); K1 at its serving (batch 32) and training (batch 64)
# shapes: conv2's patch GEMM (B*196, 9*64, 128), the dense layer (B,
# 49*128, 1024).
CNN_BATCH = 64
CNN_K1_SHAPES = tuple((b * m, k, n) for b in (MAIN_M, CNN_BATCH)
                      for m, k, n in ((196, 576, 128), (1, 6272, 1024)))
CNN_TRAIN = dict(model="bnn-cnn", batch_size=CNN_BATCH, optimizer="adam",
                 learning_rate=0.01, seed=0)
CNN_SYNTH = (12800, 2048)   # 200 steps of 64; a test split of 2048
CNN_DET_STEPS = 30          # two bf16 runs from one seed
CNN_BACKEND_STEPS = 20      # xla, xnor and pallas_xnor
CNN_FP_STEPS = 200          # convnet and deep-cnn at fp32 and bf16
CNN_DP_STEPS = 20           # 2 gloo ranks sharing card 0
_GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS kernels

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
    """K1-K3's bound: the fp32 x (4*M*K bytes: the kernels take the
    activations as they are and pack them themselves, so the bits are not
    an input any more) and the real weight words read once, the epilogue
    vectors read once, the fp32 output written once; 2*M*N*K ±1
    operations at the int8 tensor-core peak."""
    kw = -(-k // 32)
    vecs = 0 if name == "xnor" else 3
    nbytes = 4 * (m * k + kw * n + vecs * n + m * n)
    return _roofline(nbytes, 2.0 * m * n * k,
                     {"int8 tensor cores": H100_INT8_OPS_PER_S})


def _raw_x(gen: torch.Generator, m: int, k: int) -> torch.Tensor:
    """Real x holding exact zeros, -0.0, NaN, ±inf and ±subnormals: where
    the two pack rules and the sign of zero differ."""
    x = torch.randn(m, k, generator=gen)
    flat = x.view(-1)
    for i, val in enumerate((0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 1e-40, -1e-40)):
        flat[i::7 + 2 * i] = val
    return x


def kernel_phase(name: str, device: torch.device, gen: torch.Generator):
    """Compare packed-GEMM kernel ``name`` (K1-K3) with its plain
    version at every listed shape, on ±1 x and on raw x under both pack
    rules, two runs each; time it at the main paths' (K, N). Returns the
    timing rows and the largest absolute difference seen."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.binarize import _sign_pm1
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    main_m, *main_kn = KERNEL_ROWS[name][2]
    main_kn = tuple(main_kn)
    ms = sorted({1, main_m, MAIN_M, 256} | ({16, 64} if name == "xnor"
                                            else set()))
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
        vf = tuple(v.to(torch.float32).contiguous() for v in vecs)
        xr = _raw_x(gen, m, k).to(device)
        # (what, the kernel's output, its plain version's): the entry on
        # ±1 x, then the kernel on raw x under each pack rule
        cases = [("±1 x", entry(x, wp, k, n, *vecs),
                  plain(xp, wp, k, *vecs)[:, :n])]
        for rule, bits in ((_kernels.PACK_GT0, xr),
                           (_kernels.PACK_GE0, _sign_pm1(xr))):
            cases.append((f"raw x, rule {rule}",
                          _kernels.xnor_gemm(name, xr, wp, k, n, *vf,
                                             rule=rule),
                          plain(pack_bits(bits), wp, k, *vecs)[:, :n]))
        if name == "xnor":   # the LM decoder's entry: x >= 0 packed in K1
            cases.append(("raw x, binarizing entry",
                          xg._xnor_matmul_binarize(xr, wp, k, n),
                          plain(pack_bits(_sign_pm1(xr)), wp, k)[:, :n]))
        again = [entry(x, wp, k, n, *vecs)] + [
            _kernels.xnor_gemm(name, xr, wp, k, n, *vf, rule=rule)
            for rule in (_kernels.PACK_GT0, _kernels.PACK_GE0)]
        torch.cuda.synchronize()
        for what, got_c, want in cases:
            err = (got_c - want).abs().nan_to_num(0.0).max().item()
            max_err = max(max_err, err)
            if not torch.equal(got_c, want):
                raise AssertionError(
                    f"{name} at (M={m}, K={k}, N={n}) on {what} differs "
                    f"from its plain version: max |diff| = {err}"
                )
        for (what, first, _), second in zip(cases, again):
            if not torch.equal(first, second):
                raise AssertionError(
                    f"{name} at (M={m}, K={k}, N={n}) on {what}: two runs "
                    f"differ")
        got = cases[0][1]
        if name == "xnor_sign":
            ties = (torch.arange(n, device=device) % 4 == 0)
            if not bool((got[0][ties] == 1.0).all()):
                raise AssertionError(f"{name}: an exact tie did not give +1")
        if (k, n) != main_kn:
            continue
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": name, "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(
                lambda: _kernels.xnor_gemm(name, x, wp, k, n, *vf)),
            "entry_ms": _graph_ms(lambda: entry(x, wp, k, n, *vecs)),
            "plain_ms": _graph_ms(
                lambda: plain(pack_bits(x), wp, k, *vecs)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        if name == "xnor":
            row["binarize_entry_ms"] = _graph_ms(
                lambda: xg._xnor_matmul_binarize(x, wp, k, n))
        row["tiling"] = list(_kernels.xnor_tiling(m, k, n))
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
    tables, reused pages, null pages and positions up to 255 with P = 16,
    at the LM's head dim and at D = 36, 7 and 128 (the kernel's other
    instances and its 4-byte copies); then every query of a 4-slot decode
    call and of a 16-query prefill chunk against the same query launched
    alone, and two runs, bitwise; then timings at every shape the LM
    path gives K8: decode at a full (qpos 255) and a short (qpos 20)
    context, prefill chunks at positions 240-255 and 32-47, verify
    windows of 4. Returns (timing rows, largest |diff|), the decode row
    at qpos 255 first."""
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
    full = torch.zeros(LM_SLOTS, n_table, dtype=torch.int32)
    for s_ in range(LM_SLOTS):
        full[s_] = perm[16 * s_:16 * s_ + 16]
    max_err = 0.0

    def check(what, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not (torch.isfinite(got).all() and torch.allclose(
                got, want, atol=1e-5, rtol=1e-5)):
            raise AssertionError(f"paged_attn {what}: max |diff| = {err}")

    for d in (64, 36, 7, 128):
        # decode, S = 4, C = 1, at page boundaries and the last position
        for pos in ([255, 16, 15, 0], [15, 0, 3, 0], [128, 10, 0, 0]):
            q, qpos, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 1,
                                              [[p] for p in pos], tables,
                                              num_pages, d=d)
            check(f"decode {pos} D={d}",
                  pk.paged_attention_kernel(q[:, 0], kp, vp, tb, qpos[:, 0]),
                  pk.paged_attention(q[:, 0], kp, vp, tb, qpos[:, 0]))
        # prefill, S = 1: whole chunks, a ragged last chunk whose padding
        # queries lie past the length, queries past the table's end, and a
        # call of 20 queries (two query blocks)
        for start, table, c in ((240, tables[0], LM_CHUNK),
                                (32, tables[0], LM_CHUNK),
                                (0, reused, LM_CHUNK), (72, reused, LM_CHUNK),
                                (100, tables[0], 20)):
            qp = list(range(start, start + c))
            q, qpos, kp, vp, tb = _paged_case(gen, device, 1, c, [qp],
                                              table[None], num_pages, d=d)
            check(f"prefill start {start} C={c} D={d}",
                  pk.paged_prefill_attention_kernel(q[0], kp, vp, tb[0],
                                                    qpos[0]),
                  pk.paged_prefill_attention(q[0], kp, vp, tb[0], qpos[0]))
        # verify, S = 4, C = 4: windows straddling page boundaries
        base = torch.as_tensor([252, 14, 13, 0], dtype=torch.int32)
        q, _, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 4,
                                       [[0] * 4] * 4, tables, num_pages, d=d)
        base = base.to(device)
        check(f"verify D={d}",
              pk.paged_verify_attention_kernel(q, kp, vp, tb, base),
              pk.paged_verify_attention(q, kp, vp, tb, base))

    # A query's bits depend on its own inputs alone: each query of a
    # batched call equals the same query launched alone (S = 1, C = 1),
    # and a second run equals the first.
    n_alone = 0
    for what, qpos_list, tb_cpu in (
            ("decode", [[255], [100], [17], [0]], full),
            ("prefill", [list(range(240, 256))], full[:1]),
            ("prefill", [list(range(32, 48))], full[1:2])):
        q, qpos, kp, vp, tb = _paged_case(gen, device, len(qpos_list),
                                          len(qpos_list[0]), qpos_list,
                                          tb_cpu, num_pages)
        batched = _kernels.paged_attn(q, qpos, kp, vp, tb)
        again = _kernels.paged_attn(q, qpos, kp, vp, tb)
        for si in range(q.shape[0]):
            for ci in range(q.shape[1]):
                alone = _kernels.paged_attn(
                    q[si:si + 1, ci:ci + 1].contiguous(),
                    qpos[si:si + 1, ci:ci + 1].contiguous(), kp, vp,
                    tb[si:si + 1].contiguous())
                n_alone += 1
                if not torch.equal(alone[0, 0], batched[si, ci]):
                    raise AssertionError(
                        f"paged_attn {what}: query ({si}, {ci}) at qpos "
                        f"{qpos_list[si][ci]} differs launched alone")
        if not torch.equal(batched, again):
            raise AssertionError(f"paged_attn {what}: two runs differ")
    print(json.dumps({"paged_attn_alone_vs_batched_bitwise": n_alone,
                      "paged_attn_two_runs_bitwise": True}), flush=True)

    rows = []
    lib = torch.nn.functional.scaled_dot_product_attention
    shapes = (("decode", [[255]] * LM_SLOTS, full),
              ("decode", [[20]] * LM_SLOTS, full),
              ("prefill", [list(range(240, 256))], full[:1]),
              ("prefill", [list(range(32, 48))], full[:1]),
              ("verify", [list(range(252, 256))] * LM_SLOTS, full))
    for what, qpos_list, tb_cpu in shapes:
        s_, c_ = len(qpos_list), len(qpos_list[0])
        q, qpos, kp, vp, tb = _paged_case(gen, device, s_, c_, qpos_list,
                                          tb_cpu, num_pages)
        h, d = q.shape[2], q.shape[3]
        kc, vc = pk.gather_kv(kp, tb), pk.gather_kv(vp, tb)  # (S, L, H, D)
        mask = (torch.arange(kc.shape[1], device=device)[None, None, :]
                <= qpos[:, :, None])[:, None]                # (S, 1, C, L)
        qs, ks, vs = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        got = _kernels.paged_attn(q, qpos, kp, vp, tb)
        yard = lib(qs, ks, vs, attn_mask=mask).transpose(1, 2)
        log(f"paged_attn {what} at qpos {qpos_list[0][0]}..{qpos_list[0][-1]}"
            f": max |diff| to the SDPA yardstick "
            f"{(yard - got).abs().max().item():.3g}")
        row = {
            "kernel": "paged_attn", "call": what, "s": s_, "c": c_,
            "p": n_table,
            "qpos": (qpos_list[0][0] if c_ == 1
                     else [qpos_list[0][0], qpos_list[0][-1]]),
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

    # The floor under any launch: one in-place add on a one-element
    # tensor, timed as the kernels are. Measurement only.
    one = torch.zeros(1, device=device)
    print(json.dumps({"launch_floor_ms": _graph_ms(lambda: one.add_(1.0))}),
          flush=True)
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
    device_ms, top, n_kernels = _profile_device_ms(lambda: fn(x32))
    t0 = time.perf_counter()
    json.dumps({"images": imgs.tolist()})
    timing = {
        "predict_ms_batch": statistics.median(ms),
        "predict_device_ms_batch": device_ms,
        "predict_kernels_per_batch": n_kernels,
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
        decode_ms, decode_top, decode_kernels = _profile_device_ms(
            lambda: dec.decode(pools, toks, tables, poss))
        chunk = np.arange(LM_CHUNK, dtype=np.int32)
        prefill_ms, prefill_top, prefill_kernels = _profile_device_ms(
            lambda: dec.prefill(pools, chunk, tables[0], 96, 112))
    iter_ms = list(eng.iter_ms)
    timing = {
        "decode_iteration_ms_median": statistics.median(iter_ms),
        "decode_iterations": len(iter_ms),
        "decode_device_ms": decode_ms,
        "decode_kernels_per_iteration": decode_kernels,
        "decode_top_device_ms": decode_top,
        "prefill_chunk_ms_median": statistics.median(chunk_ms),
        "prefill_chunk_device_ms": prefill_ms,
        "prefill_kernels_per_chunk": prefill_kernels,
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


def _mlp_trainer(device, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(MLP_TRAIN, epochs=1, device=str(device))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _first_steps(data, steps: int, batch: int):
    """``data`` cut to ``steps`` whole training batches (test set kept)."""
    from distributed_mnist_bnns_tpu_torch.data import ImageClassData

    n = steps * batch
    return ImageClassData(data.train_images[:n], data.train_labels[:n],
                          data.test_images, data.test_labels,
                          source=data.source)


def _state(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}


def _states_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _cli_train_row() -> dict:
    """The flagship's epoch (``MLP_TRAIN``, synthetic data) through
    ``cli train`` in a process of its own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]),
            "--synthetic-sizes", *map(str, MLP_SYNTH)]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def mlp_train_phase(device: torch.device, gen: torch.Generator):
    """Train ``bnn-mlp-large`` one epoch through ``train.Trainer``
    (convergence), twice 50 steps from one seed (bitwise equal), 20 steps
    on each ±1 backend (bitwise equal; K1 launched 2 x 20 times on
    ``pallas_xnor``), export the trained model through ``cli export
    --checkpoint-dir`` and serve a batch through K2/K3 against the live
    eval model; then step times. Returns (launch counts, timing dict)."""
    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    # The step's fp32 products (the first layer on "xla", the head, the
    # backward pair) must be fp32 ones, not TF32.
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the MLP step is fp32")
    torch.cuda.init()      # the allocator's stats exist from here on
    torch.cuda.reset_peak_memory_stats(device)
    held_at_start = torch.cuda.memory_allocated(device)  # earlier phases'
    bs = MLP_TRAIN["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=MLP_SYNTH, seed=0)

        # 1. The flagship: one epoch at full width, evaluated before and
        # after.
        tr = _mlp_trainer(device)
        before = tr.evaluate(data)
        row = tr.fit(data)[-1]
        losses = tr.loss_history
        print(json.dumps({"mlp_train_epoch": row, "test_before": before,
                          "logged_losses": losses}), flush=True)
        if not (losses and all(np.isfinite(losses))
                and row["train_loss"] < losses[0]):
            raise AssertionError(f"flagship losses: {losses}, {row}")
        if not (row["test_acc"] > MLP_MIN_ACC and row["test_acc"]
                >= before["test_acc"] + MLP_MIN_GAIN):
            raise AssertionError(
                f"flagship test_acc {before['test_acc']} -> "
                f"{row['test_acc']}: want > {MLP_MIN_ACC} and a gain of "
                f"{MLP_MIN_GAIN}")
        log(f"bnn-mlp-large: {row['steps']} steps, test_acc "
            f"{before['test_acc']:.2f} -> {row['test_acc']:.2f}")

        # 4. The trained model through the CLI's export into the packed
        # artifact, served on the card through K2 and K3, against the live
        # eval model (first layer in fp32, as the artifact's).
        ckpt = os.path.join(tmp, "ckpt")
        tr.save_checkpoint(ckpt)
        path = os.path.join(tmp, "trained.pt")
        if cli.main(["--log-level", "WARNING", "export", "--model",
                     MLP_TRAIN["model"], "--checkpoint-dir", ckpt,
                     "--out", path]) != 0:
            raise AssertionError("cli export --checkpoint-dir failed")
        fn, _ = load_packed(path, device=device)
        x = torch.from_numpy(data.test_images[:MAIN_M]).to(device)
        fn(x)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        frozen = fn(x)
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
        live = get_model(MLP_TRAIN["model"], backend="xla")
        live.load_state_dict(tr.model.state_dict())
        with torch.no_grad():
            want = live.to(device).eval()(x)
        diff = (frozen - want).abs().max().item()
        print(json.dumps({"mlp_trained_export_vs_live_max_abs": diff,
                          "serve_launches": counts}), flush=True)
        if not (torch.equal(frozen.argmax(-1), want.argmax(-1))
                and diff <= 1e-4 and bool(torch.isfinite(frozen).all())):
            raise AssertionError(f"trained artifact vs live model: {diff}")
        for name in ("xnor_sign", "xnor_affine"):
            if counts[name] == 0:
                raise AssertionError(f"the trained artifact never launched "
                                     f"{name}")
        log(f"trained model exported and served: max |diff| {diff:.3g}")

    # 2. Determinism: two runs of 50 steps from one seed, dropout on.
    det_data = _first_steps(data, MLP_DET_STEPS, bs)
    runs = []
    for _ in range(2):
        t = _mlp_trainer(device, log_interval=1)
        t.train_epoch(det_data, 0)
        runs.append((t.loss_history, _state(t)))
    same = runs[0][0] == runs[1][0] and _states_equal(runs[0][1], runs[1][1])
    print(json.dumps({"mlp_train_runs_bitwise_equal": same,
                      "loss_history": runs[0][0]}), flush=True)
    if not same:
        raise AssertionError("two MLP training runs from seed 0 differ")
    del runs

    # 3. The four ±1 backends from one seed and one batch order, dropout
    # 0: equal loss histories and parameters; K1 twice a step.
    be_data = _first_steps(data, MLP_BACKEND_STEPS, bs)
    ref = None
    be_trainers = {}
    for backend in MLP_TRAIN_BACKENDS:
        t = _mlp_trainer(device, log_interval=1, backend=backend,
                         model_kwargs={"dropout_rate": 0.0})
        _kernels.reset_launches()
        t.train_epoch(be_data, 0)
        torch.cuda.synchronize()
        got = (t.loss_history, _state(t))
        if backend == "pallas_xnor":
            k1 = dict(_kernels.LAUNCHES)
        if ref is None:
            ref = got
        elif not (got[0] == ref[0] and _states_equal(got[1], ref[1])):
            raise AssertionError(f"backend {backend} differs from xla")
        be_trainers[backend] = t
    want = 2 * MLP_BACKEND_STEPS
    others = {n: c for n, c in k1.items() if n != "xnor" and c}
    print(json.dumps({"mlp_train_backends_bitwise_equal":
                      list(MLP_TRAIN_BACKENDS),
                      "pallas_xnor_launches": k1}), flush=True)
    if k1["xnor"] != want or others:
        raise AssertionError(f"pallas_xnor run: K1 {k1['xnor']} launches, "
                             f"want {want}; others {others}")
    counts["xnor"] = k1["xnor"]
    log(f"{MLP_BACKEND_STEPS} steps equal on {MLP_TRAIN_BACKENDS}; K1 "
        f"launched {want} times")

    # 5. Step time on the host clock (the epoch's, ending in a
    # synchronize) in this process and in a fresh one through the CLI,
    # device time from torch.profiler on one batch.
    cli_row = _cli_train_row()
    print(json.dumps({"mlp_cli_train": cli_row}), flush=True)
    if not (np.isfinite(cli_row["train_loss"])
            and cli_row["test_acc"] > MLP_MIN_ACC
            and cli_row["steps"] == row["steps"]):
        raise AssertionError(f"cli train of the flagship: {cli_row}")
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)

    def step_of(t):
        return lambda: t.train_step(t.model, t.optimizer, xb, yb)

    dev_ms, top, n_kernels = _profile_device_ms(step_of(tr), calls=20,
                                                top=1000)
    gemm = lambda ks: sum(k[1] for k in ks  # noqa: E731
                          if any(g in k[0].lower() for g in _GEMM_NAMES))
    p_ms, p_top, p_kernels = _profile_device_ms(
        step_of(be_trainers["pallas_xnor"]), calls=20, top=1000)
    k1_ms = sum(k[1] for k in p_top if "xnor_gemm" in k[0])
    step_ms = row["epoch_time_s"] / row["steps"] * 1e3
    cli_ms = cli_row["batch_time_s"] * 1e3
    timing = {
        "train_steps": row["steps"],
        "train_step_ms": step_ms,
        "train_examples_per_s": bs / step_ms * 1e3,
        "cli_train_step_ms": cli_ms,
        "cli_train_examples_per_s": bs / cli_ms * 1e3,
        "cli_train_test_acc": cli_row["test_acc"],
        "cli_train_equals_in_process": (
            cli_row["train_loss"] == row["train_loss"]
            and cli_row["test_acc"] == row["test_acc"]),
        "train_step_device_ms": dev_ms,
        "train_step_device_busy_share": (
            None if dev_ms is None else dev_ms / step_ms),
        "cli_train_step_device_busy_share": (
            None if dev_ms is None else dev_ms / cli_ms),
        "train_step_kernels": n_kernels,
        "train_step_top_device_ms": top[:10],
        "bf16_step_gemm_ms": None if dev_ms is None else gemm(top),
        "pallas_xnor_step_device_ms": p_ms,
        "pallas_xnor_step_kernels": p_kernels,
        "pallas_xnor_step_k1_ms": k1_ms,
        "pallas_xnor_step_other_gemm_ms": None if p_ms is None else gemm(p_top),
        "test_acc_before": before["test_acc"],
        "test_acc_after": row["test_acc"],
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "peak_memory_above_start_gb": (
            torch.cuda.max_memory_allocated(device) - held_at_start) / 1e9,
    }
    return counts, timing


# -- phase 9: data-parallel MLP training ------------------------------------


class _ExchangeTimer:
    """The optimizer's 1-bit exchange (``SignCompress``) with CUDA events
    around each call: compression, collectives and decoding."""

    def __init__(self, transform):
        self.transform = transform
        self.events = []

    def __call__(self, params, grads):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.transform(params, grads)
        end.record()
        self.events.append((start, end))
        return out

    def __getattr__(self, name):
        return getattr(self.transform, name)

    def ms_per_call(self):
        torch.cuda.synchronize()
        if not self.events:
            return None
        return sum(s.elapsed_time(e) for s, e in self.events) / len(
            self.events)


def _digest(model) -> str:
    """sha256 of every tensor of the model's state dict, in order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dp_data(tmp: str, steps=None):
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    data = load_mnist(os.path.join(tmp, "no-idx-files"),
                      synthetic_sizes=MLP_SYNTH, seed=0)
    return data if steps is None else _first_steps(data, steps,
                                                   MLP_TRAIN["batch_size"])


def _dp_run(device, data, evaluate: bool = False, base=MLP_TRAIN,
            **cfg) -> dict:
    """One data-parallel run of ``base`` (default ``MLP_TRAIN``, dropout
    0) in this rank: one epoch over ``data``, the launch counters zeroed
    just before and read just after it; times, bytes and a digest of the
    end state."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    kw = dict(base, epochs=1, model_kwargs={"dropout_rate": 0.0},
              device=str(device), data_parallel="auto")
    kw.update(cfg)
    t = Trainer(TrainConfig(**kw))
    timer = None
    if t.optimizer.grad_transform is not None:
        timer = t.optimizer.grad_transform = _ExchangeTimer(
            t.optimizer.grad_transform)
    before = t.evaluate(data) if evaluate else None
    torch.cuda.synchronize()
    _kernels.reset_launches()
    row = t.train_epoch(data, 0)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    after = t.evaluate(data) if evaluate else None
    plan, hier = t.comm_plan, t.hier_plan
    steps = row["steps"]
    out = {
        "steps": steps, "losses": t.loss_history, "digest": _digest(t.model),
        "train_loss": row["train_loss"],
        "step_ms": row["batch_time_s"] * 1e3,
        "examples_per_s": base["batch_size"] / row["batch_time_s"],
        "exchange_ms": None if timer is None else timer.ms_per_call(),
        "wire_bytes_per_step": t.comm_bytes() / steps,
        "plan_bytes_per_step": (0 if plan is None
                                else plan.wire_bytes_per_step),
        "mode": "none" if plan is None else plan.mode, "launches": launches,
    }
    if hier is not None:
        out.update(intra_bytes_per_step=t.comm_bytes(level="intra") / steps,
                   inter_bytes_per_step=t.comm_bytes(level="inter") / steps,
                   plan_intra=hier.intra_bytes_per_step,
                   plan_inter=hier.inter_bytes_per_step)
    if evaluate:
        out.update(test_acc_before=before["test_acc"],
                   test_acc=after["test_acc"])
    return out


def _dp_nccl_rank(rank: int, world: int, device, steps: int) -> dict:
    """Phase 9 (a) in one NCCL rank: ``steps`` steps of sign_ef."""
    with tempfile.TemporaryDirectory() as tmp:
        return _dp_run(device, _dp_data(tmp, steps), log_interval=1,
                       grad_compress="sign_ef")


def _dp_gloo_rank(rank: int, world: int, device, epoch_steps) -> dict:
    """Phase 9 (b)-(d) in one of the gloo ranks sharing a card."""
    with tempfile.TemporaryDirectory() as tmp:
        epoch = _dp_data(tmp, epoch_steps)
        return {
            "gspmd": _dp_run(device, epoch, evaluate=True),
            "sign_ef": _dp_run(device, epoch, evaluate=True,
                               grad_compress="sign_ef"),
            "sign": _dp_run(device, _first_steps(epoch, DP_SIGN_STEPS,
                                                 MLP_TRAIN["batch_size"]),
                            grad_compress="sign",
                            learning_rate=DP_SIGN_LR),
            **{f"k1_{b}": _dp_run(
                device, _first_steps(epoch, DP_SHORT_STEPS,
                                     MLP_TRAIN["batch_size"]),
                grad_compress="sign_ef", backend=b)
               for b in ("pallas_xnor", "xla")},
            "hier": _dp_run(device, _first_steps(
                epoch, DP_SHORT_STEPS, MLP_TRAIN["batch_size"]),
                grad_compress="sign_ef", dp_hosts=DP_HOSTS),
        }


def _check_ranks(name: str, ranks: list) -> None:
    """Every rank's run ended bitwise equal, every loss finite, and each
    rank's measured bytes per step equal the plan's."""
    r0 = ranks[0]
    for r in ranks:
        if r["digest"] != r0["digest"] or r["losses"] != r0["losses"]:
            raise AssertionError(f"{name}: ranks end in different states")
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"{name}: losses {r['losses']}")
        if r["wire_bytes_per_step"] != r["plan_bytes_per_step"] and (
                "plan_intra" not in r):
            raise AssertionError(
                f"{name}: {r['wire_bytes_per_step']} wire bytes a step, "
                f"the plan's {r['plan_bytes_per_step']}")
        if "plan_intra" in r and (
                r["intra_bytes_per_step"] != r["plan_intra"]
                or r["inter_bytes_per_step"] != r["plan_inter"]):
            raise AssertionError(f"{name}: intra/inter bytes {r}")


def _cli_dp_row() -> dict:
    """``cli train --dp auto --grad-compress sign_ef --epochs 1`` in a
    process of its own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]), "--dropout", "0",
            "--dp", "auto", "--grad-compress", "sign_ef",
            "--synthetic-sizes", *map(str, MLP_SYNTH)]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --dp auto exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def dp_train_phase(device: torch.device, smi: str):
    """Data-parallel training of ``bnn-mlp-large``: (a) NCCL, one rank a
    card, 50 steps of sign_ef (ranks equal; at world 1 equal to one
    process), then ``cli train --dp auto``; (b) 4 gloo ranks sharing
    card 0: ``DP_EPOCH_STEPS`` steps uncompressed (global-batch
    BatchNorm) and of sign_ef (convergence, sign_ef within 2 points),
    200 steps of sign;
    (c) 20 steps of sign_ef on pallas_xnor and on xla (equal; K1 2 x 20
    a rank); (d) 20 steps two-level (2 x 2). Every run: ranks bitwise
    equal, wire bytes per step equal to the plan's. Returns (each
    kernel's launches summed over every run and every rank, the rows)."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    rows = []
    # (a) NCCL, one rank a card
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    nccl = spawn(_dp_nccl_rank, world, backend="nccl", device="cuda",
                 args=(DP_NCCL_STEPS,))
    _check_ranks("nccl", nccl)
    row = {"dp_run": "nccl_sign_ef", "world": world, "card": smi,
           "wall_s": time.perf_counter() - t0,
           **{k: v for k, v in nccl[0].items()
              if k not in ("losses", "digest")}}
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            alone = _dp_run(device, _dp_data(tmp, DP_NCCL_STEPS),
                            log_interval=1, grad_compress="sign_ef",
                            data_parallel=None)
        row["equals_single_process"] = (
            alone["digest"] == nccl[0]["digest"]
            and alone["losses"] == nccl[0]["losses"])
        if not row["equals_single_process"]:
            raise AssertionError("world-1 NCCL sign_ef run differs from a "
                                 "single-process Trainer")
    print(json.dumps(row), flush=True)
    rows.append(row)
    # The threshold of (b)'s cut epoch, met by one process alone
    with tempfile.TemporaryDirectory() as tmp:
        alone = _dp_run(device, _dp_data(tmp, DP_EPOCH_STEPS), evaluate=True,
                        data_parallel=None)
    print(json.dumps({"dp_run": "single_process_cut_epoch", "card": smi,
                      **{k: v for k, v in alone.items()
                         if k not in ("losses", "digest")}}), flush=True)
    if not (alone["test_acc"] > MLP_MIN_ACC and alone["test_acc"]
            >= alone["test_acc_before"] + MLP_MIN_GAIN):
        raise AssertionError(f"{DP_EPOCH_STEPS} single-process steps miss "
                             f"phase 8's thresholds: {alone}")
    cli_row = _cli_dp_row()
    print(json.dumps({"dp_run": "cli_train_dp_auto", "card": smi,
                      **cli_row}), flush=True)
    if not (np.isfinite(cli_row["train_loss"])
            and cli_row["test_acc"] > MLP_MIN_ACC):
        raise AssertionError(f"cli train --dp auto: {cli_row}")

    # (b)-(d): gloo ranks sharing card 0
    t0 = time.perf_counter()
    gloo = spawn(_dp_gloo_rank, DP_GLOO_RANKS, backend="gloo",
                 device="cuda", args=(DP_EPOCH_STEPS,))
    wall = time.perf_counter() - t0
    for name in gloo[0]:
        ranks = [g[name] for g in gloo]
        _check_ranks(name, ranks)
        row = {"dp_run": f"gloo_{name}", "world": DP_GLOO_RANKS,
               "card": smi, **{k: v for k, v in ranks[0].items()
                               if k not in ("losses", "digest")},
               "launches_by_rank": [r["launches"] for r in ranks]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    runs = {r["dp_run"]: r for r in rows}
    for name in ("gloo_gspmd", "gloo_sign_ef"):
        r = runs[name]
        if not (r["test_acc"] > MLP_MIN_ACC
                and r["test_acc"] >= r["test_acc_before"] + MLP_MIN_GAIN
                and r["train_loss"] < gloo[0][name[5:]]["losses"][0]):
            raise AssertionError(f"{name} did not converge: {r}")
    if runs["gloo_sign_ef"]["test_acc"] < runs["gloo_gspmd"]["test_acc"] - 2:
        raise AssertionError("sign_ef more than 2 points below the "
                             "uncompressed run")
    if gloo[0]["k1_pallas_xnor"]["digest"] != gloo[0]["k1_xla"]["digest"]:
        raise AssertionError("pallas_xnor and xla DP runs differ")
    want = 2 * DP_SHORT_STEPS
    for g in gloo:
        k1 = g["k1_pallas_xnor"]["launches"]
        others = {n: c for n, c in k1.items() if n != "xnor" and c}
        if k1["xnor"] != want or others:
            raise AssertionError(f"DP pallas_xnor run: K1 {k1['xnor']} "
                                 f"launches a rank, want {want}; {others}")
    counts = {name: sum(r["launches"][name] for r in nccl)
              + sum(run["launches"][name] for g in gloo for run in g.values())
              for name in KERNEL_ROWS}
    log(f"data parallel: nccl x{world}, gloo x{DP_GLOO_RANKS} on one card "
        f"({wall:.1f} s): ranks equal, bytes equal to the plans, K1 "
        f"{want} launches a rank")
    return counts, rows


# -- phase 10: the conv families ---------------------------------------------


def _k1_conv_rows(device, gen):
    """(a) K1 at the conv path's shapes (``CNN_K1_SHAPES``) against its
    plain version, ``torch.equal``, on ±1 x and on patches holding zero
    taps (packed as -1, as the padding correction assumes), two runs
    equal; then CUDA-graph times of the kernel, its plain version and
    bf16 ``torch.matmul``, with the bound. Returns (rows, max |diff|)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    rows, max_err = [], 0.0
    for m, k, n in CNN_K1_SHAPES:
        w = _pm1(gen, k, n).to(device)
        wp, _, _ = xg.prepack_weights(w)
        x = _pm1(gen, m, k).to(device)
        taps = x * (torch.rand(m, k, generator=gen) > 0.1).to(device)
        for what, xx in (("±1 x", x), ("zero taps", taps)):
            got = xg.xnor_matmul_packed(xx, wp, k, n)
            again = xg.xnor_matmul_packed(xx, wp, k, n)
            want = xg.xnor_gemm_plain(pack_bits(xx), wp, k)[:, :n]
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(
                    f"K1 at (M={m}, K={k}, N={n}) on {what}: max |diff| "
                    f"{err} from its plain version, or two runs differ")
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        row = {"kernel": "xnor", "path": "conv", "m": m, "k": k, "n": n,
               "words": -(-k // 32), "packed_words": wp.shape[0],
               "tiling": list(_kernels.xnor_tiling(m, k, n)),
               "kernel_ms": _graph_ms(
                   lambda: _kernels.xnor_gemm("xnor", x, wp, k, n)),
               "plain_ms": _graph_ms(
                   lambda: xg.xnor_gemm_plain(pack_bits(x), wp, k),
                   iters=5, reps=5),
               "library_ms": _graph_ms(lambda: torch.matmul(xb, wb))}
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            "xnor", m, k, n)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows, max_err


def _cnn_trainer(device, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(CNN_TRAIN, epochs=1, device=str(device))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _step_profile(trainer, xb, yb):
    """Device time, kernels and K1's time a step (``torch.profiler``)."""
    ms, top, n = _profile_device_ms(
        lambda: trainer.train_step(trainer.model, trainer.optimizer, xb, yb),
        calls=10, top=1000)
    return {"step_device_ms": ms, "step_kernels": n,
            "step_k1_ms": sum(t[1] for t in top if "xnor_gemm" in t[0]),
            "step_top_device_ms": top[:6]}


def _cnn_train(device, data, smi):
    """(b) bnn-cnn training: an epoch of ``CNN_SYNTH`` on bf16 (the loss
    falls, accuracy rises); two bf16 runs of ``CNN_DET_STEPS`` bitwise
    equal; ``CNN_BACKEND_STEPS`` on xla, xnor and pallas_xnor from one
    seed (K1 exactly twice a pallas_xnor step; pallas_xnor and xnor share
    the im2col lowering and end bitwise equal; the trained model's logits
    on pallas_xnor equal those on xla). Returns (the trained bf16
    trainer, K1's launches, rows)."""
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    bs = CNN_TRAIN["batch_size"]
    tr = _cnn_trainer(device, log_interval=20)
    before = tr.evaluate(data)
    row = tr.fit(data)[-1]
    losses = tr.loss_history
    out = {"cnn_run": "bnn-cnn_bf16_epoch", "card": smi, **row,
           "test_before": before, "logged_losses": losses}
    print(json.dumps(out), flush=True)
    if not (losses and all(np.isfinite(losses))
            and row["train_loss"] < losses[0]
            and row["test_acc"] > MLP_MIN_ACC
            and row["test_acc"] >= before["test_acc"] + MLP_MIN_GAIN):
        raise AssertionError(f"bnn-cnn did not learn: {out}")
    rows = [out]
    runs = []
    for _ in range(2):
        det = _cnn_trainer(device, log_interval=1)
        det.train_epoch(_first_steps(data, CNN_DET_STEPS, bs), 0)
        runs.append((det.loss_history, _state(det)))
    same = runs[0][0] == runs[1][0] and _states_equal(runs[0][1], runs[1][1])
    print(json.dumps({"cnn_train_runs_bitwise_equal": same,
                      "loss_history": runs[0][0]}), flush=True)
    if not same:
        raise AssertionError("two bnn-cnn bf16 runs from seed 0 differ")
    del runs
    few = _first_steps(data, CNN_BACKEND_STEPS, bs)
    xt = torch.from_numpy(data.test_images[:bs]).to(device)
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)
    trainers, k1 = {}, None
    for backend in ("xla", "xnor", "pallas_xnor"):
        t = _cnn_trainer(device, log_interval=1, backend=backend)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t.train_epoch(few, 0)
        torch.cuda.synchronize()
        if backend == "pallas_xnor":
            k1 = dict(_kernels.LAUNCHES)
        trainers[backend] = t
    want = 2 * CNN_BACKEND_STEPS
    others = {n: c for n, c in k1.items() if n != "xnor" and c}
    if k1["xnor"] != want or others:
        raise AssertionError(f"bnn-cnn pallas_xnor: K1 {k1['xnor']} "
                             f"launches, want {want}; others {others}")
    px, xn = trainers["pallas_xnor"], trainers["xnor"]
    if not (px.loss_history == xn.loss_history
            and _states_equal(_state(px), _state(xn))):
        raise AssertionError("bnn-cnn pallas_xnor and xnor runs differ")
    twin = get_model("bnn-cnn", backend="xla").to(device)
    twin.load_state_dict(px.model.state_dict())
    with torch.no_grad():
        logits_x = twin.eval()(xt)
        logits_p = px.model.eval()(xt)
    torch.cuda.synchronize()
    xla_gap = max(abs(a - b) / abs(b) for a, b in zip(
        trainers["xla"].loss_history, px.loss_history))
    res = {"cnn_run": "bnn-cnn_backends", "card": smi,
           "pallas_xnor_k1_launches": k1["xnor"],
           "pallas_xnor_equals_xnor": True,
           "trained_logits_pallas_xnor_equal_xla":
               torch.equal(logits_x, logits_p),
           "xla_vs_pallas_xnor_loss_max_rel": xla_gap}
    if not res["trained_logits_pallas_xnor_equal_xla"]:
        raise AssertionError("bnn-cnn logits on pallas_xnor differ from xla")
    # profiled on throwaway trainers: ``tr`` goes on to be served as it
    # converged, and ``det``'s state was taken above
    for b, t in (("bf16", det), *trainers.items()):
        t.model.train()
        res[f"{b}_profile"] = _step_profile(t, xb, yb)
    res["bf16_step_ms"] = row["batch_time_s"] * 1e3
    res["bf16_examples_per_s"] = bs / row["batch_time_s"]
    print(json.dumps(res), flush=True)
    rows.append(res)
    return tr, k1["xnor"], rows


def _cnn_serve(device, tr, data, smi):
    """(c) The trained bnn-cnn through ``cli export --checkpoint-dir``,
    ``load_packed`` on the card against the live eval model (first conv
    fp32, as the artifact's; argmax equal, atol 1e-4), then served over
    HTTP at batch 32: K1 exactly twice a predictor batch. Returns (K1's
    launches, row)."""
    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
        client,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        tr.save_checkpoint(ckpt)
        path = os.path.join(tmp, "cnn.pt")
        if cli.main(["--log-level", "WARNING", "export", "--model",
                     "bnn-cnn", "--checkpoint-dir", ckpt, "--out",
                     path]) != 0:
            raise AssertionError("cli export --model bnn-cnn failed")
        fn, info = load_packed(path, device=device)
        x = torch.from_numpy(data.test_images[:MAIN_M]).to(device)
        fn(x)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        frozen = fn(x.reshape(MAIN_M, -1))
        torch.cuda.synchronize()
        one = dict(_kernels.LAUNCHES)
        if one["xnor"] != 2 or any(c for n, c in one.items() if n != "xnor"):
            raise AssertionError(f"a bnn-cnn predictor batch launched {one}")
        live = get_model("bnn-cnn", backend="xla").to(device)
        live.load_state_dict(tr.model.state_dict())
        with torch.no_grad():
            want = live.eval()(x)
        diff = (frozen - want).abs().max().item()
        if not (torch.equal(frozen.argmax(-1), want.argmax(-1))
                and diff <= 1e-4 and bool(torch.isfinite(frozen).all())):
            raise AssertionError(f"frozen bnn-cnn vs live model: {diff}")

        imgs = data.test_images[:MAIN_M]
        _kernels.reset_launches()
        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=MAIN_M,
            default_deadline_ms=30000.0, stall_timeout_s=30.0))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        answers, lat = [], []
        try:
            for i, n_req in enumerate((1, MAIN_M, 5, MAIN_M)):
                xs = np.roll(imgs, -3 * i, axis=0)[:n_req]
                t0 = time.perf_counter()
                code, body = client.predict(base, xs.tolist())
                lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"/predict: {code} {body[:200]!r}")
                answers.append((xs, json.loads(body)))
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        served = dict(_kernels.LAUNCHES)
        batches = stats["batches_total"] + 1   # + the warm-up call
        if served["xnor"] != 2 * batches:
            raise AssertionError(f"served bnn-cnn: K1 {served['xnor']} "
                                 f"launches for {batches} batches")
        for xs, out in answers:
            padded = np.zeros((MAIN_M, 28, 28, 1), np.float32)
            padded[:len(xs)] = xs
            ref = fn(padded)[:len(xs)].cpu().numpy()
            if out["argmax"] != ref.argmax(-1).tolist() or not np.allclose(
                    np.asarray(out["log_probs"], np.float32), ref,
                    atol=1e-6, rtol=0):
                raise AssertionError("/predict differs from the predictor")
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms, top, n_kernels = _profile_device_ms(lambda: fn(x))
    row = {"cnn_run": "bnn-cnn_serve", "card": smi, "info": info,
           "frozen_vs_live_max_abs": diff, "k1_per_batch": one["xnor"],
           "served_batches": batches, "served_k1": served["xnor"],
           "predict_ms_batch": statistics.median(ms),
           "predict_device_ms_batch": dev_ms,
           "predict_kernels_per_batch": n_kernels,
           "predict_top_device_ms": top,
           "request_ms_median": statistics.median(lat) * 1e3}
    print(json.dumps(row), flush=True)
    return one["xnor"] + served["xnor"], row


def _fp_runs(device, data, smi):
    """(d) convnet and deep-cnn, ``CNN_FP_STEPS`` steps at fp32 and at
    bf16 (the loss falls), then the fresh-process check that an fp32
    conv trained through ``cli train`` is fp32, not TF32."""
    bs = CNN_TRAIN["batch_size"]
    cut = _first_steps(data, CNN_FP_STEPS, bs)
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)
    rows = []
    for name in ("convnet", "deep-cnn"):
        for precision in ("fp32", "bf16"):
            t = _cnn_trainer(device, model=name, precision=precision,
                             log_interval=20)
            row = t.train_epoch(cut, 0)
            losses = t.loss_history
            r = {"cnn_run": f"{name}_{precision}", "card": smi,
                 "steps": row["steps"], "first_loss": losses[0],
                 "train_loss": row["train_loss"], "last_loss": losses[-1],
                 "step_ms": row["batch_time_s"] * 1e3,
                 "examples_per_s": bs / row["batch_time_s"],
                 **_step_profile(t, xb, yb)}
            print(json.dumps(r), flush=True)
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and row["train_loss"] < losses[0]):
                raise AssertionError(f"{name} at {precision}: the loss did "
                                     f"not fall: {losses}")
            rows.append(r)
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "scripts",
                                      "torch_conv_fp32_check.py")],
        cwd=here, capture_output=True, text=True, timeout=300)
    line = json.loads(out.stdout.strip().splitlines()[-1]) \
        if out.stdout.strip() else {}
    print(json.dumps({"cnn_run": "fresh_process_fp32_conv", **line}),
          flush=True)
    if out.returncode != 0 or not line.get("ok"):
        raise AssertionError(f"fresh-process convnet conv is not fp32: "
                             f"{line} {out.stderr[-2000:]}")
    rows.append(line)
    return rows


def _conv_dp_rank(rank: int, world: int, device, steps: int,
                  nccl: bool) -> dict:
    """(e) in one rank: ``steps`` steps of convnet uncompressed and, over
    gloo, of bnn-cnn with ``sign_ef`` on pallas_xnor."""
    with tempfile.TemporaryDirectory() as tmp:
        from distributed_mnist_bnns_tpu_torch.data import load_mnist

        data = _first_steps(load_mnist(os.path.join(tmp, "no-idx-files"),
                                       synthetic_sizes=CNN_SYNTH, seed=0),
                            steps, CNN_TRAIN["batch_size"])
        runs = {"convnet": _dp_run(device, data, base=CNN_TRAIN,
                                   model="convnet", model_kwargs={},
                                   log_interval=1)}
        if not nccl:
            runs["bnn-cnn"] = _dp_run(device, data, base=CNN_TRAIN,
                                      model_kwargs={}, log_interval=1,
                                      grad_compress="sign_ef",
                                      backend="pallas_xnor")
        return runs


def _conv_dp(device, smi):
    """(e) Data parallel: 2 gloo ranks sharing card 0 (and one NCCL rank
    a card where there are two or more): every rank bitwise equal, the
    wire bytes a step the plan's, K1 twice a pallas_xnor step in each
    rank. Returns (K1's launches, rows)."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    rows, k1 = [], 0
    kinds = [("gloo", 2)]
    if torch.cuda.device_count() > 1:
        kinds.append(("nccl", torch.cuda.device_count()))
    for backend, world in kinds:
        t0 = time.perf_counter()
        ranks = spawn(_conv_dp_rank, world, backend=backend, device="cuda",
                      args=(CNN_DP_STEPS, backend == "nccl"))
        wall = time.perf_counter() - t0
        for name in ranks[0]:
            runs = [r[name] for r in ranks]
            _check_ranks(f"{backend} {name}", runs)
            row = {"cnn_run": f"dp_{backend}_{name}", "world": world,
                   "card": smi, "wall_s": wall,
                   **{k: v for k, v in runs[0].items()
                      if k not in ("losses", "digest")},
                   "launches_by_rank": [r["launches"] for r in runs]}
            print(json.dumps(row), flush=True)
            rows.append(row)
            k1 += sum(r["launches"]["xnor"] for r in runs)
            if name == "bnn-cnn" and any(
                    r["launches"]["xnor"] != 2 * CNN_DP_STEPS for r in runs):
                raise AssertionError(f"DP bnn-cnn: K1 launches by rank "
                                     f"{row['launches_by_rank']}")
    if len(kinds) == 1:
        print(json.dumps({"cnn_run": "dp_nccl", "skipped":
                          "one card: NCCL refuses two ranks on one card"}),
              flush=True)
    return k1, rows


def conv_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 10, the conv families: (a) K1 at the conv shapes; (b)
    bnn-cnn training; (c) bnn-cnn frozen and served; (d) convnet and
    deep-cnn at fp32 and bf16, and the fresh-process fp32 check; (e)
    data parallel. Returns (each kernel's launches on the conv path,
    K1's conv-shape rows)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    t0 = time.perf_counter()
    k1_rows, k1_err = _k1_conv_rows(device, gen)
    log(f"K1 equal to its plain version at {len(k1_rows)} conv shapes")
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=CNN_SYNTH, seed=0)
    tr, k1_train, _ = _cnn_train(device, data, smi)
    log(f"bnn-cnn trained; K1 {k1_train} launches on pallas_xnor")
    k1_serve, _ = _cnn_serve(device, tr, data, smi)
    log(f"bnn-cnn frozen and served; K1 {k1_serve} launches")
    _fp_runs(device, data, smi)
    log("convnet and deep-cnn train at fp32 and bf16; fresh-process "
        "conv is fp32")
    k1_dp, _ = _conv_dp(device, smi)
    log(f"conv DP: ranks equal, bytes equal to the plans, K1 {k1_dp}")
    counts = {name: 0 for name in KERNEL_ROWS}
    counts["xnor"] = k1_train + k1_serve + k1_dp
    for row in k1_rows:
        row["max_abs_err"] = k1_err
    print(json.dumps({"slice": "conv", "launches": counts,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    return counts, k1_rows


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
    # K1: every packed projection of a decode iteration (M = slots rows,
    # below FUSED_UNPACK_MIN_M), 6 a block, and nothing else.
    want = LM_WIDTH["depth"] * 6 * lm_timing["decode_iterations"]
    if lm_counts["xnor"] != want:
        raise AssertionError(
            f"K1 launched {lm_counts['xnor']} times on the LM path, want "
            f"{want} ({lm_timing['decode_iterations']} decode iterations)")
    # K8: one launch a layer per decode iteration and per prefill chunk.
    want = LM_WIDTH["depth"] * (lm_timing["decode_iterations"] + chunks)
    if lm_counts["paged_attn"] != want:
        raise AssertionError(
            f"K8 launched {lm_counts['paged_attn']} times on the LM path, "
            f"want {want} ({lm_timing['decode_iterations']} decode "
            f"iterations, {chunks} prefill chunks)")

    flash_rows, flash_err = flash_phase(device, gen)
    for name in FLASH:
        results[name] = (flash_rows[name], flash_err[name])
    log("flash: K4/K5/K6 within tolerance of their plain versions at "
        "every shape")
    train_counts, train_timing = lm_train_phase(device, gen)
    print(json.dumps({"slice": "bnn-lm-train", "launches": train_counts,
                      **train_timing}), flush=True)
    mlp_train_counts, mlp_train_timing = mlp_train_phase(device, gen)
    print(json.dumps({"slice": "bnn-mlp-train",
                      "launches": mlp_train_counts, **mlp_train_timing}),
          flush=True)
    dp_counts, _ = dp_train_phase(device, smi)
    conv_counts, conv_rows = conv_phase(device, gen, smi)

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
                         + train_counts[name] + mlp_train_counts[name]
                         + dp_counts[name] + conv_counts[name]),
            "launches_mlp_path": mlp_counts[name],
            "launches_lm_path": lm_counts[name],
            "launches_train_path": (train_counts[name]
                                    + mlp_train_counts[name]),
            "launches_lm_train_path": train_counts[name],
            "launches_mlp_train_path": mlp_train_counts[name],
            "launches_dp_path": dp_counts[name],
            "launches_conv_path": conv_counts[name],
            "max_abs_err": max_err,
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": row["bound_peak"],
            "library_ms": row["library_ms"],
            "shape": shape,
        }
        if name == "xnor":   # K1 at the conv path's shapes (phase 10)
            entry["conv_shapes"] = conv_rows
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
