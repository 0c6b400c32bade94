"""Packed ±1 GEMMs, and the differentiable ±1 product of training.

Counterpart of the JAX package's ``ops/xnor_gemm.py``. For training,
``binary_matmul``: the ±1 product on one of the five backends of the JAX
package ("xla", "bf16", "int8", "xnor", "pallas_xnor"; the last runs K1),
with the JAX package's fp32 backward. For frozen inference:
``prepack_weights``, the three packed entry points

  xnor_matmul_packed         o = K - 2 * sum_w popcount(x_w ^ w_w)
  xnor_matmul_packed_sign    where(a * (o + bias) >= t, +1, -1)
  xnor_matmul_packed_affine  clip(a * (o + bias) + c, -1, 1)

with the JAX argument order ``(x_pm1, w_packed, k, n, avec, tvec|cvec,
bias)``, and ``xnor_matmul_fused_unpack``: fp32 x times the packed
weights, unpacked inside the GEMM (K7, the LM's prefill projections).
Each entry dispatches on x's device: a CUDA tensor launches the
hand-written kernel (``csrc/xnor_gemm.cu`` or ``csrc/xnor_unpack.cu``
through ``ops._kernels``) or raises; a CPU tensor takes the plain
PyTorch version below. There is no fallback from the one to the other.

K1-K3 take x as it is and pack its signs on chip, bit = x > 0, which is
``pack_bits(x)`` bit for bit. The private ``_xnor_matmul_binarize`` packs
x >= 0 instead, which is ``pack_bits(binarize_ste(x))`` bit for bit for
every fp32 x: the LM decoder's K1 projections run it, with no separate
sign or pack launches. On the CPU each entry packs with ``pack_bits``
(after ``_sign_pm1`` for the latter) and runs the plain version.

Every GEMM result is exact: a ±1 dot product is an integer with
|dot| <= K <= 2^24. The epilogues follow the JAX kernels' order of
operations and rounding: the sign epilogue rounds after each operation,
and the affine one rounds ``a * y + c`` once, as the fused multiply-add
that XLA makes of it (``_fma_f32``). So the kernel, the plain version
and the JAX Pallas kernels run in interpret mode agree bitwise.
"""

from __future__ import annotations

import contextlib

from typing import Tuple

import torch

from . import _kernels
from .binarize import _sign_pm1
from .bitpack import pack_bits, packed_dim, unpack_bits


def prepack_weights(
    w_pm1: torch.Tensor, block_n: int = 256
) -> Tuple[torch.Tensor, int, int]:
    """Pack a ±1 (K, N) weight matrix into the K-major bitplane layout,
    word for word the JAX package's ``prepack_weights``: (KW_p, N_p)
    int32 with K padded to 128-word multiples once KW > 128 and N padded
    to ``min(block_n, max(128, n))`` column blocks. Returns
    (packed, k, n)."""
    k, n = w_pm1.shape
    wtp = pack_bits(w_pm1.t()).t()
    kw = wtp.shape[0]
    kw_p = kw if kw <= 128 else -(-kw // 128) * 128
    bn = min(block_n, max(128, n))
    np_ = -(-n // bn) * bn
    if (kw_p, np_) != tuple(wtp.shape):
        wtp = torch.nn.functional.pad(wtp, (0, np_ - n, 0, kw_p - kw))
    return wtp.contiguous(), k, n


# ---------------------------------------------------------------------------
# Training: the differentiable ±1 product
# ---------------------------------------------------------------------------

BACKENDS = ("xla", "bf16", "int8", "xnor", "pallas_xnor")

def int8_matmul(a: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K).T int8 -> (M, N) int32 with int32
    accumulation: exact, as XLA's ``preferred_element_type=int32`` dot
    (|sum| <= K * 128^2 < 2^31). A library GEMM, not a hand-written
    kernel: cuBLASLt's int8 GEMM (``torch._int_mm``) on a card, which
    takes M > 16 and K, N multiples of 8, so operands that miss them are
    padded with zero rows and columns (they add nothing) and the result
    sliced; the CPU's ``_int_mm`` otherwise."""
    m, k = a.shape
    n = wt.shape[0]
    if a.is_cuda:
        kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
        if kp != k or m <= 16:
            a = torch.nn.functional.pad(a, (0, kp - k, 0, max(m, 17) - m))
        if kp != k or np_ != n:
            wt = torch.nn.functional.pad(wt, (0, kp - k, 0, np_ - n))
    return torch._int_mm(a, wt.t())[:m, :n]


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w.T for ±1 operands as int8 with int32 accumulation,
    then fp32 (the JAX "int8" backend; ``int8_matmul``)."""
    return int8_matmul(x.to(torch.int8), w.to(torch.int8)).to(torch.float32)


def _xnor_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w.T for ±1 operands through bitplanes, in plain
    PyTorch: K - 2 * sum popcount(x ^ w) (the JAX ``_xnor_matmul_jnp``)."""
    k = x.shape[-1]
    mism = _mismatches(pack_bits(x), pack_bits(w).t())
    return (k - 2 * mism).to(torch.float32)


def _bmm_forward(x: torch.Tensor, w: torch.Tensor, backend: str):
    """x (M, K) @ w.T for a ±1 (N, K) weight. "xla": the fp32 product.
    "bf16": operands rounded to bfloat16 and multiplied with fp32
    accumulation, as the JAX "bf16" backend's
    ``preferred_element_type=float32`` does. "int8": ``_int8_matmul``.
    "xnor": ``_xnor_matmul_plain``. "pallas_xnor": the weights packed
    (``prepack_weights``) and K1 (``xnor_matmul_packed``), as the JAX
    ``xnor_matmul``. All are exact on ±1 operands; "xla" and "bf16"
    differ only on a raw first-layer input that bf16 cannot hold, and
    the last three assume ±1 x (``BinarizedDense`` reroutes raw inputs
    to "xla")."""
    if backend == "xla":
        return x @ w.t()
    if backend == "bf16":
        return x.to(torch.bfloat16).to(torch.float32) @ (
            w.to(torch.bfloat16).to(torch.float32).t()
        )
    if backend == "int8":
        return _int8_matmul(x, w)
    if backend == "xnor":
        return _xnor_matmul_plain(x, w)
    if backend == "pallas_xnor":
        wp, k, n = prepack_weights(w.t())
        return xnor_matmul_packed(x, wp, k, n)
    raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")


class _BinaryMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, backend: str):
        ctx.save_for_backward(x, w)
        return _bmm_forward(x, w, backend)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # The JAX _bmm_bwd: fp32 products of the cotangent with the ±1
        # operands, whatever the forward's backend (autograd through the
        # bf16 casts would round the cotangent to bf16).
        x, w = ctx.saved_tensors
        return g @ w.to(g.dtype), g.t() @ x.to(g.dtype), None


def binary_matmul(x_pm1: torch.Tensor, w_pm1: torch.Tensor,
                  backend: str = "bf16") -> torch.Tensor:
    """Differentiable (M, K) x (N, K) ±1 product -> (M, N) fp32, the
    weight in ``nn.Linear``'s (out, in) layout, on ``backend``. Backward
    on every backend: gx = g @ w, gw = g^T @ x, in fp32."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
    return _BinaryMatmul.apply(x_pm1, w_pm1, backend)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the kernels' reference)
# ---------------------------------------------------------------------------

_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F
_CHUNK_ELEMS = 1 << 22  # bound on the (M, N, words) int64 temporary


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor."""
    v = v & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _mismatches(xp: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """(M, KW) x (KW, N) packed -> (M, N) int64 sum_w popcount(x ^ w),
    chunked over the words so the (M, N, chunk) temporary stays small."""
    m, kw = xp.shape
    n = wt.shape[1]
    x64 = xp.to(torch.int64)
    w64 = wt[:kw].to(torch.int64)
    step = max(1, _CHUNK_ELEMS // max(1, m * n))
    mism = torch.zeros((m, n), dtype=torch.int64, device=xp.device)
    for t0 in range(0, kw, step):
        xc = x64[:, None, t0:t0 + step]           # (M, 1, c)
        wc = w64[t0:t0 + step].t()[None]          # (1, N, c)
        mism += _popcount32(xc ^ wc).sum(dim=-1)
    return mism


def _pad_cols(vec: torch.Tensor, np_: int, fill: float = 0.0) -> torch.Tensor:
    """(N,) per-column epilogue vector -> (N_p,) padded fp32."""
    vec = vec.to(torch.float32)
    return torch.nn.functional.pad(vec, (0, np_ - vec.shape[0]), value=fill)


def _fma_f32(a: torch.Tensor, y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * y + c`` rounded once, as a fused multiply-add.

    In float64 the product of two fp32 values is exact; TwoSum then gives
    the exact remainder of the float64 sum, and rounding that sum to odd
    (a nonzero remainder forces the last bit to 1) makes the final
    rounding to fp32 the only one that counts (53 >= 24 + 2 bits)."""
    a64, y64, c64 = a.double(), y.double(), c.double()
    p = a64 * y64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def xnor_gemm_plain(xp: torch.Tensor, wp: torch.Tensor, k: int) -> torch.Tensor:
    """K1's plain version: (M, KW) packed x against (KW_p, N_p) packed
    weights -> (M, N_p) fp32 ``K - 2 * mismatches`` (exact integers)."""
    return (k - 2 * _mismatches(xp, wp)).to(torch.float32)


def xnor_sign_plain(xp, wp, k, avec, tvec, bias) -> torch.Tensor:
    """K2's plain version over the padded (M, N_p) tile, in the JAX
    kernel's order; padding columns use a=0, t=+1 (so they are -1)."""
    o = xnor_gemm_plain(xp, wp, k)
    np_ = o.shape[1]
    y = o + _pad_cols(bias, np_)
    pos = _pad_cols(avec, np_) * y >= _pad_cols(tvec, np_, fill=1.0)
    return torch.where(pos, 1.0, -1.0).to(torch.float32)


def xnor_affine_plain(xp, wp, k, avec, cvec, bias) -> torch.Tensor:
    """K3's plain version over the padded (M, N_p) tile, in the JAX
    kernel's order; padding columns use zeros."""
    o = xnor_gemm_plain(xp, wp, k)
    np_ = o.shape[1]
    y = _fma_f32(
        _pad_cols(avec, np_), o + _pad_cols(bias, np_), _pad_cols(cvec, np_)
    )
    return torch.clamp(y, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def _check_operands(x: torch.Tensor, w_packed: torch.Tensor, k: int, n: int):
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if w_packed.device != x.device:
        raise ValueError(
            f"x on {x.device} but packed weights on {w_packed.device}"
        )
    kw = packed_dim(k)
    if w_packed.shape[0] < kw or w_packed.shape[1] < n:
        raise ValueError(
            f"packed weights {tuple(w_packed.shape)} do not cover K={k} "
            f"({kw} words), N={n}"
        )


def _dispatch(name, plain, x, w_packed, k, n, va=None, vb=None, bias=None,
              rule=_kernels.PACK_GT0):
    _check_operands(x, w_packed, k, n)
    if x.is_cuda:
        vecs = [
            None if v is None else v.to(torch.float32).contiguous()
            for v in (va, vb, bias)
        ]
        # The rules' bits survive the cast: fp16, bf16 and integer values
        # keep their side of ±2^-126, and a float64 x can round across it
        # only from within 2^-150 of it.
        return _kernels.xnor_gemm(name, x.to(torch.float32).contiguous(),
                                  w_packed, k, n, *vecs, rule=rule)
    if x.device.type != "cpu":
        raise ValueError(f"no packed GEMM for device {x.device}")
    xp = pack_bits(_sign_pm1(x) if rule == _kernels.PACK_GE0 else x)
    args = () if va is None else (va, vb, bias)
    return plain(xp, w_packed, k, *args)[:, :n]


def xnor_matmul_packed(
    x_pm1: torch.Tensor, w_packed: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """(M, K) ±1 activations @ pre-packed weights -> (M, N) fp32."""
    return _dispatch("xnor", xnor_gemm_plain, x_pm1, w_packed, k, n)


def xnor_matmul_packed_sign(
    x_pm1: torch.Tensor, w_packed: torch.Tensor, k: int, n: int,
    avec: torch.Tensor, tvec: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """(M, K) ±1 @ pre-packed weights with the threshold-sign epilogue
    fused: returns ±1 activations ready for the next packed layer.
    ``avec``/``tvec``/``bias`` are (N,) per-column epilogue params
    (``infer._bn_sign_epilogue``)."""
    return _dispatch(
        "xnor_sign", xnor_sign_plain, x_pm1, w_packed, k, n, avec, tvec, bias
    )


def xnor_matmul_packed_affine(
    x_pm1: torch.Tensor, w_packed: torch.Tensor, k: int, n: int,
    avec: torch.Tensor, cvec: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """(M, K) ±1 @ pre-packed weights with the eval-BN affine + hardtanh
    epilogue fused: returns ``clip(a*(y+bias)+c, -1, 1)``."""
    return _dispatch(
        "xnor_affine", xnor_affine_plain, x_pm1, w_packed, k, n,
        avec, cvec, bias,
    )


def _xnor_matmul_binarize(
    x: torch.Tensor, w_packed: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """``xnor_matmul_packed(binarize_ste(x), w_packed, k, n)`` bit for bit,
    for any real (M, K) x, in one launch on a card: K1 packs x >= 0 on
    chip (0 and -0.0 give +1, NaN gives -1, as ``binarize_ste``). No
    gradient: the frozen decoder's K1 projections."""
    return _dispatch("xnor", xnor_gemm_plain, x, w_packed, k, n,
                     rule=_kernels.PACK_GE0)


def fused_unpack_plain(x: torch.Tensor, w_packed: torch.Tensor, k: int,
                       n: int) -> torch.Tensor:
    """K7's plain version: unpack the ±1 (K, N) weights, then one fp32
    product (TF32 must be off on a card: the caller's job, as for every
    fp32 product of the port). Exact on ±1 x."""
    return x.to(torch.float32) @ unpacked_pm1(w_packed, k, n)


def xnor_matmul_fused_unpack(
    x: torch.Tensor, w_packed: torch.Tensor, k: int, n: int
) -> torch.Tensor:
    """(M, K) fp32 activations @ pre-packed ±1 weights -> (M, N) fp32,
    the bitplanes unpacked inside the GEMM (``prepack_weights`` layout,
    read as it is). On ±1 x the result equals ``xnor_matmul_packed``
    bitwise: both are exact integer sums. x may be any real fp32."""
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"x must be (M, {k}), got {tuple(x.shape)}")
    if w_packed.device != x.device:
        raise ValueError(
            f"x on {x.device} but packed weights on {w_packed.device}"
        )
    if w_packed.shape[0] < packed_dim(k) or w_packed.shape[1] < n:
        raise ValueError(
            f"packed weights {tuple(w_packed.shape)} do not cover K={k} "
            f"({packed_dim(k)} words), N={n}"
        )
    if x.is_cuda:
        return _kernels.xnor_unpack(
            x.to(torch.float32).contiguous(), w_packed, k, n
        )
    if x.device.type != "cpu":
        raise ValueError(f"no fused-unpack GEMM for device {x.device}")
    return fused_unpack_plain(x, w_packed, k, n)


def unpacked_pm1(w_packed: torch.Tensor, k: int, n: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The (K, N) ±1 matrix a packed weight holds."""
    return unpack_bits(w_packed.t().contiguous(), k, dtype).t()[:, :n]


# ---------------------------------------------------------------------------
# Convolutions: the fp32 contract, the differentiable ±1 conv, im2col
# ---------------------------------------------------------------------------


def conv_precision():
    """Scope of the port's convolutions on a card: cuDNN on, TF32 off,
    deterministic algorithms, no autotuning; the previous flags come
    back on exit. Without it a fresh process runs an fp32 conv in TF32
    (PyTorch's ``cudnn.allow_tf32`` defaults to True), which rounds its
    inputs to 10 mantissa bits, and picks weight-gradient algorithms
    that sum in a different order from run to run. The flags are
    process-wide, so the scope is as narrow as one conv or one conv
    backward (``_Conv2d``); nothing outside it changes."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


@contextlib.contextmanager
def _cpu_conv_backward(device: torch.device):
    """Scope of a conv backward on the CPU: oneDNN off, so ATen's own
    (thnn) kernels compute it. PyTorch 2.13.0+cpu's oneDNN weight
    gradient of a channels-last 1x1 stride-2 conv (x (4, 4, 16, 16), w
    (8, 4, 1, 1): a ResNet's projection shortcut) corrupts the heap now
    and then ("corrupted size vs. prev_size", "double free or
    corruption"), which killed gloo ranks of the CPU tests with SIGABRT.
    A no-op off the CPU."""
    if device.type != "cpu":
        yield
        return
    previous = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = previous


def same_padding(in_hw, kernel, strides):
    """XLA's "SAME" padding: ((lo, hi), (lo, hi)) with out = ceil(in/s)
    and the odd pixel of an uneven total on the high side."""
    pads = []
    for d, k, s in zip(in_hw, kernel, strides):
        total = max((-(-d // s) - 1) * s + k - d, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv_pads(padding, in_hw, kernel, strides):
    """flax's conv ``padding`` ("SAME", "VALID", an int, or (lo, hi)
    pairs) as ((lo, hi), (lo, hi))."""
    if isinstance(padding, str):
        if padding.upper() == "SAME":
            return same_padding(in_hw, kernel, strides)
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad_hw(x: torch.Tensor, pads):
    """x (N, C, H, W) zero-padded as ``pads``, and the padding left for
    ``F.conv2d`` (symmetric pads are passed through, uneven ones applied
    here)."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        return x, (t, l)
    return torch.nn.functional.pad(x, (l, r, t, b)), (0, 0)


class _Conv2d(torch.autograd.Function):
    """``F.conv2d`` of x (N, C, H, W) and w (F, C, kh, kw), forward and
    backward inside ``conv_precision``. With ``rnd`` the forward
    multiplies the operands rounded to that dtype (and back to theirs);
    the backward is the conv's VJP on the operands as given, in their
    dtype, so no cast rounds the cotangent."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, rnd):
        ctx.conf = (stride, padding)
        ctx.save_for_backward(x, w)
        if rnd is not None:
            x, w = x.to(rnd).to(x.dtype), w.to(rnd).to(w.dtype)
        with conv_precision():
            return torch.nn.functional.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        stride, padding = ctx.conf
        x, w = ctx.saved_tensors
        with conv_precision(), _cpu_conv_backward(x.device):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g.to(x.dtype), x, w, None, list(stride), list(padding),
                [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        if gw is not None and gw.stride() != w.stride():
            # cuDNN may return a one-channel kernel's gradient with other
            # strides; DDP's buckets want the weight's own layout
            gw = torch.empty_like(w).copy_(gw)
        return gx, gw, None, None, None


def conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
           padding="SAME") -> torch.Tensor:
    """flax's ``lax.conv_general_dilated`` of x (N, C, H, W) and w (F, C,
    kh, kw) in their common dtype (an fp32 conv is fp32, a bf16 conv
    rounds its output to bf16 as flax's ``nn.Conv(dtype=bf16)``), with
    flax's ``padding``; forward and backward in ``conv_precision``."""
    pads = conv_pads(padding, x.shape[2:], w.shape[2:], strides)
    xp, pad = _pad_hw(x, pads)
    return _Conv2d.apply(xp, w, tuple(strides), pad, None)


_CONV_ROUND = {"xla": None, "bf16": torch.bfloat16, "int8": torch.int8}


def binary_conv2d(x: torch.Tensor, w: torch.Tensor, strides=(1, 1),
                  padding="SAME", dtype: str = "bf16") -> torch.Tensor:
    """The JAX ``binary_conv2d`` on NCHW x and OIHW w: the forward on
    operands rounded to ``dtype`` ("bf16", "int8", or "xla": fp32 as
    they are) with fp32 accumulation, the backward the fp32 conv VJP on
    the unrounded operands (autograd through the casts would round the
    cotangent). The rounded operands are multiplied by an fp32 conv,
    which is what a ``dtype`` conv with fp32 accumulation computes: a
    product of two bf16 (or int8) values is exact in fp32. On ±1
    operands every backend gives the same integers."""
    if dtype not in _CONV_ROUND:
        raise ValueError(f"unknown conv dtype {dtype!r} (have "
                         f"{tuple(_CONV_ROUND)})")
    pads = conv_pads(padding, x.shape[2:], w.shape[2:], strides)
    xp, pad = _pad_hw(x.to(torch.float32), pads)
    return _Conv2d.apply(xp, w.to(torch.float32), tuple(strides), pad,
                         _CONV_ROUND[dtype])


def conv_patch_weight(wb: torch.Tensor) -> torch.Tensor:
    """(F, cin, kh, kw) conv kernel -> the (F, cin*kh*kw) GEMM weight in
    ``binary_matmul``'s (out, in) layout, its input axis in the patch
    order of ``im2col`` (channel-major: (cin, kh, kw)). The JAX
    ``conv_patch_weight`` gives the transpose from flax's HWIO kernel."""
    return wb.reshape(wb.shape[0], -1)


def im2col(x: torch.Tensor, kernel, strides=(1, 1),
           padding="SAME") -> torch.Tensor:
    """Patches of x (N, C, H, W) -> (N, Ho, Wo, C*kh*kw), each patch
    channel-major ((c, kh, kw)), zero-padded: bit for bit the NHWC
    output of ``jax.lax.conv_general_dilated_patches``."""
    kh, kw = kernel
    pads = conv_pads(padding, x.shape[2:], kernel, strides)
    (t, b), (l, r) = pads
    xp = torch.nn.functional.pad(x, (l, r, t, b))
    n = x.shape[0]
    ho = (xp.shape[2] - kh) // strides[0] + 1
    wo = (xp.shape[3] - kw) // strides[1] + 1
    cols = torch.nn.functional.unfold(xp, (kh, kw), stride=tuple(strides))
    return cols.transpose(1, 2).reshape(n, ho, wo, cols.shape[1])


def conv_padding_correction(tap_sums: torch.Tensor, in_hw, strides=(1, 1),
                            padding="SAME") -> torch.Tensor:
    """The JAX ``conv_padding_correction``: a zero padding tap packs as
    -1 (bit = x > 0) and so subtracts its weight from the ±1 patch GEMM;
    this adds back ``sum_all(w) - sum_in_bounds(w)`` per output position.
    ``tap_sums`` is the ±1 kernel summed over its input channels, (kh,
    kw, F), as the frozen artifact ships it. Returns (1, Ho, Wo, F),
    exactly 0 in the interior; every value is a small integer, so the
    result is exact whatever the order of summation."""
    kh, kw, f = tap_sums.shape
    ts = tap_sums.to(torch.float32)
    ones = torch.ones((1, 1, *in_hw), dtype=torch.float32,
                      device=ts.device)
    pads = conv_pads(padding, in_hw, (kh, kw), strides)
    xp, pad = _pad_hw(ones, pads)
    with conv_precision():
        valid = torch.nn.functional.conv2d(
            xp, ts.permute(2, 0, 1)[:, None].contiguous(), None,
            tuple(strides), pad)
    total = ts.sum(dim=(0, 1))
    return total[None, None, None, :] - valid.permute(0, 2, 3, 1)
