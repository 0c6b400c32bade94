"""Flash attention, forward and backward, over (B, L, H, D) inputs.

Counterpart of the JAX package's ``ops/flash_attention.py``, with its
public names and layout:

  flash_attention(q, k, v, causal)          out, in q's dtype
  flash_attention_with_lse(q, k, v, causal) (out, lse), fp32, lse (B, Lq, H)

Both go through one ``torch.autograd.Function`` whose backward takes the
cotangents of both outputs, as ``_fa_bwd_pallas`` does: with
``delta = rowsum(g_out * out)`` and ``coeff = g_lse - delta`` (computed
here, outside the kernels)

    p_ij  = exp(s_ij - lse_i)                 s = q k^T * d^-0.5
    ds_ij = p_ij * (g_out_i . v_j + coeff_i) * d^-0.5
    dq_i  = sum_j ds_ij k_j    dk_j = sum_i ds_ij q_i    dv_j = sum_i p_ij g_out_i

A CUDA tensor launches the hand-written kernels (through ``ops._kernels``)
or raises: K4, the forward, of ``csrc/flash_attn.cu``, and K5 (dq) and K6
(dk, dv) of ``csrc/flash_bwd.cu``. Their matrix products run on the tensor
cores in 3xTF32 (each fp32 operand split into two TF32 parts, three TF32
products summed in fp32: about 2^-21 relative per product, fp32's
accuracy class), except K4's scores: those are exact fp32 on the CUDA
cores, bitwise the scores of an fp32 GEMM, since the binarized LM's
signs downstream of attention turn score differences of 1e-4 into other
outputs. A CPU tensor takes the
plain PyTorch versions below. There is no fallback from the one to the
other, and no switch between backward implementations.

The conventions are the JAX package's: ``NEG_INF = -1e30`` for masked
scores, ``p`` only where ``s > NEG_INF / 2``, a correction of 0 while the
running max is still ``NEG_INF``, and a row with no key (``l == 0``)
gives out 0 and lse ``NEG_INF``. Causal masking is aligned bottom-right
(query i sees keys j <= i + Lk - Lq) and needs Lq <= Lk. The scale is
d^-0.5 of the real head_dim. Everything is fp32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _kernels

NEG_INF = -1e30  # finite stand-in for -inf (keeps exp() NaN-free)

# Key-block lengths of the plain versions: the forward's online softmax
# (K4's) and the chunked backward (K5/K6's) walk keys this many at a time.
# Module-level so tests can force several blocks at small L. The kernels
# use their own tiles of 64 (or 32) rows (csrc/flash_attn.cu, flash_bwd.cu).
FWD_BLOCK_K = 512
BWD_BLOCK_K = 512


def _bhld(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> (B, H, L, D) fp32."""
    return x.permute(0, 2, 1, 3).to(torch.float32)


def _invalid(q_pos: torch.Tensor, k_pos: torch.Tensor, lk: int,
             causal: bool, offset: int) -> torch.Tensor:
    """(Lq, bk) mask of the keys a query must not see: past Lk, and with
    ``causal`` past the bottom-right-aligned diagonal."""
    bad = (k_pos >= lk).expand(q_pos.shape[0], -1)
    if causal:
        bad = bad | (k_pos > q_pos + offset)
    return bad


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: the JAX kernel's online softmax over key
    blocks of ``FWD_BLOCK_K``. (B, Lq, H, D), (B, Lk, H, D) x2 ->
    out (B, Lq, H, D) and lse (B, Lq, H), fp32."""
    qt, kt, vt = _bhld(q), _bhld(k), _bhld(v)
    b, h, lq, d = qt.shape
    lk = kt.shape[2]
    scale = d ** -0.5
    m = torch.full((b, h, lq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, lq, 1), device=q.device)
    acc = torch.zeros((b, h, lq, d), device=q.device)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, FWD_BLOCK_K):
        kb, vb = kt[:, :, k0:k0 + FWD_BLOCK_K], vt[:, :, k0:k0 + FWD_BLOCK_K]
        k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kb) * scale
        s = s.masked_fill(_invalid(q_pos, k_pos, lk, causal, lk - lq),
                          NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new), 0.0)
        corr = torch.where(m > NEG_INF / 2, torch.exp(m - m_new), 0.0)
        m = m_new
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bhqk,bhkd->bhqd", p, vb)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = acc / safe_l
    lse = torch.where(l == 0.0, NEG_INF, m + torch.log(safe_l))
    return out.permute(0, 2, 1, 3), lse[..., 0].permute(0, 2, 1)


def _bwd_blocks(q, k, v, dout, lse, coeff, causal):
    """The chunked backward's key blocks, as ``_fa_bwd_chunked`` walks
    them: yields (p, ds, q, dout, k block) in (B, H, ...) fp32, with
    p forced to 0 for masked pairs and rows whose lse is NEG_INF."""
    qt, kt, vt, do = _bhld(q), _bhld(k), _bhld(v), _bhld(dout)
    b, h, lq, d = qt.shape
    lk = kt.shape[2]
    scale = d ** -0.5
    lse_t = lse.permute(0, 2, 1).to(torch.float32)[..., None]   # (B,H,Lq,1)
    coeff_t = coeff.permute(0, 2, 1).to(torch.float32)[..., None]
    q_pos = torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lk, BWD_BLOCK_K):
        kb, vb = kt[:, :, k0:k0 + BWD_BLOCK_K], vt[:, :, k0:k0 + BWD_BLOCK_K]
        k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kb) * scale
        invalid = _invalid(q_pos, k_pos, lk, causal, lk - lq) \
            | (lse_t < NEG_INF / 2)
        p = torch.where(invalid, 0.0, torch.exp(s - lse_t))
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vb)
        ds = p * (dp + coeff_t) * scale
        yield p, ds, qt, do, kb


def flash_bwd_dq_plain(q, k, v, dout, lse, coeff, causal) -> torch.Tensor:
    """K5's plain version: dq (B, Lq, H, D) = sum over key blocks of
    ds @ k_block."""
    dq = None
    for _, ds, _, _, kb in _bwd_blocks(q, k, v, dout, lse, coeff, causal):
        part = torch.einsum("bhqk,bhkd->bhqd", ds, kb)
        dq = part if dq is None else dq + part
    if dq is None:
        return torch.zeros_like(q, dtype=torch.float32)
    return dq.permute(0, 2, 1, 3)


def flash_bwd_dkv_plain(q, k, v, dout, lse, coeff, causal):
    """K6's plain version: per key block dv = p^T @ dout and
    dk = ds^T @ q -> (dk, dv), each (B, Lk, H, D)."""
    dks, dvs = [], []
    for p, ds, qt, do, _ in _bwd_blocks(q, k, v, dout, lse, coeff, causal):
        dvs.append(torch.einsum("bhqk,bhqd->bhkd", p, do))
        dks.append(torch.einsum("bhqk,bhqd->bhkd", ds, qt))
    if not dks:
        z = torch.zeros_like(k, dtype=torch.float32)
        return z, z.clone()
    return (torch.cat(dks, dim=2).permute(0, 2, 1, 3),
            torch.cat(dvs, dim=2).permute(0, 2, 1, 3))


def _device_of(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no flash attention for device {x.device}")


def _c32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = _c32(q), _c32(k), _c32(v)
        if _device_of(q) == "cuda":
            out, lse = _kernels.flash_fwd(q, k, v, causal)
        else:
            out, lse = flash_fwd_plain(q, k, v, causal)
            out, lse = out.contiguous(), lse.contiguous()
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, g_out, g_lse, ctx.causal)
        return dq, dk, dv, None


def _backward(q, k, v, out, lse, g_out, g_lse, causal: bool):
    """(dq, dk, dv) from the forward's operands and outputs and the
    cotangents of both outputs: ``coeff`` here, then K5 and K6 (or their
    plain versions on the CPU)."""
    do = _c32(g_out)
    coeff = _c32(g_lse - (do * out).sum(dim=-1))
    if _device_of(q) == "cuda":
        dq = _kernels.flash_bwd_dq(q, k, v, do, lse, coeff, causal)
        dk, dv = _kernels.flash_bwd_dkv(q, k, v, do, lse, coeff, causal)
    else:
        dq = flash_bwd_dq_plain(q, k, v, do, lse, coeff, causal)
        dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, coeff, causal)
    return dq, dk, dv


def flash_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention over (B, Lq, H, D) q and (B, Lk, H, D) k, v,
    returning fp32 out (B, Lq, H, D) and the per-row log-sum-exp
    (B, Lq, H). Differentiable in both outputs. Causal needs Lq <= Lk."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) \
            != (k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(
            f"want q (B, Lq, H, D) and k, v (B, Lk, H, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    lq, lk = q.shape[1], k.shape[1]
    if causal and lq > lk:
        # Bottom-right alignment leaves query rows < Lq - Lk with no key:
        # an ill-defined softmax, refused as the JAX package does.
        raise ValueError(
            f"causal attention requires Lq <= Lk, got Lq={lq} Lk={lk}"
        )
    return _FlashAttention.apply(q, k, v, bool(causal))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Flash attention over (B, L, H, D) inputs; output in q's dtype."""
    out, _ = flash_attention_with_lse(q, k, v, causal)
    return out.to(q.dtype)
