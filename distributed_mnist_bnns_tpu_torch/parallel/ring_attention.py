"""Ring attention: sequence parallelism over a process group.

Counterpart of the JAX package's ``parallel/ring_attention.py``. The
sequence is sharded over the ranks of a group, each rank keeps its Q
shard and passes K/V shards around the ring, accumulating exact softmax
attention by online rescaling, so the result is full attention while
the sequence grows with the number of ranks. Shapes are (B, L, H, D);
each rank holds its (B, L / n, H, D) shard of q, k and v, rank ``r``
positions ``[r * L/n, (r + 1) * L/n)``.

Where the JAX package runs one SPMD program over a mesh axis and moves
the shards with ``lax.ppermute``, here each rank is a process and the
shift is a point-to-point exchange with the ring neighbours
(``dist.batch_isend_irecv``: each rank's send and receive issued
together, so no rank blocks on its send). ``lax.ppermute`` transposes to
the reverse permute under ``jax.grad``; a received tensor here has no
autograd history, so the shift is an ``autograd.Function`` whose
backward sends the cotangent the other way. Every rank joins every
rotation, also of a step it skips, and every shifted shard stays in the
autograd graph, so that every rank runs every backward exchange.

On gloo, ``send`` and ``recv`` take host memory only: a CUDA shard is
staged through pinned host buffers there (NCCL sends device memory).

``local`` picks each step's computation:

  * ``"dense"``: the einsum online-softmax update;
  * ``"flash"``: ``ops.flash_attention_with_lse`` (K4 forward, K5/K6
    backward on a card), shards merged by their log-sum-exp in fp32 with
    the JAX package's ``NEG_INF / 2`` guards. Causal: the diagonal step
    runs the causal kernel, a shard from earlier positions (``step <=
    rank``) attends fully, one from later positions is skipped.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..ops.flash_attention import NEG_INF, flash_attention_with_lse

__all__ = ["attention_reference", "make_ring_attention"]

LOCALS = ("dense", "flash")


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False) -> torch.Tensor:
    """Full softmax attention: (B, L, H, D) -> (B, L, H, D); causal with
    bottom-right alignment when Lq < Lk, as the JAX package's."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        lq, lk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril(diagonal=lk - lq)
        scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


class _Ring:
    """This rank's place in the ring of ``group``: its index, size and
    global neighbour ranks, and the shift of a tensor by one place."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.index + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.index - 1) % self.size)
        self.gloo = dist.get_backend(group) == "gloo"

    def shift(self, t: torch.Tensor, forward: bool) -> torch.Tensor:
        """``t`` sent to the next rank and the previous rank's received
        (``forward``), or the other way round."""
        dst, src = (self.next, self.prev) if forward else (self.prev,
                                                           self.next)
        t = t.detach().contiguous()
        host = self.gloo and t.is_cuda
        if host:
            send = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            send.copy_(t)
            recv = torch.empty_like(send)
        else:
            send, recv = t, torch.empty_like(t)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, dst, self.group),
                dist.P2POp(dist.irecv, recv, src, self.group)]):
            req.wait()
        return recv.to(t.device) if host else recv


class _Shift(torch.autograd.Function):
    """One rotation of the ring; its backward sends the cotangent back
    (the transpose of the permutation, as ``lax.ppermute``'s)."""

    @staticmethod
    def forward(ctx, t, ring: _Ring):
        ctx.ring = ring
        return ring.shift(t, forward=True)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.shift(g, forward=False), None


class _Tie(torch.autograd.Function):
    """``out`` unchanged, with ``dangling`` joined to the graph at a zero
    cotangent: the last received shard of a rank that skipped its step
    still runs its backward exchange, which its neighbour waits for."""

    @staticmethod
    def forward(ctx, out, dangling):
        ctx.shape, ctx.dtype = dangling.shape, dangling.dtype
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros(ctx.shape, dtype=ctx.dtype, device=g.device)


def _rotate(kv: torch.Tensor, ring: _Ring) -> torch.Tensor:
    if ring.size == 1:
        return kv
    return _Shift.apply(kv, ring)


def _dense_local(q, k, v, ring: _Ring, causal: bool) -> torch.Tensor:
    """Online softmax over the shards as they pass (the JAX package's
    ``_block_attn_update``); the running max ``m`` takes no gradient:
    the output does not depend on it."""
    b, lq, h, d = q.shape
    scale = d ** -0.5
    m = torch.full((b, h, lq, 1), float("-inf"), dtype=q.dtype,
                   device=q.device)
    den = torch.zeros((b, h, lq, 1), dtype=q.dtype, device=q.device)
    acc = torch.zeros_like(q)
    q_pos = ring.index * lq + torch.arange(lq, device=q.device)[:, None]
    kv = torch.stack([k, v])
    for step in range(ring.size):
        k_cur, v_cur = kv[0], kv[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cur) * scale
        if causal:
            src = (ring.index - step) % ring.size
            k_pos = src * k_cur.shape[1] + torch.arange(
                k_cur.shape[1], device=q.device)[None, :]
            scores = scores.masked_fill(~(k_pos <= q_pos), float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True)).detach()
        p = torch.exp(scores - m_new)
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(dim=-1, keepdim=True)
        acc = (acc * corr.permute(0, 2, 1, 3)
               + torch.einsum("bhqk,bkhd->bqhd", p, v_cur))
        m = m_new
        if step + 1 < ring.size:
            kv = _rotate(kv, ring)
    return acc / den.permute(0, 2, 1, 3)


def _merge(carry, o_i, lse_i):
    """Fold one shard's (out, lse) into the running (max, den, num), in
    fp32, with the JAX package's guards against ``NEG_INF`` rows."""
    m_run, den, num = carry
    m_new = torch.maximum(m_run, lse_i)
    w_old = torch.where(m_run > NEG_INF / 2, torch.exp(m_run - m_new), 0.0)
    w_new = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - m_new), 0.0)
    return (m_new, den * w_old + w_new,
            num * w_old[..., None] + o_i * w_new[..., None])


def _flash_local(q, k, v, ring: _Ring, causal: bool) -> torch.Tensor:
    b, lq, h, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    carry = (torch.full((b, lq, h), NEG_INF, **f32),
             torch.zeros((b, lq, h), **f32), torch.zeros((b, lq, h, d), **f32))
    kv = torch.stack([k, v])
    used = True
    for step in range(ring.size):
        used = not causal or step <= ring.index
        if used:
            o_i, lse_i = flash_attention_with_lse(
                q, kv[0], kv[1], causal and step == 0)
            carry = _merge(carry, o_i, lse_i)
        if step + 1 < ring.size:
            kv = _rotate(kv, ring)
    _, den, num = carry
    out = num / torch.where(den == 0.0, 1.0, den)[..., None]
    if not used:
        out = _Tie.apply(out, kv)
    return out.to(q.dtype)


def make_ring_attention(group=None, *, axis: str = "seq",
                        causal: bool = False,
                        local: str = "dense") -> Callable:
    """Build ``f(q, k, v)`` over each rank's (B, L/n, H, D) sequence shard
    of ``group``: a process group (None: the default group), or a
    ``parallel.Mesh`` whose ``axis`` line is the ring (the seq subgroup
    of a (data, seq) grid: each data row runs its own ring). Exact
    attention of the whole sequence, this rank's rows; causal masking by
    the global positions of each shard. Differentiable."""
    if local not in LOCALS:
        raise ValueError(f"unknown local={local!r} (have: dense, flash)")
    if group is not None and hasattr(group, "group"):
        group = group.group(axis)
    group = group if group is not None else dist.group.WORLD
    ring = _Ring(group)
    step = _flash_local if local == "flash" else _dense_local

    def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
        if q.shape != k.shape or k.shape != v.shape or q.dim() != 4:
            raise ValueError(
                f"want equal (B, L/n, H, D) shards, got {tuple(q.shape)}, "
                f"{tuple(k.shape)}, {tuple(v.shape)}")
        return step(q, k, v, ring, causal)

    return attend
