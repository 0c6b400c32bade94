"""1-bit gradient compression for the data-parallel exchange.

Counterpart of the JAX package's ``ops/comm_compress.py``: per-bucket
**sign bitplanes** (int32 words in ``ops/bitpack``'s format) plus one
fp32 **scale per bucket** (mean |g|), combined as signSGD with majority
vote (Bernstein et al., 2018) or as the mean of scale * sign with error
feedback (EF-SignSGD, Karimireddy et al., 2019; the second residual as
in 1-bit Adam).

Exchange topology, two compressed phases:

  phase 1 (compressed reduce-scatter): the flattened gradient is split
      into ``world`` segments; an all-to-all routes every worker's
      sign planes and scales for segment *j* to worker *j*, which
      decodes the ``world`` contributions and combines them (mean of
      scale * sign, or the majority vote over raw signs);
  phase 2 (compressed all-gather): each segment owner re-compresses its
      combined segment and an all-gather hands the result to everyone.

Per-worker wire bytes are ``2*(N-1)/N * (D/8 + 4*n_buckets)`` against
the fp32 ring all-reduce's ``2*(N-1)/N * 4*D`` (``CommPlan``).

The JAX functions take a mesh ``axis_name``; these take a
``torch.distributed`` process group, and ``group=None`` means world 1:
no collective runs and the pipeline is local compress/decompress, as in
JAX. ``lax.all_to_all(split_axis=0, concat_axis=0)`` is
``all_to_all_single`` on the contiguous ``(world, nbc, W)`` planes, and
``lax.all_gather(axis=0)`` is ``all_gather`` into the rows of a
``(world, ...)`` tensor. Every collective adds the bytes it moves for
this worker to a ``WireBytes`` counter, if one is given: an all-to-all
(N-1)/N of its input, an all-gather the other workers' parts of its
output, a ring all-reduce 2 (N-1)/N of its buffer (half in the
reduce-scatter phase, half in the all-gather phase). So the wire bytes
are measured from the buffers the collectives were handed, and
``CommPlan`` is the model they are held to.

SPMD lockstep contract, as in JAX: the collective schedule (2 * chunks
all-to-alls and 2 * chunks all-gathers per exchange, in plan order)
depends only on the plan and the group, never on gradient values or
the rank. Every collective here blocks, so the chunks, which XLA may
overlap in JAX, only split the calls; scales are per bucket, so the
result and the bytes do not depend on their number.

Over gloo the collectives take CUDA tensors as they are (all-to-all,
all-gather, all-reduce and broadcast, PyTorch 2.11 on an H100): gloo
copies them through the host itself, and compression and decompression
stay on the device.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from .bitpack import WORD_BITS, pack_bits, unpack_bits

MODES = ("none", "sign", "sign_ef")


def _signs(x: torch.Tensor) -> torch.Tensor:
    """±1 with the pack_bits convention (bit = 1 ⟺ value > 0)."""
    return torch.where(x > 0, 1.0, -1.0).to(x.dtype)


@dataclass(frozen=True)
class CommPlan:
    """Static shape and byte accounting for one compressed exchange
    (the JAX ``CommPlan``; the ring model: a ring all-reduce of D fp32
    values moves ``2*(N-1)/N * 4*D`` bytes per worker, each compressed
    phase ``(N-1)/N`` of one worker's full compressed message)."""

    mode: str           # "sign" | "sign_ef" | "fp32" (uncompressed DP)
    world: int          # data-parallel workers
    n_params: int       # true flattened gradient length D
    bucket_size: int    # elements per scale bucket (multiple of 32)
    chunks: int         # groups over the bucket axis (split the calls)
    nb: int             # buckets per segment
    padded: int         # world * nb * bucket_size >= n_params
    layout: str = "dp"  # "dp" | "fsdp" (labels only; same byte model)

    @property
    def seg(self) -> int:
        return self.nb * self.bucket_size

    @property
    def words(self) -> int:
        return self.bucket_size // WORD_BITS

    @property
    def message_bytes(self) -> int:
        """One worker's full compressed gradient: sign planes + scales."""
        return self.padded // 8 + 4 * self.world * self.nb

    @property
    def fp32_bytes_per_step(self) -> int:
        """Ring all-reduce cost of the uncompressed fp32 gradient."""
        return int(2 * (self.world - 1) / max(self.world, 1)
                   * 4 * self.n_params)

    @property
    def wire_bytes_rs(self) -> int:
        """Reduce-scatter-phase bytes per worker per step."""
        if self.world <= 1:
            return 0
        if self.mode == "fp32":
            return int((self.world - 1) / self.world * 4 * self.n_params)
        return int((self.world - 1) / self.world * self.message_bytes)

    @property
    def wire_bytes_ag(self) -> int:
        """All-gather-phase bytes per worker per step."""
        return self.wire_bytes_per_step - self.wire_bytes_rs

    @property
    def wire_bytes_per_step(self) -> int:
        if self.world <= 1:
            return 0
        if self.mode == "fp32":
            return self.fp32_bytes_per_step
        return int(2 * (self.world - 1) / self.world * self.message_bytes)

    @property
    def saved_bytes_per_step(self) -> int:
        return max(self.fp32_bytes_per_step - self.wire_bytes_per_step, 0)

    @property
    def wire_ratio(self) -> Optional[float]:
        """Wire bytes as a fraction of the fp32 exchange (None when
        there is no exchange)."""
        if self.fp32_bytes_per_step == 0:
            return None
        return self.wire_bytes_per_step / self.fp32_bytes_per_step


def make_plan(n_params: int, *, world: int, mode: str,
              bucket_size: int = 1024, chunks: int = 4,
              layout: str = "dp") -> CommPlan:
    """Size the segment/bucket layout for a D-element gradient;
    ``bucket_size`` must be a multiple of 32."""
    if mode not in ("sign", "sign_ef", "fp32"):
        raise ValueError(f"unknown compression mode {mode!r} "
                         "(have: sign, sign_ef, fp32)")
    if layout not in ("dp", "fsdp"):
        raise ValueError(f"unknown comm layout {layout!r} (have: dp, fsdp)")
    if bucket_size <= 0 or bucket_size % WORD_BITS:
        raise ValueError(f"bucket_size must be a positive multiple of "
                         f"{WORD_BITS}, got {bucket_size}")
    world = max(int(world), 1)
    nb = max(-(-n_params // (world * bucket_size)), 1)
    chunks = max(min(int(chunks), nb), 1)
    return CommPlan(mode=mode, world=world, n_params=int(n_params),
                    bucket_size=int(bucket_size), chunks=chunks, nb=nb,
                    padded=world * nb * bucket_size, layout=layout)


# -- counted collectives -----------------------------------------------------


class WireBytes(Counter):
    """Bytes this worker moved through its collectives, keyed by
    ``(level, phase)``: level ``"inter"`` for the exchange (the flat one
    included) and ``"intra"`` for a hierarchical run's in-host fp32
    all-reduce; phase ``"rs"`` or ``"ag"``."""

    def bytes(self, phase: Optional[str] = None,
              level: Optional[str] = None) -> int:
        return sum(n for (lv, ph), n in self.items()
                   if (phase is None or ph == phase)
                   and (level is None or lv == level))


def _count(wire: Optional[WireBytes], level: str, phase: str,
           n: int) -> None:
    if wire is not None:
        wire[(level, phase)] += n


def all_to_all(x: torch.Tensor, group, wire: Optional[WireBytes] = None,
               *, level: str = "inter", phase: str = "rs") -> torch.Tensor:
    """Row j of the ``(world, ...)`` input goes to worker j; row i of the
    output came from worker i (``lax.all_to_all(split_axis=0,
    concat_axis=0)``)."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    world = dist.get_world_size(group)
    _count(wire, level, phase, (world - 1) * x.nbytes // world)
    return out


def all_gather(x: torch.Tensor, group, wire: Optional[WireBytes] = None,
               *, level: str = "inter", phase: str = "ag") -> torch.Tensor:
    """``(world, *x.shape)``: row i is worker i's ``x``
    (``lax.all_gather(axis=0)``)."""
    x = x.contiguous()
    world = dist.get_world_size(group)
    out = x.new_empty((world, *x.shape))
    dist.all_gather(list(out.unbind(0)), x, group=group)
    _count(wire, level, phase, (world - 1) * x.nbytes)
    return out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (a new tensor; not counted)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def broadcast(x: torch.Tensor, group=None) -> torch.Tensor:
    """The group's first rank's ``x``, on every rank (a new tensor; not
    counted)."""
    out = x.contiguous().clone()
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(out, src, group=group)
    return out


def all_reduce_mean(x: torch.Tensor, group,
                    wire: Optional[WireBytes] = None, *,
                    level: str = "inter") -> torch.Tensor:
    """``lax.pmean``: the sum over the group divided by its size.
    Counted as a ring all-reduce of ``x``: (N-1)/N of its bytes in each
    of the reduce-scatter and all-gather phases."""
    world = dist.get_world_size(group)
    rs = (world - 1) * x.nbytes // world
    _count(wire, level, "rs", rs)
    _count(wire, level, "ag", 2 * (world - 1) * x.nbytes // world - rs)
    return all_reduce_sum(x, group) / world


# -- compression and the two phases -----------------------------------------


def compress_buckets(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., B) -> (planes (..., B/32) int32, scale (...,) = mean |x|)."""
    return pack_bits(x), x.abs().mean(dim=-1)


def decompress_buckets(planes: torch.Tensor, scale: torch.Tensor,
                       bucket_size: int) -> torch.Tensor:
    """(..., B/32) planes + (...,) scales -> (..., B) ``scale * sign``."""
    return unpack_bits(planes, bucket_size) * scale[..., None]


def _chunk_slices(plan: CommPlan) -> Iterator[slice]:
    """The bucket-axis slices of the chunks, one after another."""
    per = -(-plan.nb // plan.chunks)
    for c in range(plan.chunks):
        sl = slice(c * per, min((c + 1) * per, plan.nb))
        if sl.start >= plan.nb:
            return
        yield sl


def reduce_scatter_compressed(
    flat: torch.Tensor, plan: CommPlan, *, group,
    wire: Optional[WireBytes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: the 1-bit compressed reduce-scatter of this worker's
    (plan.padded,) gradient. Returns ``(own, sent)``: the combined
    gradient of the (plan.seg,) segment this worker owns, and the
    (plan.padded,) values this worker's message decodes to."""
    world, nb, b = plan.world, plan.nb, plan.bucket_size
    x = flat.reshape(world, nb, b)
    own, sent = [], []
    for sl in _chunk_slices(plan):
        planes, scale = compress_buckets(x[:, sl])     # (world, nbc, ...)
        sent.append(decompress_buckets(planes, scale, b))
        if group is not None:
            planes = all_to_all(planes, group, wire)
            scale = all_to_all(scale, group, wire)
        if plan.mode == "sign":
            votes = unpack_bits(planes, b).sum(dim=0)
            y = _signs(votes) * scale.mean(dim=0)[..., None]
        else:
            y = decompress_buckets(planes, scale, b).mean(dim=0)
        own.append(y)
    return (torch.cat(own, dim=0).reshape(plan.seg),
            torch.cat(sent, dim=1).reshape(plan.padded))


def all_gather_compressed(
    seg: torch.Tensor, plan: CommPlan, *, group,
    wire: Optional[WireBytes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 2: the 1-bit compressed all-gather of this worker's
    (plan.seg,) segment. Returns ``(full, own_dec)``: the (plan.padded,)
    decoded broadcast, identical on every worker, and what this worker's
    own segment decodes to."""
    nb, b = plan.nb, plan.bucket_size
    y = seg.reshape(nb, b)
    full, own_dec = [], []
    for sl in _chunk_slices(plan):
        planes, scale = compress_buckets(y[sl])
        dec = decompress_buckets(planes, scale, b)     # (nbc, B)
        own_dec.append(dec)
        if group is not None:
            planes = all_gather(planes, group, wire)
            scale = all_gather(scale, group, wire)
            full.append(decompress_buckets(planes, scale, b))
        else:
            full.append(dec[None])
    return (torch.cat(full, dim=1).reshape(plan.padded),
            torch.cat(own_dec, dim=0).reshape(plan.seg))


def exchange(
    flat: torch.Tensor, plan: CommPlan, *, group,
    e2: Optional[torch.Tensor] = None, wire: Optional[WireBytes] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The two-phase compressed exchange of a padded flat gradient.

    flat: (plan.padded,) this worker's (error-corrected) gradient;
    e2:   (plan.seg,) this worker's segment-owner residual (sign_ef).

    Returns ``(combined, sent, e2_new)``: the decoded global update,
    identical on every worker; what this worker's phase-1 message
    decodes to; the updated segment residual (None without ``e2``)."""
    y, sent = reduce_scatter_compressed(flat, plan, group=group, wire=wire)
    if e2 is not None:
        y = y + e2
    combined, own_dec = all_gather_compressed(y, plan, group=group,
                                              wire=wire)
    e2_new = None if e2 is None else y - own_dec
    return combined, sent, e2_new


# -- two-level hierarchical exchange -----------------------------------------


@dataclass(frozen=True)
class HierPlan:
    """Accounting for one two-level (hosts x local) exchange: an fp32
    ring all-reduce inside each host, then the flat compressed ``inter``
    plan over the hosts."""

    inter: CommPlan     # compressed plan over the inter-host group
    local: int          # ranks per host

    @property
    def hosts(self) -> int:
        return self.inter.world

    @property
    def world(self) -> int:
        return self.hosts * self.local

    @property
    def intra_bytes_per_step(self) -> int:
        """fp32 ring all-reduce over a host's ranks, per rank per step."""
        if self.local <= 1:
            return 0
        return int(2 * (self.local - 1) / self.local * 4
                   * self.inter.n_params)

    @property
    def inter_bytes_per_step(self) -> int:
        """The 1-bit two-phase exchange over the hosts, per step."""
        return self.inter.wire_bytes_per_step

    @property
    def flat_fp32_bytes_per_step(self) -> int:
        """A flat fp32 ring all-reduce over the whole world."""
        if self.world <= 1:
            return 0
        return int(2 * (self.world - 1) / self.world * 4
                   * self.inter.n_params)

    @property
    def inter_ratio_vs_flat_fp32(self) -> Optional[float]:
        if self.flat_fp32_bytes_per_step == 0:
            return None
        return self.inter_bytes_per_step / self.flat_fp32_bytes_per_step


def make_hier_plan(n_params: int, *, hosts: int, local: int, mode: str,
                   bucket_size: int = 1024, chunks: int = 4,
                   layout: str = "dp") -> HierPlan:
    """A flat compressed plan over ``hosts`` segment owners, plus the
    ``local`` in-host fanout."""
    if local < 1:
        raise ValueError(f"local must be >= 1, got {local}")
    inter = make_plan(n_params, world=hosts, mode=mode,
                      bucket_size=bucket_size, chunks=chunks, layout=layout)
    return HierPlan(inter=inter, local=int(local))


def hier_exchange(
    flat: torch.Tensor, hier: HierPlan, *, host_group, local_group,
    e2: Optional[torch.Tensor] = None, wire: Optional[WireBytes] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """fp32 mean over ``local_group`` (the in-host all-reduce), then the
    two-phase 1-bit exchange over ``host_group``; returns as
    ``exchange``. With both groups None it is local compress/decompress.

    ``flat`` is the (inter.padded,) padded gradient; its pad is zero, so
    only the first ``n_params`` values are all-reduced (what
    ``HierPlan.intra_bytes_per_step`` counts) and the mean is the same."""
    if local_group is not None:
        n = hier.inter.n_params
        flat = torch.cat([all_reduce_mean(flat[:n], local_group, wire,
                                          level="intra"), flat[n:]])
    return exchange(flat, hier.inter, group=host_group, e2=e2, wire=wire)


def pad_flat(flat: torch.Tensor, plan: CommPlan) -> torch.Tensor:
    """Zero-pad the true-D flat gradient to the plan's padded length."""
    return torch.nn.functional.pad(flat, (0, plan.padded - plan.n_params))


def tree_size(tensors) -> int:
    """Element count of an iterable of tensors (e.g. ``parameters()``)."""
    return sum(int(t.numel()) for t in tensors)
