"""Block-paged KV cache: the allocator and the device primitives behind the
continuous-batching LM engine (``serve/lm/``).

Counterpart of the JAX package's ``ops/paged_kv.py``. A sequence's K/V
lives in fixed-size **pages** drawn from one shared pool; the sequence
holds a *page table* (the ids of its pages in order), pages are
allocated at admission and returned the moment the sequence finishes, and
attention addresses the cache through the table, so requests join and
leave the decode batch at any iteration while every call keeps one shape
(fixed slot count, fixed table width).

Layout and conventions, the JAX package's:

  * a K (or V) pool is ``(num_pages, page_size, H, D)`` fp32; logical
    position ``p`` of a sequence lives at page ``table[p // page_size]``,
    offset ``p % page_size``;
  * **page 0 is the null page**: never allocated, it absorbs the writes
    of inactive batch slots and of padding positions, so a fixed-shape
    scatter needs no masking. Its contents are garbage and always masked
    out of attention (positions past a query's own are masked);
  * page tables are host-side int32 arrays ``(max_pages,)`` per sequence,
    0-filled past the allocated prefix.

``write_kv`` updates the pool **in place** (``index_copy_`` on its flat
view): the pool is the engine's largest buffer and is never copied per
token. That takes the place of the JAX package's buffer donation.

Attention comes in two forms with one semantics. The **plain versions**
(``paged_attention``, ``paged_verify_attention``,
``paged_prefill_attention``) gather the table's pages into a contiguous
strip and run a masked softmax; they are the CPU path and the reference.
The **kernel entries** (``paged_attention_kernel`` and its verify and
prefill twins) walk the page table inside kernel K8
(``csrc/paged_attn.cu``) on a CUDA tensor, with no gather, and raise if
the kernel cannot run; on a CPU tensor they take the plain version. K8
serves all the queries of a (head, slot), up to 16 (a decode slot's
one, a verify window, a prefill chunk), from one cluster of blocks that
stages each tile of 16 key positions once for all of them, and each
call is one launch.
A query's output bits depend only on its own q, position, table row and
the pools, not on the other queries of the call, so a stream decoded
beside others equals the same stream decoded alone.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..infer import resolve_device
from . import _kernels

NULL_PAGE = 0
NEG_INF = -1e30  # the masked score of the JAX package's kernels


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages required to hold ``n_tokens`` positions."""
    if n_tokens <= 0:
        return 0
    return -(-int(n_tokens) // int(page_size))


class PageAllocator:
    """Refcounted free-list allocator over ``num_pages`` pages; page 0
    reserved. A copy of the JAX package's (pure Python there too).

    ``alloc`` is all-or-nothing: a request that cannot get every page it
    asked for gets none. Pages carry refcounts so sequences can share an
    immutable prompt prefix: ``alloc`` returns pages at refcount 1,
    ``fork`` takes an extra reference on live pages, and ``free``
    releases one reference; a page returns to the free list when its
    last holder releases it. Releasing a page whose refcount is already
    0, or the same page twice in one call, or the null page, is a hard
    error. Thread-safe.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(
                f"need >= 2 pages (page 0 is the reserved null page), "
                f"got {num_pages}"
            )
        self.num_pages = int(num_pages)
        self._lock = threading.Lock()
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._refs: List[int] = [0] * self.num_pages

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the null page)."""
        return self.num_pages - 1

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def used_count(self) -> int:
        return self.capacity - self.free_count()

    def occupancy(self) -> float:
        """Fraction of allocatable pages currently held, in [0, 1]."""
        return self.used_count() / max(self.capacity, 1)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` page ids at refcount 1, or None if fewer are free."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        with self._lock:
            if len(self._free) < n:
                return None
            out = [self._free.pop() for _ in range(n)]
            for p in out:
                self._refs[p] = 1
        return out

    def fork(self, pages: Sequence[int]) -> None:
        """Take one extra reference on each live page. Forking a free or
        an out-of-range page is a hard error."""
        with self._lock:
            for p in pages:
                p = int(p)
                if p == NULL_PAGE or not 0 < p < self.num_pages:
                    raise ValueError(f"cannot fork page {p}")
                if self._refs[p] <= 0:
                    raise ValueError(f"fork of free page {p}")
            for p in pages:
                self._refs[int(p)] += 1

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs[int(page)]

    def free(self, pages: Sequence[int]) -> None:
        """Release one reference per page; a page returns to the free
        list only when its last holder releases it."""
        with self._lock:
            seen = set()
            for p in pages:
                p = int(p)
                if p == NULL_PAGE or not 0 < p < self.num_pages:
                    raise ValueError(f"cannot free page {p}")
                if p in seen or self._refs[p] <= 0:
                    raise ValueError(f"double free of page {p}")
                seen.add(p)
            for p in pages:
                p = int(p)
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)


def init_pools(
    num_blocks: int, num_pages: int, page_size: int,
    num_heads: int, head_dim: int, *, device=None,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
    """Zeroed per-block (K, V) page pools ``((k0, v0), (k1, v1), ...)``,
    each ``(num_pages, page_size, H, D)`` fp32 on ``device``: ``None``
    means ``"cuda"``, and a CUDA device without a card raises
    (``infer.resolve_device``); pass ``device="cpu"`` for CPU pools."""
    device = resolve_device(device)
    shape = (int(num_pages), int(page_size), int(num_heads), int(head_dim))
    return tuple(
        (torch.zeros(shape, device=device), torch.zeros(shape, device=device))
        for _ in range(int(num_blocks))
    )


# ---------------------------------------------------------------------------
# Indices and the in-place write
# ---------------------------------------------------------------------------


def flat_write_indices(
    page_table: torch.Tensor, positions: torch.Tensor,
    page_size: int, valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flat row indices into a ``(num_pages * page_size, ...)`` pool view
    for writing ``positions`` of the sequence(s) ``page_table`` describes.

    ``page_table`` is (..., P) int with leading dims matching
    ``positions`` (...,), or one shared ``(P,)`` table for a batch of
    positions (chunked prefill). Positions flagged invalid, or whose page
    index overruns the table, go to the null page, so the write stays in
    bounds without a branch. Returns int64 indices."""
    ps = int(page_size)
    max_pages = page_table.shape[-1]
    positions = positions.to(torch.int64)
    page_idx = torch.clamp(positions // ps, 0, max_pages - 1)
    table = page_table.to(torch.int64)
    if table.dim() == 1:
        page = table[page_idx]
    else:
        page = torch.gather(table, -1, page_idx[..., None])[..., 0]
    ok = positions // ps < max_pages
    if valid is not None:
        ok = ok & valid
    page = torch.where(ok, page, torch.full_like(page, NULL_PAGE))
    return page * ps + positions % ps


def write_kv(
    pool: torch.Tensor, flat_idx: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """Write ``rows`` (..., H, D) into ``pool`` in place at ``flat_idx``
    rows of its flat ``(num_pages * page_size, H, D)`` view, and return
    the pool. Duplicate indices only ever land in the null page, whose
    contents are garbage by design. The write is issued on the current
    stream, so attention launched after it on that stream sees it."""
    n, ps, h, d = pool.shape
    pool.view(n * ps, h, d).index_copy_(
        0, flat_idx.reshape(-1).to(torch.int64),
        rows.reshape(-1, h, d).to(pool.dtype),
    )
    return pool


def gather_kv(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """The logical cache strip(s) a page table describes: ``page_table``
    (..., P) over a ``(num_pages, page_size, H, D)`` pool ->
    (..., P * page_size, H, D); row ``l`` is logical position ``l``.
    Rows drawn through null-page entries are garbage and must be masked
    downstream."""
    n, ps, h, d = pool.shape
    gathered = pool[page_table.to(torch.int64)]       # (..., P, ps, H, D)
    return gathered.reshape(*page_table.shape[:-1],
                            page_table.shape[-1] * ps, h, d)


# ---------------------------------------------------------------------------
# Plain versions: gather, then masked softmax (K8's reference)
# ---------------------------------------------------------------------------


def paged_attn_plain(
    q4: torch.Tensor, qpos: torch.Tensor, k_pool: torch.Tensor,
    v_pool: torch.Tensor, tables: torch.Tensor,
) -> torch.Tensor:
    """K8's plain version: queries ``q4`` (S, C, H, D) at positions
    ``qpos`` (S, C) attend to the keys at positions <= their own through
    ``tables`` (S, P). Later keys are masked to -inf before the softmax.
    Every row needs at least position 0 unmasked (qpos >= 0)."""
    kc = gather_kv(k_pool, tables)                    # (S, L, H, D)
    vc = gather_kv(v_pool, tables)
    scale = q4.shape[-1] ** -0.5
    scores = torch.einsum("schd,slhd->schl", q4, kc) * scale
    l = kc.shape[1]
    kpos = torch.arange(l, device=q4.device)
    mask = kpos[None, None, :] <= qpos.to(torch.int64)[:, :, None]  # (S,C,L)
    scores = scores.masked_fill(~mask[:, :, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("schl,slhd->schd", probs, vc)


def paged_attention(q, k_pool, v_pool, page_tables, positions):
    """Single-position attention through page tables: ``q`` (S, H, D),
    one query per slot at ``positions`` (S,) (its K/V already written);
    ``page_tables`` (S, P). Returns (S, H, D)."""
    return paged_attn_plain(
        q[:, None], positions[:, None], k_pool, v_pool, page_tables
    )[:, 0]


def _verify_positions(q, positions):
    return positions.to(torch.int32)[:, None] + torch.arange(
        q.shape[1], dtype=torch.int32, device=positions.device
    )[None, :]


def paged_verify_attention(q, k_pool, v_pool, page_tables, positions):
    """K-position attention: ``q`` (S, K, H, D), query j of slot s at
    global position ``positions[s] + j``, causal through the slot's
    table. Returns (S, K, H, D)."""
    return paged_attn_plain(
        q, _verify_positions(q, positions), k_pool, v_pool, page_tables
    )


def paged_prefill_attention(q, k_pool, v_pool, page_table, q_positions):
    """Chunked-prefill attention for ONE sequence: ``q`` (C, H, D) at
    ``q_positions`` (C,), causal through its table (P,). Padding queries
    past the real length give finite garbage rows the caller ignores."""
    return paged_attn_plain(
        q[None], q_positions[None], k_pool, v_pool, page_table[None]
    )[0]


# ---------------------------------------------------------------------------
# Kernel entries (K8 on a CUDA tensor, the plain version on a CPU one)
# ---------------------------------------------------------------------------


def _paged_attention(q4, qpos, k_pool, v_pool, tables):
    if q4.is_cuda:
        return _kernels.paged_attn(
            q4.to(torch.float32).contiguous(),
            qpos.to(torch.int32).contiguous(),
            k_pool, v_pool, tables.to(torch.int32).contiguous(),
        )
    if q4.device.type != "cpu":
        raise ValueError(f"no paged attention for device {q4.device}")
    return paged_attn_plain(q4, qpos, k_pool, v_pool, tables)


def paged_attention_kernel(q, k_pool, v_pool, page_tables, positions):
    """Kernel twin of :func:`paged_attention`: same signature and
    semantics, no materialised gather."""
    return _paged_attention(
        q[:, None], positions[:, None], k_pool, v_pool, page_tables
    )[:, 0]


def paged_verify_attention_kernel(q, k_pool, v_pool, page_tables, positions):
    """Kernel twin of :func:`paged_verify_attention`."""
    return _paged_attention(
        q, _verify_positions(q, positions), k_pool, v_pool, page_tables
    )


def paged_prefill_attention_kernel(q, k_pool, v_pool, page_table, q_positions):
    """Kernel twin of :func:`paged_prefill_attention`."""
    return _paged_attention(
        q[None], q_positions[None], k_pool, v_pool, page_table[None]
    )[0]
