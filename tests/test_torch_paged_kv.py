"""The PyTorch port's paged KV cache against the JAX package's.

``PageAllocator`` is a copy and must behave the same; ``flat_write_indices``
and ``write_kv`` are bitwise equal to JAX; K8's plain versions (the
gather path) and its kernel entries on CPU tensors (which take the plain
version) match both the JAX gather path and the JAX Pallas kernel run
with ``interpret=True``, to atol = rtol = 1e-5 (the tolerance of
``tests/test_paged_kv.py``: the softmax sums run in other orders). The
cases are those of ``tests/test_paged_kv.py``.

K8 itself runs only on a card. ``k8_emulation`` repeats its arithmetic
order in plain torch (tiles of 16 positions, tile j to partition j mod
16, an online softmax per partition, the merge in partition order, every
fp32 rounding where the kernel rounds), so its blocking and masking are
held here to the JAX kernel and the gather path at 1e-5, and a query's
bits are held equal whether it is launched alone or with others.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops import paged_kv as jpk
from distributed_mnist_bnns_tpu_torch.ops import _kernels
from distributed_mnist_bnns_tpu_torch.ops import paged_kv as tpk

TOL = dict(atol=1e-5, rtol=1e-5)


def _filled(num_pages, ps, h, d, slots, seed):
    """Pools (numpy) holding random rows written through each slot's
    (table, length); also random garbage in every other row, the null
    page included, as a freed page's old K/V would be."""
    rng = np.random.RandomState(seed)
    kp = rng.randn(num_pages, ps, h, d).astype(np.float32)
    vp = rng.randn(num_pages, ps, h, d).astype(np.float32)
    for table, length in slots:
        for pos in range(length):
            page, off = table[pos // ps], pos % ps
            kp[page, off] = rng.randn(h, d)
            vp[page, off] = rng.randn(h, d)
    return kp, vp


def _both(kind, q, kp, vp, tables, pos):
    """(JAX gather, JAX Pallas interpret, port plain, port kernel entry)."""
    jfn = {"decode": (jpk.paged_attention, jpk.paged_attention_kernel),
           "verify": (jpk.paged_verify_attention,
                      jpk.paged_verify_attention_kernel),
           "prefill": (jpk.paged_prefill_attention,
                       jpk.paged_prefill_attention_kernel)}[kind]
    tfn = {"decode": (tpk.paged_attention, tpk.paged_attention_kernel),
           "verify": (tpk.paged_verify_attention,
                      tpk.paged_verify_attention_kernel),
           "prefill": (tpk.paged_prefill_attention,
                       tpk.paged_prefill_attention_kernel)}[kind]
    jargs = [jnp.asarray(a) for a in (q, kp, vp, tables, pos)]
    targs = [torch.from_numpy(np.asarray(a)) for a in (q, kp, vp, tables, pos)]
    return (np.asarray(jfn[0](*jargs)),
            np.asarray(jfn[1](*jargs, interpret=True)),
            tfn[0](*targs).numpy(), tfn[1](*targs).numpy())


def _check(outs):
    jgather, jkernel, plain, entry = outs
    np.testing.assert_allclose(plain, jgather, **TOL)
    np.testing.assert_allclose(plain, jkernel, **TOL)
    np.testing.assert_array_equal(entry, plain)
    assert np.isfinite(plain).all()


# -- K8 plain versions and entries against both JAX paths ---------------------


def test_decode_boundary_spans_and_scrambled_pages():
    ps, h, d = 4, 2, 8
    lens = [4, 5, 11, 12]       # exact page, one past, mid-page, multi-page
    tables = np.zeros((4, 3), np.int32)
    tables[0, :1] = [7]
    tables[1, :2] = [3, 9]
    tables[2, :3] = [10, 1, 6]
    tables[3, :3] = [5, 11, 2]
    kp, vp = _filled(12, ps, h, d, zip(tables, lens), seed=0)
    q = np.random.RandomState(1).randn(4, h, d).astype(np.float32)
    pos = np.asarray([l - 1 for l in lens], np.int32)
    _check(_both("decode", q, kp, vp, tables, pos))


def test_decode_null_page_slots():
    """An inactive slot (all-null table, position 0) attends to the null
    page's garbage: finite, and the same in every implementation."""
    ps, h, d = 4, 2, 4
    tables = np.zeros((3, 3), np.int32)
    tables[0, :2] = [2, 5]
    tables[2, :1] = [7]
    kp, vp = _filled(8, ps, h, d, [(tables[0], 6), (tables[2], 3)], seed=2)
    q = np.random.RandomState(3).randn(3, h, d).astype(np.float32)
    _check(_both("decode", q, kp, vp, tables,
                 np.asarray([5, 0, 2], np.int32)))


def test_reuse_after_early_termination():
    """Pages freed by one sequence and handed to another in a different
    order: only the new table's rows count."""
    ps, h, d = 4, 1, 4
    alloc = tpk.PageAllocator(6)
    first = alloc.alloc(3)
    kp, vp = _filled(6, ps, h, d, [(first, 10)], seed=4)
    alloc.free(first)
    second = alloc.alloc(3)
    assert sorted(second) == sorted(first)
    table = np.asarray(second[::-1], np.int32)
    rng = np.random.RandomState(5)
    for pos in range(9):                     # overwrite 9 of the 10 rows
        kp[table[pos // ps], pos % ps] = rng.randn(h, d)
        vp[table[pos // ps], pos % ps] = rng.randn(h, d)
    q = rng.randn(1, h, d).astype(np.float32)
    _check(_both("decode", q, kp, vp, table[None],
                 np.asarray([8], np.int32)))


def test_verify_window_straddles_pages():
    ps, h, d, k = 4, 2, 4, 3
    lens = [7, 10]
    tables = np.zeros((2, 3), np.int32)
    tables[0, :2] = [6, 1]
    tables[1, :3] = [4, 8, 2]
    kp, vp = _filled(10, ps, h, d, zip(tables, lens), seed=6)
    q = np.random.RandomState(7).randn(2, k, h, d).astype(np.float32)
    pos = np.asarray([lens[0] - k, lens[1] - k], np.int32)
    _check(_both("verify", q, kp, vp, tables, pos))


def test_prefill_with_padding_queries_past_the_table():
    """Chunk 8..15 of a 9-token sequence in a 3-page table: queries past
    the length (and past the table's 12 positions) give the same finite
    garbage everywhere."""
    ps, h, d = 4, 2, 4
    table = np.asarray([5, 2, 7], np.int32)
    kp, vp = _filled(8, ps, h, d, [(table, 9)], seed=8)
    q = np.random.RandomState(9).randn(8, h, d).astype(np.float32)
    _check(_both("prefill", q, kp, vp, table,
                 np.arange(8, 16, dtype=np.int32)))


def test_plain_matches_dense_softmax_over_the_prefix():
    ps, h, d = 4, 2, 4
    tables = np.zeros((2, 3), np.int32)
    tables[0, :3] = [5, 2, 7]
    tables[1, :2] = [1, 4]
    kp, vp = _filled(8, ps, h, d, [(tables[0], 9), (tables[1], 5)], seed=10)
    q = np.random.RandomState(11).randn(2, h, d).astype(np.float32)
    got = tpk.paged_attention(*map(torch.from_numpy, (
        q, kp, vp, tables, np.asarray([8, 4], np.int32)))).numpy()
    for si, length in enumerate((9, 5)):
        rows = [(tables[si][p // ps], p % ps) for p in range(length)]
        ks = np.stack([kp[pg, o] for pg, o in rows])
        vs = np.stack([vp[pg, o] for pg, o in rows])
        s = np.einsum("hd,lhd->hl", q[si], ks) * d ** -0.5
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        np.testing.assert_allclose(got[si], np.einsum("hl,lhd->hd", p, vs),
                                   **TOL)


def test_cpu_entries_never_touch_the_kernel_loader(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA kernel path was entered")

    monkeypatch.setattr(_kernels, "_library", refuse)
    monkeypatch.setattr(_kernels, "paged_attn", refuse)
    _kernels.reset_launches()
    test_prefill_with_padding_queries_past_the_table()
    test_verify_window_straddles_pages()
    assert _kernels.LAUNCHES["paged_attn"] == 0


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 2, 4))
    pool = torch.zeros((2, 4, 2, 4))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.paged_attn(q, torch.zeros((1, 1), dtype=torch.int32),
                            pool, pool, torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="no paged attention for device meta"):
        tpk.paged_attention_kernel(
            q[:, 0].to("meta"), pool.to("meta"), pool.to("meta"),
            torch.zeros((1, 1), dtype=torch.int32, device="meta"),
            torch.zeros((1,), dtype=torch.int32, device="meta"),
        )


# -- K8's arithmetic order, emulated ------------------------------------------

K8_SRC = os.path.join(os.path.dirname(tpk.__file__), os.pardir, "csrc",
                      "paged_attn.cu")
K8_TILE = 16          # TK: logical positions of a key tile
K8_PARTS = 16         # G = R * NK: 4 blocks of a cluster x 4 key slots
NEG_INF = np.float32(-1e30)


def _fma(a, b, c):
    """fp32 fmaf: the product is exact in float64, the sum rounds there
    and then to fp32 (a true fma rounds once; the two differ only on
    rare double-rounding ties)."""
    return (a.double() * b.double() + c.double()).float()


def _exp(x):
    return torch.exp(x.double()).float()


def k8_emulation(q4, qpos, k_pool, v_pool, tables):
    """K8's arithmetic in plain torch: q4 (S, C, H, D) at ``qpos`` (S, C)
    through ``tables`` (S, P) -> (S, C, H, D) fp32.

    Tile j (positions 16 j .. 16 j + 15) goes to partition j mod 16; a
    partition updates a query's (m, l, acc) only on tiles that start at
    or before its position; a score is an fmaf chain over d, the tile's
    sum of p a left fold over k, P.V an fmaf chain over k; the
    partitions' states merge in partition order. Every op is
    elementwise or a max, so a query's bits cannot depend on the batch
    it is in."""
    s_, c_, h, d = q4.shape
    num_pages, ps = k_pool.shape[0], k_pool.shape[1]
    n_pos = tables.shape[1] * ps
    scale = torch.tensor(d ** -0.5, dtype=torch.float32)
    tab = torch.where((tables >= 0) & (tables < num_pages), tables,
                      torch.zeros_like(tables)).long()
    n_keys = torch.clamp(qpos.long() + 1, max=n_pos)            # (S, C)
    n_tiles = max(0, -(-int(n_keys.max()) // K8_TILE))
    pos = torch.arange(n_tiles * K8_TILE)
    in_table = pos < n_pos
    page = tab[:, torch.clamp(pos // ps, max=tables.shape[1] - 1)]  # (S, L)
    rows = torch.where(in_table[None, :, None, None],
                       k_pool[page, pos % ps], torch.zeros(()))
    vrows = torch.where(in_table[None, :, None, None],
                        v_pool[page, pos % ps], torch.zeros(()))
    neg = torch.tensor(NEG_INF)
    m = [torch.full((s_, c_, h), NEG_INF) for _ in range(K8_PARTS)]
    l = [torch.zeros(s_, c_, h) for _ in range(K8_PARTS)]
    acc = [torch.zeros(s_, c_, h, d) for _ in range(K8_PARTS)]
    qe = q4[:, :, :, None, :]                                   # (S,C,H,1,D)
    for j in range(n_tiles):
        w = j % K8_PARTS
        sl = slice(j * K8_TILE, (j + 1) * K8_TILE)
        kt = rows[:, sl].permute(0, 2, 1, 3)[:, None]           # (S,1,H,TK,D)
        vt = vrows[:, sl].permute(0, 2, 1, 3)[:, None]
        dot = torch.zeros(s_, c_, h, K8_TILE)
        for dd in range(d):
            dot = _fma(qe[..., dd], kt[..., dd], dot)
        key = pos[sl]
        sc = torch.where(key[None, None, None, :] < n_keys[:, :, None, None],
                         dot * scale, neg)
        m_new = torch.maximum(m[w], sc.amax(-1))
        p = torch.where(sc > NEG_INF / 2, _exp(sc - m_new[..., None]),
                        torch.zeros(()))
        t = torch.zeros(s_, c_, h)                              # k fold
        for k in range(K8_TILE):
            t = t + p[..., k]
        corr = torch.where(m[w] > NEG_INF / 2, _exp(m[w] - m_new),
                           torch.zeros(()))
        pv = torch.zeros(s_, c_, h, d)
        for k in range(K8_TILE):
            pv = _fma(p[..., k, None], vt[..., k, :], pv)
        live = (j * K8_TILE < n_keys)[:, :, None]               # (S, C, 1)
        l[w] = torch.where(live, _fma(corr, l[w], t), l[w])
        acc[w] = torch.where(live[..., None],
                             _fma(corr[..., None], acc[w], pv), acc[w])
        m[w] = torch.where(live, m_new, m[w])
    m_all = m[0]
    for w in range(1, K8_PARTS):
        m_all = torch.maximum(m_all, m[w])
    l_all = torch.zeros(s_, c_, h)
    a = torch.zeros(s_, c_, h, d)
    for w in range(K8_PARTS):
        f = torch.where(m[w] > NEG_INF / 2, _exp(m[w] - m_all),
                        torch.zeros(()))
        l_all = _fma(f, l[w], l_all)
        a = _fma(f[..., None], acc[w], a)
    return a / torch.where(l_all == 0, torch.ones(()), l_all)[..., None]


def _k8_case(kind, d, seed):
    """(q4, qpos, k_pool, v_pool, tables) of one call shape at head dim
    ``d``: scrambled and reused tables, null pages, qpos 0 and a slot
    whose last page is ragged. Pools are random everywhere (old rows,
    garbage in the null page)."""
    rng = np.random.RandomState(seed)
    h = 2
    if kind == "decode":      # pages of 16: the LM's; lengths 1..70
        ps, num_pages = 16, 12
        tables = np.zeros((4, 5), np.int32)
        tables[0, :5] = [7, 3, 11, 5, 9]          # 70 positions, ragged
        tables[1, :1] = [2]                        # one page
        tables[2, :2] = [10, 1]                    # reused out of order
        qpos = np.asarray([[69], [0], [16], [0]], np.int32)  # slot 3 null
    elif kind == "verify":    # pages of 4: a tile spans four of them
        ps, num_pages = 4, 20
        tables = np.zeros((3, 9), np.int32)
        tables[0, :9] = [19, 2, 17, 4, 15, 6, 13, 8, 11]
        tables[1, :4] = [3, 18, 5, 16]
        qpos = np.asarray([[30, 31, 32, 33], [12, 13, 14, 15],
                           [0, 1, 2, 3]], np.int32)         # slot 2 null
    else:                     # prefill: pages of 5, 18 queries, P * ps = 45
        ps, num_pages = 5, 14
        tables = np.asarray([[13, 2, 9, 4, 11, 6, 1, 8, 3]], np.int32)
        qpos = np.arange(30, 48, dtype=np.int32)[None]       # past the table
    q = rng.randn(tables.shape[0], qpos.shape[1], h, d).astype(np.float32)
    kp = rng.randn(num_pages, ps, h, d).astype(np.float32)
    vp = rng.randn(num_pages, ps, h, d).astype(np.float32)
    return q, qpos, kp, vp, tables


def _jax_kernel(kind, q, qpos, kp, vp, tables):
    """The JAX Pallas kernel (interpret mode) through ``kind``'s entry,
    as (S, C, H, D)."""
    j = [jnp.asarray(a) for a in (q, kp, vp, tables)]
    if kind == "decode":
        return np.asarray(jpk.paged_attention_kernel(
            j[0][:, 0], j[1], j[2], j[3], jnp.asarray(qpos[:, 0]),
            interpret=True))[:, None]
    if kind == "verify":
        return np.asarray(jpk.paged_verify_attention_kernel(
            *j, jnp.asarray(qpos[:, 0]), interpret=True))
    return np.asarray(jpk.paged_prefill_attention_kernel(
        j[0][0], j[1], j[2], j[3][0], jnp.asarray(qpos[0]),
        interpret=True))[None]


_K8_CASES = [(kind, d) for kind in ("decode", "verify", "prefill")
             for d in (64, 36, 7)]


@pytest.mark.parametrize("kind,d", _K8_CASES)
def test_k8_emulation_matches_the_jax_kernel(kind, d):
    q, qpos, kp, vp, tables = _k8_case(kind, d, seed=20 + d)
    got = k8_emulation(*map(torch.from_numpy, (q, qpos, kp, vp, tables)))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(),
                               _jax_kernel(kind, q, qpos, kp, vp, tables),
                               **TOL)


@pytest.mark.parametrize("kind,d", _K8_CASES)
def test_k8_emulation_matches_the_gather_path(kind, d):
    args = list(map(torch.from_numpy, _k8_case(kind, d, seed=40 + d)))
    np.testing.assert_allclose(k8_emulation(*args).numpy(),
                               tpk.paged_attn_plain(*args).numpy(), **TOL)


@pytest.mark.parametrize("kind,d", _K8_CASES)
def test_k8_emulation_query_bits_do_not_depend_on_the_batch(kind, d):
    """Each query equals itself launched alone (S = 1, C = 1, its own
    table row), bit for bit, and two runs are equal."""
    q, qpos, kp, vp, tables = map(torch.from_numpy,
                                  _k8_case(kind, d, seed=60 + d))
    batched = k8_emulation(q, qpos, kp, vp, tables)
    assert torch.equal(batched, k8_emulation(q, qpos, kp, vp, tables))
    for si in range(q.shape[0]):
        for ci in range(q.shape[1]):
            alone = k8_emulation(q[si:si + 1, ci:ci + 1],
                                 qpos[si:si + 1, ci:ci + 1], kp, vp,
                                 tables[si:si + 1])
            assert torch.equal(alone[0, 0], batched[si, ci]), (si, ci)


def test_k8_emulation_out_of_range_page_ids_read_the_null_page():
    q, qpos, kp, vp, tables = map(torch.from_numpy,
                                  _k8_case("decode", 64, seed=80))
    bad = tables.clone()
    bad[0, 1], bad[1, 3] = 99, -5          # a live and an unused entry
    fixed = tables.clone()
    fixed[0, 1], fixed[1, 3] = 0, 0
    assert torch.equal(k8_emulation(q, qpos, kp, vp, bad),
                       k8_emulation(q, qpos, kp, vp, fixed))


def test_k8_emulation_follows_the_kernel_source():
    """The emulation's tile and partition count are the ones
    ``csrc/paged_attn.cu`` compiles, for every head dim."""
    src = open(K8_SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TK") == K8_TILE
    assert const("R") * const("NK") == K8_PARTS
    assert "constexpr int G = R * NK;" in src
    assert const("MAX_CQ") == 16


# -- indices and the in-place write --------------------------------------------


@pytest.mark.parametrize("table,positions,valid", [
    ([[2, 5, 0], [7, 0, 0]], [6, 1], None),        # one table per slot
    ([3, 9], [0, 3, 4, 7], None),                  # one shared table
    ([3, 9], [1, 5, 9], [True, False, True]),      # invalid / overrun
    ([[4, 1], [0, 0]], [5, 0], None),              # inactive slot
])
def test_flat_write_indices_bitwise(table, positions, valid):
    table = np.asarray(table, np.int32)
    positions = np.asarray(positions, np.int32)
    want = np.asarray(jpk.flat_write_indices(
        jnp.asarray(table), jnp.asarray(positions), 4,
        valid=None if valid is None else jnp.asarray(valid),
    ))
    got = tpk.flat_write_indices(
        torch.from_numpy(table), torch.from_numpy(positions), 4,
        valid=None if valid is None else torch.tensor(valid),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_write_kv_bitwise_and_in_place():
    ps, h, d = 4, 2, 3
    table = np.asarray([2, 4, 1], np.int32)
    positions = np.arange(10, dtype=np.int32)
    rows = np.random.RandomState(12).randn(10, h, d).astype(np.float32)
    jpool = jpk.init_pools(1, 6, ps, h, d)[0][0]
    want = np.asarray(jpk.write_kv(
        jpool, jpk.flat_write_indices(jnp.asarray(table),
                                      jnp.asarray(positions), ps),
        jnp.asarray(rows),
    ))
    tpool = tpk.init_pools(1, 6, ps, h, d, device="cpu")[0][0]
    idx = tpk.flat_write_indices(torch.from_numpy(table),
                                 torch.from_numpy(positions), ps)
    out = tpk.write_kv(tpool, idx, torch.from_numpy(rows))
    assert out is tpool                              # updated in place
    np.testing.assert_array_equal(tpool.numpy(), want)
    strip = tpk.gather_kv(tpool, torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(strip[:10], rows)


def test_init_pools_defaults_to_the_card_not_the_cpu(monkeypatch):
    """Without a device, init_pools means "cuda", as every entry point of
    the port does: with no card it raises, it never falls back to CPU
    pools. ``device="cpu"`` asks for them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.init_pools(1, 4, 4, 1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.init_pools(1, 4, 4, 1, 2, device="cuda")
    ((k, v),) = tpk.init_pools(1, 4, 4, 1, 2, device="cpu")
    assert k.device.type == v.device.type == "cpu"
    assert k.shape == v.shape == (4, 4, 1, 2) and not k.any()


def test_null_page_absorbs_inactive_slot_writes():
    ps, h, d = 4, 1, 2
    pool = tpk.init_pools(1, 4, ps, h, d, device="cpu")[0][0]
    table = torch.tensor([2], dtype=torch.int32)
    tpk.write_kv(pool, tpk.flat_write_indices(
        table, torch.tensor([0]), ps), torch.ones(1, h, d))
    tpk.write_kv(pool, tpk.flat_write_indices(
        torch.zeros((1, 1), dtype=torch.int32), torch.tensor([0]), ps),
        torch.full((1, h, d), 9.0))
    assert (tpk.gather_kv(pool, table)[0] == 1.0).all()
    assert (pool[0, 0] == 9.0).all()


# -- the allocator -------------------------------------------------------------


def test_pages_needed():
    for n, ps in ((0, 4), (1, 4), (4, 4), (5, 4), (-3, 4), (17, 16)):
        assert tpk.pages_needed(n, ps) == jpk.pages_needed(n, ps)


def test_allocator_all_or_nothing_and_occupancy():
    for mod in (jpk, tpk):
        a = mod.PageAllocator(5)
        assert a.capacity == 4 and a.free_count() == 4
        got = a.alloc(3)
        assert mod.NULL_PAGE not in got and a.occupancy() == 0.75
        assert a.alloc(2) is None and a.free_count() == 1
        a.free(got)
        assert a.occupancy() == 0.0
    with pytest.raises(ValueError):
        tpk.PageAllocator(1)


def test_allocator_hands_out_pages_in_the_jax_order():
    j, t = jpk.PageAllocator(9), tpk.PageAllocator(9)
    script = [("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
              ("free", 1), ("alloc", 2)]
    held_j, held_t = [], []
    for op, arg in script:
        if op == "alloc":
            held_j.append(j.alloc(arg))
            held_t.append(t.alloc(arg))
        else:
            j.free(held_j[arg])
            t.free(held_t[arg])
        assert held_j == held_t and j.free_count() == t.free_count()


def test_allocator_fork_refcounts_and_errors():
    a = tpk.PageAllocator(6)
    pages = a.alloc(2)
    a.fork(pages)
    assert [a.refcount(p) for p in pages] == [2, 2]
    a.free(pages)                       # one holder left
    assert a.free_count() == 3
    a.free(pages)                       # the last holder
    assert a.free_count() == 5
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[0]])
    with pytest.raises(ValueError, match="cannot free page 0"):
        a.free([0])
    with pytest.raises(ValueError, match="fork of free page"):
        a.fork([pages[0]])
    with pytest.raises(ValueError, match="cannot fork page 0"):
        a.fork([0])
    live = a.alloc(1)
    a.fork(live)
    with pytest.raises(ValueError, match="double free"):
        a.free([live[0], live[0]])      # twice in one call, though shared
