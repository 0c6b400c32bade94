"""Packed ±1 GEMMs of the PyTorch port against the JAX Pallas kernels.

The JAX entry points run their Pallas kernels with ``interpret=True``;
the port runs its plain PyTorch versions (the CPU path of each entry).
Every comparison on ±1 inputs is bitwise: the GEMM is an exact integer,
and the epilogues round as the JAX kernels do. K1-K3 take x as it is and
pack its signs themselves, so they are also held bitwise to JAX on raw x
with zeros, -0.0, NaN, ±inf and subnormals, under both pack rules. The
fused-unpack GEMM (K7) on real-valued x sums in another order than the
Pallas kernel, so it is held to rtol 1e-5 there. Emulations of the
card's arithmetic close the file: K1-K3's ballot pack and AND-popcount
identity, and K7's bf16 tensor-core products of an exact three-piece
split of x.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu.ops import xnor_gemm as jxg
from distributed_mnist_bnns_tpu.ops.binarize import binarize as jbinarize
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch import infer_transformer as tit
from distributed_mnist_bnns_tpu_torch.ops import _kernels
from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as txg
from distributed_mnist_bnns_tpu_torch.ops.binarize import _sign_pm1, binarize_ste
from distributed_mnist_bnns_tpu_torch.ops.bitpack import TINY, pack_bits

SHAPES = [(1, 100, 130), (8, 256, 200), (17, 3072, 96)]


def _pm1(rng, *shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


def _operands(m, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x, w = _pm1(rng, m, k), _pm1(rng, k, n)
    vecs = [rng.randn(n).astype(np.float32) for _ in range(3)]
    return x, w, vecs


def _jax(fn, x, w, k, n, *vecs):
    wp, _, _ = jxg.prepack_weights(jnp.asarray(w))
    return np.asarray(fn(jnp.asarray(x), wp, k, n, *map(jnp.asarray, vecs),
                         interpret=True))


def _port(fn, x, w, k, n, *vecs):
    wp, _, _ = txg.prepack_weights(torch.from_numpy(w))
    return fn(torch.from_numpy(x), wp, k, n,
              *map(torch.from_numpy, vecs)).numpy()


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_gemm_bitwise(m, k, n):
    x, w, _ = _operands(m, k, n)
    got = _port(txg.xnor_matmul_packed, x, w, k, n)
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, _jax(jxg.xnor_matmul_packed, x, w, k, n))
    np.testing.assert_array_equal(got, x @ w)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_sign_bitwise(m, k, n):
    x, w, (a, t, bias) = _operands(m, k, n, seed=1)
    a = np.sign(a).astype(np.float32)
    a[::5] = 0.0
    t *= 8.0
    got = _port(txg.xnor_matmul_packed_sign, x, w, k, n, a, t, bias)
    want = _jax(jxg.xnor_matmul_packed_sign, x, w, k, n, a, t, bias)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {-1.0, 1.0}


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_packed_affine_bitwise(m, k, n):
    """a / 7 and c / 9 are not short binary fractions, so the rounding of
    ``a * (y + bias) + c`` is exercised (one rounding, as an FMA)."""
    x, w, (a, c, bias) = _operands(m, k, n, seed=2)
    a, c = a / 7.0, c / 9.0
    got = _port(txg.xnor_matmul_packed_affine, x, w, k, n, a, c, bias)
    want = _jax(jxg.xnor_matmul_packed_affine, x, w, k, n, a, c, bias)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_affine_rounds_once_like_fma():
    """The plain affine epilogue is ``a*y + c`` rounded once to fp32. The
    float64 product is exact; on these seeded inputs the float64 sum
    rounded to fp32 is the correctly rounded result too."""
    rng = np.random.RandomState(3)
    a = (rng.randn(4096) / 7).astype(np.float32)
    y = rng.randint(-3072, 3072, 4096).astype(np.float32)
    c = (rng.randn(4096) / 9).astype(np.float32)
    got = txg._fma_f32(*map(torch.from_numpy, (a, y, c))).numpy()
    want = (a.astype(np.float64) * y + c).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    unfused = (a * y).astype(np.float32) + c
    assert (got != unfused).any(), "inputs never exercise the rounding"


class TestSignEpilogueEdgeCases:
    """The cases of the JAX package's TestFusedSignEpilogue, through the
    port's folding (``infer._bn_sign_epilogue``) and packed sign GEMM,
    against the same pipeline in the JAX package."""

    def _both(self, x, w, bias, bn_params, bn_stats):
        k, n = w.shape
        ja, jt = jinfer._bn_sign_epilogue(
            {k_: jnp.asarray(v) for k_, v in bn_params.items()},
            {k_: jnp.asarray(v) for k_, v in bn_stats.items()},
        )
        ta, tt = tinfer._bn_sign_epilogue(
            {k_: torch.from_numpy(v) for k_, v in bn_params.items()},
            {k_: torch.from_numpy(v) for k_, v in bn_stats.items()},
        )
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        want = _jax(jxg.xnor_matmul_packed_sign, x, w, k, n,
                    np.asarray(ja), np.asarray(jt), bias)
        got = _port(txg.xnor_matmul_packed_sign, x, w, k, n,
                    ta.numpy(), tt.numpy(), bias)
        np.testing.assert_array_equal(got, want)
        return got

    def test_negative_zero_and_positive_scales(self):
        rng = np.random.RandomState(0)
        m, k, n = 24, 96, 160
        x, w = _pm1(rng, m, k), _pm1(rng, k, n)
        bias = rng.randn(n).astype(np.float32)
        g = np.linspace(-1.0, 1.0, n).astype(np.float32)
        g[n // 2] = 0.0
        bn_params = {"scale": g, "bias": rng.randn(n).astype(np.float32)}
        bn_stats = {
            "mean": (rng.randn(n) * 4).astype(np.float32),
            "var": (np.abs(rng.randn(n)) + 0.5).astype(np.float32),
        }
        got = self._both(x, w, bias, bn_params, bn_stats)
        # the g == 0 column is the constant sign of the BN bias
        col = n // 2
        want_col = 1.0 if bn_params["bias"][col] >= 0 else -1.0
        assert (got[:, col] == want_col).all()

    def test_threshold_tie_gives_plus_one(self):
        """y + bias == theta exactly: >= makes it +1."""
        m, k, n = 8, 32, 128
        x = np.ones((m, k), np.float32)
        w = np.ones((k, n), np.float32)
        bias = np.zeros(n, np.float32)
        bn_params = {"scale": np.ones(n, np.float32),
                     "bias": np.zeros(n, np.float32)}
        bn_stats = {"mean": np.full(n, float(k), np.float32),
                    "var": np.ones(n, np.float32)}
        got = self._both(x, w, bias, bn_params, bn_stats)
        assert (got == 1.0).all()


def test_plain_popcount_matches_numpy():
    rng = np.random.RandomState(4)
    words = rng.randint(-(2 ** 31), 2 ** 31, size=1000, dtype=np.int64)
    got = txg._popcount32(torch.from_numpy(words)).numpy()
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in words]
    np.testing.assert_array_equal(got, want)


def test_plain_mismatches_chunked_equals_unchunked(monkeypatch):
    """Chunking over the packed words bounds memory, not the result."""
    rng = np.random.RandomState(5)
    x, w = _pm1(rng, 6, 700), _pm1(rng, 700, 50)
    wp, k, n = txg.prepack_weights(torch.from_numpy(w))
    xp = pack_bits(torch.from_numpy(x))
    whole = txg.xnor_gemm_plain(xp, wp, k)
    monkeypatch.setattr(txg, "_CHUNK_ELEMS", 1)
    np.testing.assert_array_equal(txg.xnor_gemm_plain(xp, wp, k), whole)


def _fused(x, w, k, n, jax_layout=None):
    wp_t, _, _ = txg.prepack_weights(torch.from_numpy(w))
    wp_j, _, _ = jxg.prepack_weights(jnp.asarray(w))
    want = np.asarray(jxg.xnor_matmul_fused_unpack(
        jnp.asarray(x), wp_j, k, n, interpret=True))
    got = txg.xnor_matmul_fused_unpack(torch.from_numpy(x), wp_t, k, n)
    return got.numpy(), want, wp_t


@pytest.mark.parametrize("n", [1, 130, 256])
@pytest.mark.parametrize("k", [32, 100, 256, 300])
@pytest.mark.parametrize("m", [1, 16, 17])
def test_fused_unpack_bitwise_on_pm1(m, k, n):
    rng = np.random.RandomState(m * 1000 + k + n)
    x, w = _pm1(rng, m, k), _pm1(rng, k, n)
    got, want, wp = _fused(x, w, k, n)
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x @ w)
    packed = txg.xnor_matmul_packed(torch.from_numpy(x), wp, k, n).numpy()
    np.testing.assert_array_equal(got, packed)


def test_fused_unpack_reads_the_wide_prepacked_layout():
    """KW = 131 > 128 words: prepack_weights pads K to 256 words, and
    the zero words (which unpack to -1) must not reach the sum."""
    rng = np.random.RandomState(7)
    m, k, n = 5, 4170, 140
    x, w = _pm1(rng, m, k), _pm1(rng, k, n)
    got, want, wp = _fused(x, w, k, n)
    assert wp.shape[0] == 256
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x @ w)


@pytest.mark.parametrize("m,k,n", [(16, 256, 512), (17, 300, 130)])
def test_fused_unpack_real_valued_x(m, k, n):
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k).astype(np.float32)
    w = _pm1(rng, k, n)
    got, want, _ = _fused(x, w, k, n)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, x.astype(np.float64) @ w, rtol=1e-5,
                               atol=1e-5)


def test_cpu_tensors_never_touch_the_kernel_loader(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA kernel path was entered")

    monkeypatch.setattr(_kernels, "_library", refuse)
    monkeypatch.setattr(_kernels, "xnor_gemm", refuse)
    _kernels.reset_launches()
    x, w, (a, b, bias) = _operands(3, 64, 20, seed=6)
    _port(txg.xnor_matmul_packed, x, w, 64, 20)
    _port(txg.xnor_matmul_packed_sign, x, w, 64, 20, a, b, bias)
    _port(txg.xnor_matmul_packed_affine, x, w, 64, 20, a, b, bias)
    _port(txg._xnor_matmul_binarize, x, w, 64, 20)
    monkeypatch.setattr(_kernels, "xnor_unpack", refuse)
    wp, _, _ = txg.prepack_weights(torch.from_numpy(w))
    txg.xnor_matmul_fused_unpack(torch.from_numpy(x), wp, 64, 20)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrappers take only CUDA tensors: no plain fallback. K1-K3
    take the fp32 (M, K) activations as they are (the kernel packs them)."""
    _kernels.reset_launches()
    x = torch.zeros((2, 96))
    wp = torch.zeros((3, 128), dtype=torch.int32)
    for rule in (_kernels.PACK_GT0, _kernels.PACK_GE0):
        with pytest.raises(ValueError, match="not on a CUDA device"):
            _kernels.xnor_gemm("xnor", x, wp, 96, 10, rule=rule)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.xnor_unpack(x, wp, 96, 10)
    assert _kernels.LAUNCHES["xnor"] == _kernels.LAUNCHES["xnor_unpack"] == 0


def test_entry_rejects_bad_shapes_and_other_devices():
    wp, k, n = txg.prepack_weights(torch.ones(64, 10))
    with pytest.raises(ValueError, match="x must be"):
        txg.xnor_matmul_packed(torch.ones(2, 63), wp, k, n)
    with pytest.raises(ValueError, match="do not cover"):
        txg.xnor_matmul_packed(torch.ones(2, 64), wp[:1], k, n)
    with pytest.raises(ValueError, match="packed weights on cpu"):
        txg.xnor_matmul_packed(torch.ones(2, 64, device="meta"), wp, k, n)
    with pytest.raises(ValueError, match="no packed GEMM for device meta"):
        txg.xnor_matmul_packed(
            torch.ones(2, 64, device="meta"), wp.to("meta"), k, n
        )
    with pytest.raises(ValueError, match="x must be"):
        txg.xnor_matmul_fused_unpack(torch.ones(2, 63), wp, k, n)
    with pytest.raises(ValueError, match="do not cover"):
        txg.xnor_matmul_fused_unpack(torch.ones(2, 64), wp[:, :5], k, n)
    with pytest.raises(ValueError, match="no fused-unpack GEMM"):
        txg.xnor_matmul_fused_unpack(
            torch.ones(2, 64, device="meta"), wp.to("meta"), k, n
        )


# ---------------------------------------------------------------------------
# K1-K3 take x as it is: the pack rules against JAX on raw x
# ---------------------------------------------------------------------------

SPECIAL_K = (31, 100, 4160, 9000)   # ragged, and past 128 words (KW_p > KW)
_F32_TINY = np.float32(TINY)


def _special_x(rng, m, k):
    """Real x holding exact zeros, -0.0, NaN, ±inf, ±subnormals and ±2^-126
    (the smallest normal) among normal values of both signs."""
    x = (rng.randn(m, k) * 3.0).astype(np.float32)
    flat = x.reshape(-1)
    specials = (0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, -1e-40,
                _F32_TINY, -_F32_TINY, 1e-45, -1e-45)
    for i, val in enumerate(specials):
        flat[i::len(specials) + 2] = val
    return x


def _special_operands(k, m=3, n=40, seed=0):
    rng = np.random.RandomState(k + seed)
    x, w = _special_x(rng, m, k), _pm1(rng, k, n)
    vecs = [rng.randn(n).astype(np.float32) for _ in range(3)]
    return x, w, vecs


@pytest.mark.parametrize("k", SPECIAL_K)
def test_ge0_entry_is_jax_binarize_then_packed_gemm(k):
    """The LM's K1 entry packs x >= 0 itself: bit for bit JAX's binarize
    (sign, 0 -> +1, a subnormal read as 0, NaN -> -1) followed by its packed
    GEMM in interpret mode, and the port's own two-step composition."""
    x, w, _ = _special_operands(k)
    n = w.shape[1]
    got = _port(txg._xnor_matmul_binarize, x, w, k, n)
    want = _jax(jxg.xnor_matmul_packed,
                np.asarray(jbinarize(jnp.asarray(x))), w, k, n)
    np.testing.assert_array_equal(got, want)
    two_step = _port(txg.xnor_matmul_packed,
                     binarize_ste(torch.from_numpy(x)).numpy(), w, k, n)
    np.testing.assert_array_equal(got, two_step)


@pytest.mark.parametrize("k", SPECIAL_K)
@pytest.mark.parametrize("entry", ["packed", "sign", "affine"])
def test_gt0_entries_match_jax_on_raw_x(entry, k):
    """The public entries pack x > 0 (pack_bits' rule): on raw x with every
    special value they equal the JAX packed entries bitwise."""
    x, w, (a, b, bias) = _special_operands(k, seed=1)
    n = w.shape[1]
    fns = {"packed": (txg.xnor_matmul_packed, jxg.xnor_matmul_packed, ()),
           "sign": (txg.xnor_matmul_packed_sign, jxg.xnor_matmul_packed_sign,
                    (np.sign(a).astype(np.float32), b * 8, bias)),
           "affine": (txg.xnor_matmul_packed_affine,
                      jxg.xnor_matmul_packed_affine, (a / 7, b / 9, bias))}
    port_fn, jax_fn, vecs = fns[entry]
    got = _port(port_fn, x, w, k, n, *vecs)
    np.testing.assert_array_equal(got, _jax(jax_fn, x, w, k, n, *vecs))


def test_pack_rules_read_subnormals_as_zero_like_xla():
    """XLA on the CPU reads a subnormal as 0, so JAX's
    x > 0 is false and x >= 0 true for -1e-40: the port's pack and sign
    follow it, where IEEE comparisons would not."""
    x = np.array([[1e-40, -1e-40, 1e-45, -1e-45, 0.0, -0.0, np.nan,
                   _F32_TINY, -_F32_TINY, np.inf, -np.inf, 1.0]], np.float32)
    from distributed_mnist_bnns_tpu.ops.bitpack import pack_bits as jpack
    np.testing.assert_array_equal(pack_bits(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpack(jnp.asarray(x))))
    np.testing.assert_array_equal(
        binarize_ste(torch.from_numpy(x)).numpy(),
        np.asarray(jbinarize(jnp.asarray(x))))
    assert (torch.from_numpy(x)[0, 0] > 0).item()   # IEEE would say +


# ---------------------------------------------------------------------------
# Emulations of K1-K3 on the card (csrc/xnor_gemm.cu)
# ---------------------------------------------------------------------------


def _ballot_pack(x, rule, share=1, chunk_words=128):
    """The kernel's pack: for each chunk of words, block q of a cluster of
    ``share`` packs words [q * per, (q + 1) * per) of every row, per =
    ceil(words / share); word j of a row is the ballot of its 32 lanes,
    lane i reading x[32 j + i] (NaN past K) and giving bit i by the rule
    (x >= 2^-126, or x > -2^-126). Returns (M, KW) int32 and how many times
    each word was packed."""
    m, k = x.shape
    kw = -(-k // 32)
    flat = np.full((m, kw * 32), np.nan, np.float32)
    flat[:, :k] = x
    if rule == _kernels.PACK_GE0:
        bits = flat > -_F32_TINY
    else:
        bits = flat >= _F32_TINY
    words = np.zeros((m, kw), np.uint32)
    packed = np.zeros(kw, np.int64)
    for c0 in range(0, kw, chunk_words):
        cwp = -(-min(chunk_words, kw - c0) // 8) * 8
        per = -(-cwp // share)
        for q in range(share):
            for j in range(q * per, min(cwp, (q + 1) * per)):
                if c0 + j >= kw:
                    continue          # a zero pad word of the k256 step
                lanes = bits[:, 32 * (c0 + j):32 * (c0 + j + 1)]
                words[:, c0 + j] = (lanes.astype(np.uint32)
                                    << np.arange(32, dtype=np.uint32)).sum(
                                        axis=1, dtype=np.uint32)
                packed[c0 + j] += 1
    return words.view(np.int32), packed


@pytest.mark.parametrize("share", [1, 3, 8])
@pytest.mark.parametrize("k", (1, 32, 33, *SPECIAL_K))
def test_ballot_pack_emulation_equals_pack_bits(k, share):
    """Lane i -> bit i, lanes past K -> 0: the kernel's words under either
    rule equal pack_bits (after _sign_pm1 for x >= 0), every word packed by
    exactly one block of the cluster."""
    x = _special_x(np.random.RandomState(k), 5, k)
    xt = torch.from_numpy(x)
    for rule, want in ((_kernels.PACK_GT0, pack_bits(xt)),
                       (_kernels.PACK_GE0, pack_bits(_sign_pm1(xt)))):
        got, packed = _ballot_pack(x, rule, share)
        np.testing.assert_array_equal(got, want.numpy())
        assert (packed == 1).all()


def _popc(v):
    return np.unpackbits(v.astype(np.uint32).view(np.uint8)).reshape(
        *v.shape, 32).sum(axis=-1)


def _and_popc_mismatches(xp, wp, k, chunk_words=128):
    """The kernel's count: in chunks of k256 steps (8 words, zero past the
    first KW rows of w and past KW for x), per step popc(x) + popc(w) -
    2 popc(x & w) summed in int32, one sum per output."""
    xp = xp.numpy().view(np.uint32)
    m, kw = xp.shape
    wr = wp.numpy().view(np.uint32)
    n = wr.shape[1]
    mism = np.zeros((m, n), np.int32)
    for c0 in range(0, max(kw, 1), chunk_words):
        cw = min(chunk_words, kw - c0)
        for s0 in range(0, cw, 8):
            xa = np.zeros((m, 8), np.uint32)
            wb = np.zeros((8, n), np.uint32)
            hi = min(8, cw - s0)
            xa[:, :hi] = xp[:, c0 + s0:c0 + s0 + hi]
            wb[:hi] = wr[c0 + s0:c0 + s0 + hi]
            and_ = _popc(xa[:, :, None] & wb[None]).sum(axis=1)
            mism += (_popc(xa).sum(axis=1)[:, None] + _popc(wb).sum(axis=0)
                     - 2 * and_).astype(np.int32)
    return mism


@pytest.mark.parametrize("k", SPECIAL_K)
def test_and_popc_identity_emulation_equals_mismatches(k):
    """popc(x ^ w) = popc(x) + popc(w) - 2 popc(x & w) over k256-padded
    words gives _mismatches exactly; at K = 4160 and 9000 prepack_weights
    pads K to 256 and 384 words (KW_p > KW), rows the kernel never reads."""
    rng = np.random.RandomState(k)
    x, w = _special_x(rng, 6, k), _pm1(rng, k, 50)
    wp, _, n = txg.prepack_weights(torch.from_numpy(w))
    xp = pack_bits(torch.from_numpy(x))
    assert wp.shape[0] >= xp.shape[1]
    got = _and_popc_mismatches(xp, wp, k)
    np.testing.assert_array_equal(got, txg._mismatches(xp, wp).numpy())
    np.testing.assert_array_equal(
        (k - 2 * got[:, :n]).astype(np.float32),
        txg.xnor_gemm_plain(xp, wp, k)[:, :n].numpy())


@pytest.mark.parametrize("shape,want", [
    ((4, 256, 512), (32, 1)),       # K1, the LM's decode projections
    ((1, 256, 512), (32, 1)),
    ((32, 3072, 1536), (64, 8)),    # K2, the MLP's layer 2
    ((32, 1536, 768), (32, 8)),     # K3, the MLP's layer 3
    ((256, 3072, 1536), (128, 6)),
    ((9, 9000, 257), (32, 3)),
    ((5, 31, 1), (32, 1)),
])
def test_xnor_tiling_at_the_smokes_shapes(shape, want):
    """The tile width and x-sharing cluster K1-K3 launch with: a cluster
    divides the column tiles (no idle block), holds at most 8 blocks (the
    portable limit) and no more blocks than K has words."""
    m, k, n = shape
    bn, share = _kernels.xnor_tiling(m, k, n)
    assert (bn, share) == want
    assert -(-n // bn) % share == 0 and 1 <= share <= 8
    assert share <= -(-k // 32)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
def test_packed_dense_fn_k1_route_is_binarize_then_packed(fused, alpha):
    """The decoder's K1 projection (M below FUSED_UNPACK_MIN_M, or no
    fusion) gives bitwise what binarize_ste then xnor_matmul_packed gave:
    the sign is now packed inside K1."""
    rng = np.random.RandomState(int(fused) * 2 + int(alpha))
    k, n = 100, 24
    x = torch.from_numpy(_special_x(rng, 2 * 3, k).reshape(2, 3, k))
    wp, _, _ = txg.prepack_weights(torch.from_numpy(_pm1(rng, k, n)))
    layer = {"wp": wp, "k": k, "n": n,
             "bias": torch.from_numpy(rng.randn(n).astype(np.float32))}
    if alpha:
        layer["alpha"] = torch.from_numpy(
            np.abs(rng.randn(n)).astype(np.float32))
    got = tit._packed_dense_fn(layer, fused)(x)
    want = txg.xnor_matmul_packed(binarize_ste(x).reshape(-1, k), wp, k, n)
    want = want.reshape(2, 3, n)
    if alpha:
        want = want * layer["alpha"]
    want = want + layer["bias"]
    assert torch.equal(got, want)


def test_packed_dense_fn_k7_route_keeps_binarize_ste():
    """At FUSED_UNPACK_MIN_M rows the fused route still binarizes first and
    runs K7's entry: unchanged by the K1 entry's own pack."""
    rng = np.random.RandomState(11)
    k, n, m = 64, 16, tit.FUSED_UNPACK_MIN_M
    x = torch.from_numpy(_special_x(rng, m, k))
    wp, _, _ = txg.prepack_weights(torch.from_numpy(_pm1(rng, k, n)))
    layer = {"wp": wp, "k": k, "n": n, "bias": torch.zeros(n)}
    got = tit._packed_dense_fn(layer, True)(x)
    want = txg.xnor_matmul_fused_unpack(binarize_ste(x), wp, k, n)
    assert torch.equal(got, want + layer["bias"])


# ---------------------------------------------------------------------------
# Training: binary_matmul's fp32 backward
# ---------------------------------------------------------------------------

BMM_SHAPES = [(4, 8, 3), (16, 64, 32), (33, 96, 20)]


def _grid_cotangent(rng, m, n):
    """A cotangent on the 2^-12 grid in (-1, 1): 12 significant bits, so
    a bf16 rounding (8 bits) shows, while every partial sum of up to
    2^11 such terms times ±1 is exact in fp32: the sums agree bitwise in
    whatever order XLA and PyTorch take them."""
    return (rng.randint(-4095, 4096, (m, n)) / 4096.0).astype(np.float32)


def _bmm_grads_jax(x, w, g, backend):
    """JAX binary_matmul's VJP; w is the port's (N, K), JAX's is (K, N)."""
    import jax

    _, vjp = jax.vjp(lambda a, b: jxg.binary_matmul(a, b, backend),
                     jnp.asarray(x), jnp.asarray(w.T))
    gx, gw = vjp(jnp.asarray(g))
    return np.asarray(gx), np.asarray(gw).T


@pytest.mark.parametrize("backend", ["xla", "bf16"])
@pytest.mark.parametrize("m,k,n", BMM_SHAPES)
def test_binary_matmul_matches_jax_bitwise(backend, m, k, n):
    """Forward and both gradients equal the JAX binary_matmul's bitwise:
    the backward multiplies the fp32 cotangent by the ±1 operands in
    fp32 for either backend."""
    rng = np.random.RandomState(m + k + n)
    x, w = _pm1(rng, m, k), _pm1(rng, n, k)
    g = _grid_cotangent(rng, m, n)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = txg.binary_matmul(xt, wt, backend)
    want_y = np.asarray(jxg.binary_matmul(jnp.asarray(x), jnp.asarray(w.T),
                                          backend))
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    y.backward(torch.from_numpy(g))
    want_gx, want_gw = _bmm_grads_jax(x, w, g, backend)
    np.testing.assert_array_equal(xt.grad.numpy(), want_gx)
    np.testing.assert_array_equal(wt.grad.numpy(), want_gw)


def test_bf16_binarized_dense_keeps_the_cotangent_in_fp32():
    """Through BinarizedDense(backend="bf16") the input's gradient is
    g @ w in fp32, as JAX's: autograd through bf16 casts of the operands
    would round the cotangent to bf16."""
    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense

    rng = np.random.RandomState(0)
    layer = BinarizedDense(8, 3, backend="bf16")
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(_pm1(rng, 3, 8)))
    x = torch.from_numpy(_pm1(rng, 4, 8)).requires_grad_()
    g = _grid_cotangent(rng, 4, 3)
    layer(x).backward(torch.from_numpy(g))
    want_gx, want_gw = _bmm_grads_jax(x.detach().numpy(),
                                      layer.weight.detach().numpy(), g,
                                      "bf16")
    np.testing.assert_array_equal(x.grad.numpy(), want_gx)
    np.testing.assert_array_equal(layer.weight.grad.numpy(), want_gw)


def test_binary_matmul_rejects_unknown_backends():
    with pytest.raises(ValueError, match="unknown backend"):
        txg.binary_matmul(torch.ones(2, 4), torch.ones(3, 4), "fp8")
    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense

    with pytest.raises(ValueError, match="unknown backend"):
        BinarizedDense(4, 3, backend="fp8")


@pytest.mark.parametrize("k", [31, 100, 3072])
@pytest.mark.parametrize("backend", txg.BACKENDS)
def test_every_backend_is_the_exact_pm1_product(backend, k):
    """All five backends give the xla product bitwise on ±1 operands
    (every sum is an integer), as JAX's binary_matmul does on the same
    backend (pallas_xnor: the Pallas kernel in interpret mode; here K1's
    plain version), and the gradients are the fp32 pair on every
    backend, bitwise."""
    m, n = 9, 40
    rng = np.random.RandomState(k)
    x, w = _pm1(rng, m, k), _pm1(rng, n, k)
    g = _grid_cotangent(rng, m, n)
    grads = {}
    for b in (backend, "xla"):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = txg.binary_matmul(xt, wt, b)
        y.backward(torch.from_numpy(g))
        grads[b] = (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy())
    for got, want in zip(grads[backend], grads["xla"]):
        np.testing.assert_array_equal(got, want)
    want_y = jxg.binary_matmul(jnp.asarray(x), jnp.asarray(w.T), backend,
                               backend == "pallas_xnor")
    np.testing.assert_array_equal(grads[backend][0], np.asarray(want_y))
    np.testing.assert_array_equal(grads[backend][1], g @ w)
    np.testing.assert_array_equal(grads[backend][2], g.T @ x)


@pytest.mark.parametrize("m,k,n", [(1, 100, 130), (64, 3072, 40)])
def test_pallas_xnor_backend_is_jax_xnor_matmul(m, k, n):
    """The pallas_xnor backend packs the weights (``prepack_weights``) and
    runs K1's entry, as the JAX ``xnor_matmul`` runs its Pallas kernel."""
    rng = np.random.RandomState(m)
    x, w = _pm1(rng, m, k), _pm1(rng, n, k)
    want = jxg.xnor_matmul(jnp.asarray(x), jnp.asarray(w.T), interpret=True)
    got = txg.binary_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            "pallas_xnor")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_default_backend_is_bf16():
    """The JAX package's default backend, bf16, is the default of
    ``binary_matmul``, ``BinarizedDense``, ``BnnMLP`` and the trainer: on
    a raw input that bf16 cannot hold, the default product is the bf16
    one, not the fp32 one."""
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    assert jxg.get_default_backend() == "bf16"
    x = torch.tensor([[1.0 + 2.0 ** -10, 1.0]])
    w = torch.ones(1, 2)
    assert txg.binary_matmul(x, w).item() == 2.0
    assert torch.equal(txg.binary_matmul(x, w),
                       txg.binary_matmul(x, w, "bf16"))
    assert txg.binary_matmul(x, w, "xla").item() == 2.0 + 2.0 ** -10
    assert BinarizedDense(8, 3).gemm_backend() == "bf16"
    mlp = get_model("bnn-mlp-small", infl_ratio=1)
    assert {m.backend for m in (mlp.fc1, mlp.fc2, mlp.fc3)} == {"bf16"}
    tr = Trainer(TrainConfig(model="bnn-mlp-small", device="cpu"))
    assert {m.backend for m in (tr.model.fc1, tr.model.fc3)} == {"bf16"}


@pytest.mark.parametrize("backend", ["int8", "xnor", "pallas_xnor"])
def test_first_layer_raw_inputs_reroute_to_xla(backend):
    """A layer fed raw activations (``binarize_input=False``) runs the
    exact fp32 product under the backends that assume ±1 x, as the JAX
    layer's ``_layer_backend`` rule does; the port's counterpart of the
    JAX package's ``test_first_layer_raw_inputs_exact_for_all_backends``."""
    import jax

    from distributed_mnist_bnns_tpu.models import BinarizedDense as JDense
    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense

    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 32)) * 2.0)
    jlayer = JDense(8, binarize_input=False, backend=backend)
    variables = jlayer.init({"params": jax.random.PRNGKey(1)}, x)
    kernel = np.array(variables["params"]["kernel"])
    want = np.asarray(jlayer.apply(variables, x))
    outs = {}
    for b in (backend, "xla"):
        layer = BinarizedDense(32, 8, binarize_input=False, backend=b)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(kernel.T))
        outs[b] = layer(torch.from_numpy(x)).detach().numpy()
        assert layer.gemm_backend() == "xla"
    np.testing.assert_array_equal(outs[backend], outs["xla"])
    np.testing.assert_allclose(outs[backend], want, rtol=1e-5, atol=1e-5)
    signed = np.where(x >= 0, 1.0, -1.0).astype(np.float32) @ np.where(
        kernel >= 0, 1.0, -1.0)
    assert not np.allclose(signed, want, atol=1e-3)


# K7 on the card (csrc/xnor_unpack.cu) multiplies bf16 pieces of x on the
# tensor cores. The tests below emulate its arithmetic at the shapes
# chip_smoke.py checks the kernel at (the LM's projections at M = 1, 16, 64,
# then ragged and multi-chunk shapes) and hold it to the smoke's limits.
K7_SHAPES = [(m, k, n) for m in (1, 16, 64)
             for k, n in ((256, 256), (256, 512), (512, 256))]
K7_SHAPES += [(17, 100, 130), (16, 4160, 257)]
K7_CHUNK, K7_WARPS = 256, 4   # the kernel's staged x chunk; warps a block


def _bf16_pieces(x):
    """hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each
    rounded to nearest (even), as ``__floats2bfloat162_rn`` rounds."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    mid = (x - hi).to(torch.bfloat16).to(torch.float32)
    lo = (x - hi - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def _k7_emulated(pieces, w_pm1):
    """K7's order of summation: each k16 step's products of every piece,
    summed exactly and rounded to fp32 (from a zero accumulator), added
    in fp32 to the sum of the warp that owns the step (4 consecutive
    steps of each chunk of 256 per warp); the warps' sums added in order
    0, 1, 2, 3. x past K is zero."""
    m, k = pieces[0].shape
    steps = -(-k // 16)
    pad = 16 * steps - k
    xs = [torch.nn.functional.pad(p, (0, pad)).double() for p in pieces]
    w = torch.nn.functional.pad(w_pm1, (0, 0, 0, pad), value=-1.0).double()
    per_warp = K7_CHUNK // 16 // K7_WARPS
    sums = [torch.zeros(m, w.shape[1]) for _ in range(K7_WARPS)]
    for s in range(steps):
        ks = slice(16 * s, 16 * s + 16)
        step = sum(xp[:, ks] @ w[ks] for xp in xs).to(torch.float32)
        warp = s % (K7_CHUNK // 16) // per_warp
        sums[warp] = sums[warp] + step
    out = sums[0]
    for part in sums[1:]:
        out = out + part
    return out


def _k7_operands(m, k, n, real):
    rng = np.random.RandomState(m * 7 + k + n)
    x = rng.randn(m, k).astype(np.float32) if real else _pm1(rng, m, k)
    wp, _, _ = txg.prepack_weights(torch.from_numpy(_pm1(rng, k, n)))
    return torch.from_numpy(x), wp


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e3, 1e30])
def test_k7_three_bf16_pieces_are_exact(scale):
    """hi + mid + lo == x bitwise for normal fp32 x: 3 x 8 significand
    bits cover fp32's 24. Two pieces are not enough."""
    x = torch.from_numpy(
        (np.random.RandomState(3).randn(4096) * scale).astype(np.float32))
    hi, mid, lo = _bf16_pieces(x)
    assert torch.equal(hi + mid + lo, x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert not torch.equal(hi + mid, x)


@pytest.mark.parametrize("m,k,n", K7_SHAPES)
def test_k7_emulation_bitwise_on_pm1(m, k, n):
    """On ±1 x every partial sum is an integer: the kernel's order gives
    the plain version's result bitwise (mid = lo = 0)."""
    x, wp = _k7_operands(m, k, n, real=False)
    pieces = _bf16_pieces(x)
    assert not pieces[1].any() and not pieces[2].any()
    got = _k7_emulated(pieces, txg.unpacked_pm1(wp, k, n))
    assert torch.equal(got, txg.fused_unpack_plain(x, wp, k, n))


@pytest.mark.parametrize("m,k,n", K7_SHAPES)
def test_k7_emulation_real_x_within_the_smokes_tolerance(m, k, n):
    """On real x the three-piece products, summed in the kernel's order,
    meet chip_smoke.py's rtol 1e-5, atol 1e-5 * sqrt(K)."""
    x, wp = _k7_operands(m, k, n, real=True)
    got = _k7_emulated(_bf16_pieces(x), txg.unpacked_pm1(wp, k, n))
    torch.testing.assert_close(got, txg.fused_unpack_plain(x, wp, k, n),
                               rtol=1e-5, atol=1e-5 * k ** 0.5)


def test_k7_one_bf16_piece_misses_the_tolerance():
    """x rounded once to bf16 (exact only on ±1 x) misses the limit: the
    split is what lets the kernel take any real fp32 x."""
    m, k, n = 16, 256, 512
    x, wp = _k7_operands(m, k, n, real=True)
    hi = _bf16_pieces(x)[0]
    got = _k7_emulated((hi,), txg.unpacked_pm1(wp, k, n))
    assert not torch.allclose(got, txg.fused_unpack_plain(x, wp, k, n),
                              rtol=1e-5, atol=1e-5 * k ** 0.5)
