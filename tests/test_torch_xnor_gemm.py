"""Packed ±1 GEMMs of the PyTorch port against the JAX Pallas kernels.

The JAX entry points run their Pallas kernels with ``interpret=True``;
the port runs its plain PyTorch versions (the CPU path of each entry).
Every comparison on ±1 inputs is bitwise: the GEMM is an exact integer,
and the epilogues round as the JAX kernels do. The fused-unpack GEMM
(K7) on real-valued x sums in another order than the Pallas kernel, so
it is held to rtol 1e-5 there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer as jinfer
from distributed_mnist_bnns_tpu.ops import xnor_gemm as jxg
from distributed_mnist_bnns_tpu_torch import infer as tinfer
from distributed_mnist_bnns_tpu_torch.ops import _kernels
from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as txg
from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

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
    monkeypatch.setattr(_kernels, "xnor_unpack", refuse)
    wp, _, _ = txg.prepack_weights(torch.from_numpy(w))
    txg.xnor_matmul_fused_unpack(torch.from_numpy(x), wp, 64, 20)
    assert all(v == 0 for v in _kernels.LAUNCHES.values())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper takes only CUDA tensors: no plain fallback."""
    _kernels.reset_launches()
    xp = torch.zeros((2, 3), dtype=torch.int32)
    wp = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.xnor_gemm("xnor", xp, wp, 96, 10)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.xnor_unpack(torch.zeros((2, 96)), wp, 96, 10)
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
        txg.binary_matmul(torch.ones(2, 4), torch.ones(3, 4), "int8")
