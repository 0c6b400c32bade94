"""Bitplane packing in the PyTorch port against the JAX package, bitwise.

Inputs are made with numpy from fixed seeds and handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.ops import bitpack as jbp
from distributed_mnist_bnns_tpu.ops import xnor_gemm as jxg
from distributed_mnist_bnns_tpu_torch.ops import bitpack as tbp
from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as txg


def _pm1(rng, *shape):
    return np.where(rng.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100])
def test_pack_bits_matches_jax_both_packers(k):
    x = _pm1(np.random.RandomState(k), 5, k)
    x[0, :] = 0.0           # x == 0 -> bit 0
    x[1, :] = 1.0           # every bit set, bit 31 included where k >= 32
    got = tbp.pack_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.pack_bits(x)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.pack_bits_mxu(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(got.numpy(), jbp.pack_bits_np(x))
    np.testing.assert_array_equal(tbp.pack_bits_np(x), jbp.pack_bits_np(x))
    assert (got[0] == 0).all()


def test_bit31_wraps_to_negative_int32():
    """Only bit 31 set is -2^31; all 32 bits set is -1, as the JAX
    package's uint32 -> int32 cast gives."""
    x = -np.ones((2, 32), np.float32)
    x[0, 31] = 1.0
    x[1, :] = 1.0
    got = tbp.pack_bits(torch.from_numpy(x))
    assert got.tolist() == [[-(2 ** 31)], [-1]]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.pack_bits(x)))


@pytest.mark.parametrize("pad", [1, 4])
def test_pack_bits_padding_and_leading_dims(pad):
    x = _pm1(np.random.RandomState(7), 2, 3, 70)
    got = tbp.pack_bits(torch.from_numpy(x), pad_words_to=pad)
    want = np.asarray(jbp.pack_bits(x, pad_words_to=pad))
    assert got.shape == want.shape == (2, 3, tbp.packed_dim(70, pad))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tbp.packed_dim(70, pad) == jbp.packed_dim(70, pad)


@pytest.mark.parametrize("k", [1, 33, 100])
def test_unpack_bits_inverts_and_matches_jax(k):
    x = _pm1(np.random.RandomState(k + 1), 4, k)
    words = np.array(jbp.pack_bits(x))  # writable, for torch
    got = tbp.unpack_bits(torch.from_numpy(words), k)
    np.testing.assert_array_equal(got.numpy(), x)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jbp.unpack_bits(jnp.asarray(words), k))
    )


@pytest.mark.parametrize(
    "k,n,block_n",
    [(100, 130, 256), (256, 200, 256), (32, 1, 256), (300, 40, 128),
     (4160, 40, 256), (3072, 300, 256)],
)
def test_prepack_weights_bitwise(k, n, block_n):
    """Words, padding and layout equal the JAX package's prepack: K-major
    (KW_p, N_p); K=4160 is 130 words, padded to 256."""
    w = _pm1(np.random.RandomState(k + n), k, n)
    jw, jk, jn = jxg.prepack_weights(jnp.asarray(w), block_n=block_n)
    tw, tk, tn = txg.prepack_weights(torch.from_numpy(w), block_n=block_n)
    assert (tk, tn) == (jk, jn) == (k, n)
    assert tuple(tw.shape) == tuple(jw.shape)
    assert tw.dtype == torch.int32 and tw.is_contiguous()
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    if k == 4160:
        assert tw.shape[0] == 256
    np.testing.assert_array_equal(
        txg.unpacked_pm1(tw, k, n).numpy(), w
    )
