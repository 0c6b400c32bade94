"""The port's conv ops (``ops/xnor_gemm.py``: ``binary_conv2d``,
``conv2d``, ``im2col``, ``conv_patch_weight``,
``conv_padding_correction``, ``conv_precision``) and its
``BinarizedConv`` against the JAX package's, on the same numpy inputs.

Bitwise: the patches (against ``jax.lax.conv_general_dilated_patches``
on ±1/0 maps and on real ones), the patch weight, the padding correction
(small integers), every ±1 conv on the three dense backends, and the
im2col patch GEMM on K1's plain version against JAX's Pallas kernel in
interpret mode. Real-valued convs (a raw first layer on "xla" and
"bf16", the fp32 VJP) are two frameworks' fp32 sums in different
orders: held to rtol 1e-5 with atol 1e-5 of the values' scale (K <= 25
terms of magnitude <= 4; the largest gap measured was 9.5e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.models.layers import (
    BinarizedConv as JBinarizedConv,
)
from distributed_mnist_bnns_tpu.ops import xnor_gemm as jx
from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedConv
from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as tx

TOL = dict(rtol=1e-5, atol=1e-5)
JDT = {"xla": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}
CASES = [((3, 3), (1, 1), "SAME"), ((5, 5), (1, 1), 2), ((2, 3), (2, 2),
         "SAME"), ((3, 3), (2, 1), "VALID"), ((3, 1), (1, 2),
         ((1, 0), (2, 1)))]
IDS = ["3x3-same", "5x5-pad2", "2x3-s2-same", "3x3-s21-valid", "explicit"]


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _oihw(w):
    return torch.from_numpy(np.array(w)).permute(3, 2, 0, 1)


def _jpad(padding):
    if isinstance(padding, int):
        return ((padding, padding), (padding, padding))
    return padding


def _maps(rng, shape, ternary):
    if ternary:
        return rng.choice([-1.0, 0.0, 1.0], size=shape).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.parametrize("ternary", [True, False], ids=["pm1-0", "real"])
@pytest.mark.parametrize("kernel,strides,padding", CASES, ids=IDS)
def test_patches_are_bitwise_jax_conv_general_dilated_patches(
        kernel, strides, padding, ternary):
    x = _maps(np.random.RandomState(0), (2, 9, 7, 5), ternary)
    want = np.asarray(jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=kernel, window_strides=strides,
        padding=_jpad(padding), dimension_numbers=("NHWC", "HWIO", "NHWC")))
    got = tx.im2col(_nchw(x), kernel, strides, padding).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_conv_patch_weight_is_the_transpose_of_jax():
    w = np.random.RandomState(1).choice([-1.0, 1.0], (3, 3, 5, 4)).astype(
        np.float32)
    want = np.asarray(jx.conv_patch_weight(jnp.asarray(w)))
    got = tx.conv_patch_weight(_oihw(w)).numpy()
    np.testing.assert_array_equal(got.T, want)


@pytest.mark.parametrize("kernel,strides,padding", CASES, ids=IDS)
def test_padding_correction_is_bitwise_jax(kernel, strides, padding):
    rng = np.random.RandomState(2)
    ts = rng.randint(-9, 10, (*kernel, 6)).astype(np.float32)
    want = np.asarray(jx.conv_padding_correction(
        jnp.asarray(ts), (9, 7), strides, _jpad(padding)))
    got = tx.conv_padding_correction(torch.from_numpy(ts), (9, 7), strides,
                                     padding).numpy()
    np.testing.assert_array_equal(got, want)
    if padding == "VALID":
        assert not got.any()


@pytest.mark.parametrize("dtype", ["xla", "bf16", "int8"])
@pytest.mark.parametrize("kernel,strides,padding", CASES, ids=IDS)
def test_binary_conv2d_pm1_forward_and_backward_match_jax(
        kernel, strides, padding, dtype):
    """±1 operands: the forward is bitwise (integers) on every backend;
    the fp32 VJP's gradients to TOL (fp32 sums of a real cotangent)."""
    rng = np.random.RandomState(3)
    x = rng.choice([-1.0, 1.0], (2, 9, 7, 5)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], (*kernel, 5, 4)).astype(np.float32)

    def jf(xx, ww):
        return jx.binary_conv2d(xx, ww, strides, _jpad(padding), JDT[dtype])

    jy, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    g = rng.randn(*jy.shape).astype(np.float32)
    jgx, jgw = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_()
    wt = _oihw(w).detach().requires_grad_()
    y = tx.binary_conv2d(xt, wt, strides, padding, dtype)
    np.testing.assert_array_equal(_nhwc(y), np.asarray(jy))
    y.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jgw), **TOL)


@pytest.mark.parametrize("dtype", ["xla", "bf16"])
def test_binary_conv2d_raw_first_layer_matches_jax(dtype):
    """Raw pixels into a ±1 kernel (a first layer): "xla" multiplies them
    as they are, "bf16" rounds them to bf16 first, as JAX's does; both
    to TOL, and the backward takes the unrounded pixels."""
    rng = np.random.RandomState(4)
    x = (rng.randint(0, 256, (2, 12, 12, 1)) / 256.0 - 0.13) / 0.31
    x = x.astype(np.float32)
    w = rng.choice([-1.0, 1.0], (3, 3, 1, 6)).astype(np.float32)
    jy, vjp = jax.vjp(lambda ww: jx.binary_conv2d(
        jnp.asarray(x), ww, (1, 1), "SAME", JDT[dtype]), jnp.asarray(w))
    g = rng.randn(*jy.shape).astype(np.float32)
    (jgw,) = vjp(jnp.asarray(g))
    wt = _oihw(w).detach().requires_grad_()
    y = tx.binary_conv2d(_nchw(x), wt, (1, 1), "SAME", dtype)
    np.testing.assert_allclose(_nhwc(y), np.asarray(jy), **TOL)
    y.backward(_nchw(g))
    np.testing.assert_allclose(wt.grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(jgw), **TOL)
    if dtype == "bf16":   # the rounding is real: xla differs
        y32 = tx.binary_conv2d(_nchw(x), _oihw(w), (1, 1), "SAME", "xla")
        assert not torch.equal(y, y32)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_conv2d_matches_flax_conv(dtype):
    """flax's ``nn.Conv`` (padding 2, 5x5) in fp32 and in bf16 (the
    output rounded to bf16: compared at bf16's spacing, 1 ulp)."""
    from flax import linen as nn

    rng = np.random.RandomState(5)
    x = rng.randn(2, 10, 10, 3).astype(np.float32)
    jdt = jnp.bfloat16 if dtype else jnp.float32
    conv = nn.Conv(4, (5, 5), padding=2, dtype=jdt)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    k = np.asarray(v["params"]["kernel"])
    b = rng.randn(4).astype(np.float32)
    want = np.asarray(conv.apply({"params": {"kernel": k, "bias": b}},
                                 jnp.asarray(x)), np.float32)
    tdt = torch.bfloat16 if dtype else torch.float32
    got = tx.conv2d(_nchw(x).to(tdt), _oihw(k).to(tdt), (1, 1), 2)
    got = (got + torch.from_numpy(b).to(tdt)[:, None, None]).float()
    assert got.dtype == torch.float32
    tol = dict(rtol=1e-5, atol=1e-5) if dtype is None else dict(
        rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_nhwc(got), want, **tol)


def test_conv_precision_is_scoped():
    """Inside: cuDNN on, TF32 off, deterministic, no autotuning; after:
    the process's flags as they were."""
    c = torch._C
    saved = (c._get_cudnn_enabled(), c._get_cudnn_benchmark(),
             c._get_cudnn_deterministic(), c._get_cudnn_allow_tf32())
    try:
        c._set_cudnn_allow_tf32(True)
        c._set_cudnn_benchmark(True)
        c._set_cudnn_deterministic(False)
        with tx.conv_precision():
            assert (c._get_cudnn_enabled(), c._get_cudnn_benchmark(),
                    c._get_cudnn_deterministic(),
                    c._get_cudnn_allow_tf32()) == (True, False, True, False)
        assert c._get_cudnn_allow_tf32() and c._get_cudnn_benchmark()
        assert not c._get_cudnn_deterministic()
    finally:
        c._set_cudnn_enabled(saved[0])
        c._set_cudnn_benchmark(saved[1])
        c._set_cudnn_deterministic(saved[2])
        c._set_cudnn_allow_tf32(saved[3])


def test_patch_gemm_on_plain_k1_is_bitwise_jax_pallas_interpret():
    """im2col of ±1 maps then the packed GEMM: the port's plain K1
    (``binary_matmul(..., "pallas_xnor")`` on the CPU) against JAX's
    Pallas ``xnor_matmul`` in interpret mode, at K = 9 * 16 = 144 (4.5
    words), bitwise; plus the padding correction, against JAX's
    dense conv of the same ±1 values."""
    rng = np.random.RandomState(6)
    x = rng.choice([-1.0, 1.0], (2, 14, 14, 16)).astype(np.float32)
    w = rng.choice([-1.0, 1.0], (3, 3, 16, 32)).astype(np.float32)
    jp = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(3, 3), window_strides=(1, 1),
        padding="SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    jwm = jx.conv_patch_weight(jnp.asarray(w))
    want = np.asarray(jx.xnor_matmul(jp.reshape(-1, 144), jwm,
                                     interpret=True))
    tp = tx.im2col(_nchw(x), (3, 3))
    got = tx.binary_matmul(tp.reshape(-1, 144),
                           tx.conv_patch_weight(_oihw(w)),
                           "pallas_xnor").numpy()
    np.testing.assert_array_equal(got, want)
    corr = tx.conv_padding_correction(
        _oihw(w).sum(dim=1).permute(1, 2, 0), (14, 14))
    dense = np.asarray(jx.binary_conv2d(jnp.asarray(x), jnp.asarray(w),
                                        (1, 1), "SAME", jnp.float32))
    np.testing.assert_array_equal(
        (torch.from_numpy(got).reshape(2, 14, 14, 32) + corr).numpy(),
        dense)


def _jax_layer(backend, binarize_input, x, w, b):
    layer = JBinarizedConv(w.shape[-1], (3, 3), backend=backend,
                           binarize_input=binarize_input)
    params = {"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def f(xx, p):
        return layer.apply(p, xx)

    y, vjp = jax.vjp(f, jnp.asarray(x), params)
    return y, vjp


@pytest.mark.parametrize("backend", ["xla", "bf16", "int8", "xnor",
                                     "pallas_xnor"])
@pytest.mark.parametrize("first", [False, True], ids=["hidden", "raw"])
def test_binarized_conv_matches_jax_layer(backend, first):
    """``BinarizedConv`` forward and gradients (input, latent kernel,
    bias) against the JAX layer: a hidden layer on every backend (JAX
    runs "xnor" for pallas_xnor, the jnp twin of its kernel: both exact),
    bitwise forward; a raw first layer (the ±1 backends fall back to
    "xla") to TOL."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 8, 8, 6).astype(np.float32)
    if first:
        x = (rng.randint(0, 256, (2, 8, 8, 1)) / 256.0).astype(np.float32)
    w = rng.uniform(-1, 1, (3, 3, x.shape[-1], 5)).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    jb = "xnor" if backend == "pallas_xnor" else backend
    jy, vjp = _jax_layer(jb, not first, x, w, b)
    g = rng.randn(*jy.shape).astype(np.float32)
    jgx, jgp = vjp(jnp.asarray(g))
    layer = BinarizedConv(x.shape[-1], 5, binarize_input=not first,
                          backend=backend)
    with torch.no_grad():
        layer.weight.copy_(_oihw(w))
        layer.bias.copy_(torch.from_numpy(b))
    xt = _nchw(x).requires_grad_()
    y = layer(xt)
    if first:
        assert layer.gemm_backend() == ("bf16" if backend == "bf16"
                                        else "xla")
        np.testing.assert_allclose(_nhwc(y), np.asarray(jy), **TOL)
    else:
        np.testing.assert_array_equal(_nhwc(y), np.asarray(jy))
    y.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jgx), **TOL)
    np.testing.assert_allclose(
        layer.weight.grad.permute(2, 3, 1, 0).numpy(),
        np.asarray(jgp["params"]["kernel"]), **TOL)
    np.testing.assert_allclose(layer.bias.grad.numpy(),
                               np.asarray(jgp["params"]["bias"]), **TOL)
