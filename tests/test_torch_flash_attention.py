"""The port's flash attention (plain versions of K4, K5 and K6, the CPU
path) against the JAX package's Pallas kernels run in interpret mode.

Inputs come from numpy seeds. Forward: out and lse within atol = rtol =
1e-5 (both sum the softmax in other orders and blocks, so not bitwise).
Backward: the gradients of ``sum(out * g_out) + sum(lse * g_lse)``, both
cotangents non-zero, against ``jax.vjp`` under both JAX backward
implementations (the Pallas kernel pair and the chunked scan), within
atol = rtol = 1e-5.

The card's kernels (K4, K5, K6) compute the scores as exact fp32 fmaf
chains and every other matrix product in 3xTF32; the last tests emulate
that arithmetic here and hold it to the tolerances ``chip_smoke.py``
holds the kernels to.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch.ops import _kernels
from distributed_mnist_bnns_tpu_torch.ops import flash_attention as tfa

# The JAX package's ops/__init__ exports a function of the module's own
# name, which ``import a.b as c`` would bind instead of the module.
jfa = importlib.import_module("distributed_mnist_bnns_tpu.ops.flash_attention")

TOL = dict(atol=1e-5, rtol=1e-5)

FWD_CASES = [
    (1, 2, 16, 16, 16, False),
    (1, 2, 16, 16, 16, True),
    (1, 1, 7, 7, 16, False),
    (1, 2, 20, 33, 16, False),
    (1, 2, 12, 16, 16, True),
]


def _inputs(seed, b, h, lq, lk, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, lq, h, d).astype(np.float32)
    k = rng.randn(b, lk, h, d).astype(np.float32)
    v = rng.randn(b, lk, h, d).astype(np.float32)
    g_out = rng.randn(b, lq, h, d).astype(np.float32)
    g_lse = (0.5 * rng.randn(b, lq, h)).astype(np.float32)
    return q, k, v, g_out, g_lse


def _jax_fwd(q, k, v, causal):
    out, lse = jfa.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, True)
    return np.asarray(out), np.asarray(lse)


def _torch_fwd(q, k, v, causal):
    out, lse = tfa.flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal)
    return out.numpy(), lse.numpy()


@pytest.mark.parametrize("b,h,lq,lk,d,causal", FWD_CASES)
def test_forward_matches_jax_interpret(b, h, lq, lk, d, causal):
    q, k, v, _, _ = _inputs(lq * 7 + lk, b, h, lq, lk, d)
    out, lse = _torch_fwd(q, k, v, causal)
    want_out, want_lse = _jax_fwd(q, k, v, causal)
    assert out.shape == (b, lq, h, d) and lse.shape == (b, lq, h)
    assert out.dtype == lse.dtype == np.float32
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(lse, want_lse, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_over_several_key_blocks(monkeypatch, causal):
    """FWD_BLOCK_K = 16 walks 70 keys in 5 blocks, the last ragged: the
    online softmax's rescaling is exercised, not just one block."""
    monkeypatch.setattr(tfa, "FWD_BLOCK_K", 16)
    q, k, v, _, _ = _inputs(5, 2, 2, 40, 70, 8)
    out, lse = _torch_fwd(q, k, v, causal)
    want_out, want_lse = _jax_fwd(q, k, v, causal)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(lse, want_lse, **TOL)
    monkeypatch.setattr(tfa, "FWD_BLOCK_K", 512)
    one_out, one_lse = _torch_fwd(q, k, v, causal)
    np.testing.assert_allclose(out, one_out, **TOL)
    np.testing.assert_allclose(lse, one_lse, **TOL)


@pytest.fixture(params=["pallas", "chunked"])
def jax_bwd(request, monkeypatch):
    """Each backward case against both JAX backward implementations."""
    monkeypatch.setattr(jfa, "_BWD_IMPL", request.param)
    return request.param


def _jax_grads(q, k, v, g_out, g_lse, causal):
    _, vjp = jax.vjp(
        lambda a, b_, c: jfa.flash_attention_with_lse(a, b_, c, causal, True),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
    )
    return [np.asarray(g) for g in vjp((jnp.asarray(g_out),
                                        jnp.asarray(g_lse)))]


def _torch_grads(q, k, v, g_out, g_lse, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_attention_with_lse(qt, kt, vt, causal)
    grads = torch.autograd.grad(
        (out, lse), (qt, kt, vt),
        (torch.from_numpy(g_out), torch.from_numpy(g_lse)),
    )
    return [g.numpy() for g in grads]


@pytest.mark.parametrize("b,h,lq,lk,d,causal", [
    (1, 2, 16, 16, 16, False),
    (1, 2, 16, 16, 16, True),
    (1, 1, 7, 7, 16, False),
    (1, 2, 12, 16, 16, True),
])
def test_backward_matches_jax_vjp(jax_bwd, b, h, lq, lk, d, causal):
    q, k, v, g_out, g_lse = _inputs(lq + 3 * lk, b, h, lq, lk, d)
    got = _torch_grads(q, k, v, g_out, g_lse, causal)
    want = _jax_grads(q, k, v, g_out, g_lse, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_backward_over_several_blocks(monkeypatch, jax_bwd, causal):
    """Several key blocks on both sides: the port's chunked backward at
    BWD_BLOCK_K = 16 over 70 keys, and JAX's at its smallest blocks."""
    monkeypatch.setattr(tfa, "BWD_BLOCK_K", 16)
    monkeypatch.setattr(jfa, "_BWD_BLOCK_K", 16)
    monkeypatch.setattr(jfa, "_BWD_PALLAS_BLOCK_Q", 16)
    q, k, v, g_out, g_lse = _inputs(9, 1, 2, 48, 70, 8)
    got = _torch_grads(q, k, v, g_out, g_lse, causal)
    want = _jax_grads(q, k, v, g_out, g_lse, causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"d{name}")


def test_causal_with_more_queries_than_keys_raises():
    q, k, v, _, _ = _inputs(0, 1, 1, 16, 8, 4)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True)
    with pytest.raises(ValueError, match="Lq <= Lk"):
        jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            True, True)


def test_flash_attention_casts_back_and_matches_the_lse_entry():
    q, k, v, _, _ = _inputs(1, 2, 2, 9, 9, 8)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = tfa.flash_attention(qt.double(), kt.double(), vt.double(), True)
    assert out.dtype == torch.float64
    want, _ = tfa.flash_attention_with_lse(qt, kt, vt, True)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=0)


def test_cpu_tensors_never_touch_the_kernel_loader(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel loader")

    monkeypatch.setattr(_kernels, "_library", refuse)
    q, k, v, g_out, g_lse = _inputs(2, 1, 2, 8, 8, 4)
    _torch_grads(q, k, v, g_out, g_lse, True)


def test_other_devices_and_cpu_tensors_at_the_kernel_wrappers_raise():
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no flash attention for device"):
        tfa.flash_attention(q, q, q)
    x = torch.zeros(1, 4, 2, 8)
    lse = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.flash_fwd(x, x, x, False)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.flash_bwd_dq(x, x, x, x, lse, lse, False)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _kernels.flash_bwd_dkv(x, x, x, x, lse, lse, False)
    with pytest.raises(ValueError, match="want q"):
        tfa.flash_attention(x, torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 3, 8))


def test_row_with_no_key_gives_zero_and_neg_inf():
    """Lk = 0: every row has l == 0, so out 0 and lse NEG_INF, and the
    backward gives zero gradients, as the JAX conventions say."""
    q = torch.randn(1, 3, 1, 4, requires_grad=True)
    k = torch.zeros(1, 0, 1, 4, requires_grad=True)
    out, lse = tfa.flash_attention_with_lse(q, k, k, False)
    assert torch.equal(out, torch.zeros(1, 3, 1, 4))
    assert torch.equal(lse, torch.full((1, 3, 1), tfa.NEG_INF))
    (out.sum() + lse.sum()).backward()
    assert torch.equal(q.grad, torch.zeros_like(q))


# chip_smoke.FLASH_GRAD_TOL: what the card's K5 and K6 are held to against
# the plain versions.
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)

# The six shapes tests_tpu holds the Pallas kernels to, then a causal head
# at the training length: (B, H, Lq, Lk, D, causal).
TF32_SHAPES = [
    (2, 4, 256, 256, 64, False), (2, 4, 256, 256, 64, True),
    (1, 2, 512, 512, 128, True), (1, 1, 7, 7, 16, False),
    (1, 2, 200, 333, 64, False), (1, 2, 96, 128, 64, True),
    (1, 4, 1024, 1024, 64, True),
]

_einsum = torch.einsum


def _tf32(x):
    """fp32 -> TF32 (10 mantissa bits) rounded to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _einsum_3xtf32(eq, a, b):
    """A product as the kernels compute it: each operand split into big =
    tf32(x) and small = tf32(x - big), small*big + big*small + big*big
    summed in fp32 (each TF32 product is exact in fp32)."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return (_einsum(eq, a_small, b_big) + _einsum(eq, a_big, b_small)
            + _einsum(eq, a_big, b_big))


def _einsum_1xtf32(eq, a, b):
    return _einsum(eq, _tf32(a), _tf32(b))


def _fp32_scores(product):
    """The backward's einsums as K5 and K6 compute them: the scores S =
    Q K^T in fp32, every other product (dP = dO V^T, which has the same
    equation and follows S in each key block, dQ, dK, dV) by
    ``product``."""
    calls = [0]

    def einsum(eq, a, b):
        if eq == "bhqd,bhkd->bhqk":
            calls[0] += 1
            if calls[0] % 2:
                return _einsum(eq, a, b)
        return product(eq, a, b)
    return einsum


def _chunked_backward(shape, product=None, monkeypatch=None):
    """dq, dk, dv of the plain chunked backward at ``shape``, from the
    fp32 forward's lse, with every einsum but the scores' replaced by
    ``product``."""
    b, h, lq, lk, d, causal = shape
    q, k, v, g_out, g_lse = map(torch.from_numpy,
                                _inputs(lq + lk + d, b, h, lq, lk, d))
    out, lse = tfa.flash_fwd_plain(q, k, v, causal)
    coeff = (g_lse - (g_out * out).sum(dim=-1)).contiguous()
    args = (q, k, v, g_out, lse.contiguous(), coeff, causal)
    if product is not None:
        monkeypatch.setattr(torch, "einsum", _fp32_scores(product))
    dq = tfa.flash_bwd_dq_plain(*args)
    if product is not None:
        monkeypatch.setattr(torch, "einsum", _fp32_scores(product))
    dk, dv = tfa.flash_bwd_dkv_plain(*args)
    if product is not None:
        monkeypatch.setattr(torch, "einsum", _einsum)
    return dq, dk, dv


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                   # a TF32 value: kept
    x = torch.tensor([1.0, one, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, one, 1.0, -one, one], dtype=torch.float32)
    assert torch.equal(_tf32(x), want)


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=str)
def test_3xtf32_backward_within_the_kernels_tolerance(monkeypatch, shape):
    """The arithmetic of K5 and K6 (fp32 scores, the other products in
    3xTF32) meets FLASH_GRAD_TOL against the fp32 plain versions at every
    shape the card checks the kernels at."""
    want = _chunked_backward(shape)
    got = _chunked_backward(shape, _einsum_3xtf32, monkeypatch)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, **GRAD_TOL, msg=name)


def test_1xtf32_backward_misses_the_tolerance(monkeypatch):
    """One TF32 product (no split) is not accurate enough: the 3xTF32
    split is what meets the tolerance."""
    shape = TF32_SHAPES[-1]
    want = _chunked_backward(shape)
    got = _chunked_backward(shape, _einsum_1xtf32, monkeypatch)
    assert not all(torch.allclose(g, w, **GRAD_TOL)
                   for g, w in zip(got, want))


# chip_smoke.py holds K4's out and lse to this against the plain version.
FWD_TOL = dict(atol=2e-5, rtol=2e-5)
K4_TILE = 64   # K4's key tile: one online-softmax update per tile


def _stepwise(product):
    """K4's two einsums: S = Q K^T in fp32, and P V by ``product`` with
    each 8-key step summed from zero and added in fp32."""
    def einsum(eq, a, b):
        if eq != "bhqk,bhkd->bhqd":
            return _einsum(eq, a, b)
        out = None
        for k0 in range(0, a.shape[-1], 8):
            part = product(eq, a[..., k0:k0 + 8], b[..., k0:k0 + 8, :])
            out = part if out is None else out + part
        return out
    return einsum


def _forward(shape, product=None, monkeypatch=None):
    b, h, lq, lk, d, causal = shape
    q, k, v, _, _ = map(torch.from_numpy,
                        _inputs(lq + lk + d + 1, b, h, lq, lk, d))
    if product is None:
        return tfa.flash_fwd_plain(q, k, v, causal)
    with monkeypatch.context() as mp:
        mp.setattr(tfa, "FWD_BLOCK_K", K4_TILE)
        mp.setattr(torch, "einsum", _stepwise(product))
        return tfa.flash_fwd_plain(q, k, v, causal)


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=str)
def test_k4_arithmetic_within_the_kernels_tolerance(monkeypatch, shape):
    """K4 as built: scores in fp32, P V in 3xTF32 summed per 8-key step,
    online softmax over 64-key tiles; within 2e-5 of the plain version."""
    want = _forward(shape)
    got = _forward(shape, _einsum_3xtf32, monkeypatch)
    for name, g, w in zip(("out", "lse"), got, want):
        torch.testing.assert_close(g, w, **FWD_TOL, msg=name)


def test_1xtf32_forward_misses_the_tolerance(monkeypatch):
    """P V in one TF32 product per step misses 2e-5: the forward needs
    the split as much as the backward does."""
    shape = TF32_SHAPES[-1]
    want = _forward(shape)
    got = _forward(shape, _einsum_1xtf32, monkeypatch)
    assert not all(torch.allclose(g, w, **FWD_TOL) for g, w in zip(got, want))
