"""The PyTorch port's frozen LM and its decoders against the JAX package's.

Weights come from a numpy seed (``tests/torch_lm_util.py``). Freezing is
bitwise (packed words; alpha to a few ulp, rtol 1e-6, since XLA's CPU
mean sums in another order); the frozen forward and the decoders agree to fp32
tolerance, and greedy tokens are identical. The JAX paged decoder runs
its Pallas kernels with ``interpret=True``; the port's runs its kernel
entries on CPU tensors, i.e. their plain versions, routed as on the card
(K1 below ``FUSED_UNPACK_MIN_M`` rows, K7 at or above it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu import infer_transformer as J
from distributed_mnist_bnns_tpu_torch import infer_transformer as T
from distributed_mnist_bnns_tpu_torch.infer import export_packed, load_packed
from distributed_mnist_bnns_tpu_torch.ops import _kernels
from tests.torch_lm_util import frozen_pair, lm_pair, tokens

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def pair():
    return frozen_pair(seed=0, scale=True)


@pytest.mark.parametrize("kw", [
    {}, {"scale": True}, {"binarized_attention": False},
], ids=["binarized", "scale", "fp32-attention"])
def test_freeze_matches_jax(kw):
    jm, params, tm = lm_pair(seed=2, **kw)
    jf = J._freeze_lm_tensors(jm, {"params": params})
    tf = T._freeze_lm_tensors(tm)
    assert tf["info"] == jf["info"]
    for key in ("family", "kind", "num_heads", "causal"):
        assert tf[key] == jf[key]
    for jb, tb in zip(jf["blocks"], tf["blocks"]):
        for key in ("q", "k", "v", "out", "mlp1", "mlp2"):
            if "wp" in jb[key]:
                np.testing.assert_array_equal(tb[key]["wp"].numpy(),
                                              np.asarray(jb[key]["wp"]))
                assert (tb[key]["k"], tb[key]["n"]) == (jb[key]["k"],
                                                        jb[key]["n"])
            else:
                np.testing.assert_array_equal(tb[key]["kernel"].numpy(),
                                              np.asarray(jb[key]["kernel"]))
            assert ("alpha" in tb[key]) == ("alpha" in jb[key])
            if "alpha" in jb[key]:
                np.testing.assert_allclose(
                    tb[key]["alpha"].numpy(), np.asarray(jb[key]["alpha"]),
                    rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tf["head_w"].numpy(),
                                  np.asarray(jf["head_w"]))


def test_frozen_forward_matches_jax_and_the_live_model(pair, tmp_path):
    jf, tf = pair
    toks = np.stack([tokens(1, 24), tokens(2, 24)])
    want = np.asarray(J._build_transformer_apply(jf, interpret=True)(
        jnp.asarray(toks)))
    got = T._build_transformer_apply(tf, "cpu")(toks).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the live port model, frozen through its own path and an artifact
    _, _, tm = lm_pair(seed=0, scale=True)
    fn, info = T.freeze_bnn_lm(tm, device="cpu")
    assert info["kind"] == "lm" and info["compression"] > 1
    with torch.no_grad():
        live = tm(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(fn(toks).numpy(), live, atol=1e-4, rtol=0)
    path = str(tmp_path / "lm.msgpack")
    assert export_packed(tm, path) == info
    loaded, linfo = load_packed(path, device="cpu")
    assert linfo == info
    np.testing.assert_array_equal(loaded(toks).numpy(), fn(toks).numpy())


@pytest.mark.parametrize("plen,n", [(5, 10), (21, 8), (16, 1)])
def test_generate_is_token_identical_to_jax(pair, plen, n):
    jf, tf = pair
    prompt = tokens(3 + plen, plen)[None]
    want = np.asarray(J.generate(
        jf, jnp.asarray(prompt), n, interpret=True,
        decoder=J.make_lm_decoder(jf, interpret=True),
    ))
    got = T.generate(tf, prompt, n, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _teacher_force(dec, conv, seq, table, plen, chunk=8):
    """Prefill ``plen`` tokens in chunks, then decode the rest one
    position at a time in slot 0 (slot 1 idle); all log-probs."""
    pools = dec.init_pools()
    out = []
    for start in range(0, plen, chunk):
        toks = np.zeros(chunk, np.int32)
        part = seq[start:min(start + chunk, plen)]
        toks[:len(part)] = part
        pools, lp = dec.prefill(pools, conv(toks), conv(table),
                                conv(np.int32(start)), conv(np.int32(plen)))
        out.append(np.asarray(lp)[:len(part)])
    tables = np.zeros((2, len(table)), np.int32)
    tables[0] = table
    for t in range(plen, len(seq)):
        pools, lp = dec.decode(pools, conv(np.asarray([seq[t], 0], np.int32)),
                               conv(tables),
                               conv(np.asarray([t, 0], np.int32)))
        out.append(np.asarray(lp)[:1])
    return np.concatenate(out)


@pytest.mark.parametrize("chunk", [8, 16])
def test_paged_decoder_matches_jax_kernels_across_page_boundaries(pair, chunk):
    jf, tf = pair
    seq = tokens(7, 29)
    geo = dict(slots=2, page_size=4, prefill_chunk=chunk)
    jd = J.make_paged_lm_decoder(jf, **geo, interpret=True, donate=False,
                                 kernels=True)
    td = T.make_paged_lm_decoder(tf, **geo, device="cpu")
    table = np.zeros(td.max_pages, np.int32)
    table[:8] = [3, 1, 6, 2, 7, 4, 5, 8]          # scrambled page order
    want = _teacher_force(jd, jnp.asarray, seq, table, 19, chunk)
    got = _teacher_force(td, np.asarray, seq, table, 19, chunk)
    np.testing.assert_allclose(got, want, **TOL)
    plain = T.make_paged_lm_decoder(tf, **geo, kernels=False, device="cpu")
    np.testing.assert_array_equal(
        _teacher_force(plain, np.asarray, seq, table, 19, chunk), got)
    # and the contiguous decoder, position by position
    init, step = T.make_lm_decoder(tf, device="cpu")
    caches = init(1)
    ref = []
    for t in range(len(seq)):
        caches, lp = step(caches, seq[None, t], t)
        ref.append(lp.numpy())
    np.testing.assert_allclose(got, np.concatenate(ref), **TOL)


def test_prefill_and_decode_route_k7_and_k1_by_rows(pair, monkeypatch):
    """M = prefill_chunk = 16 rows reach K7's entry, M = slots = 2 rows
    K1's (the entry that binarizes inside the kernel); attention goes
    through K8's entry. On the CPU each entry runs its plain version and
    the loader is never touched."""
    _, tf = pair
    calls = []
    for name in ("xnor_matmul_fused_unpack", "_xnor_matmul_binarize"):
        inner = getattr(T, name)
        monkeypatch.setattr(T, name, lambda x, *a, _n=name, _f=inner: (
            calls.append((_n, x.shape[0])) or _f(x, *a)))

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA kernel path was entered")

    monkeypatch.setattr(_kernels, "_library", refuse)
    seen = []
    inner_attn = T.paged_kv._paged_attention
    monkeypatch.setattr(T.paged_kv, "_paged_attention", lambda q4, *a: (
        seen.append(tuple(q4.shape[:2])) or inner_attn(q4, *a)))
    dec = T.make_paged_lm_decoder(tf, slots=2, page_size=4,
                                  prefill_chunk=16, device="cpu")
    table = np.arange(1, 1 + dec.max_pages, dtype=np.int32)
    _teacher_force(dec, np.asarray, tokens(8, 18), table, 16, chunk=16)
    n_proj = 6 * dec.num_blocks
    assert calls[:n_proj] == [("xnor_matmul_fused_unpack", 16)] * n_proj
    assert set(calls[n_proj:]) == {("_xnor_matmul_binarize", 2)}
    assert seen == [(1, 16)] * dec.num_blocks + [(2, 1)] * 2 * dec.num_blocks


def test_entry_points_raise_without_a_card_and_on_bad_options(pair,
                                                               monkeypatch):
    _, tf = pair
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for build in (lambda: T.make_paged_lm_decoder(tf, slots=2),
                  lambda: T.make_lm_decoder(tf),
                  lambda: T._build_transformer_apply(tf, None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # speculative decoding and the vit kind are ported: what stays
    # refused is a negative window and an unknown kind
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        T.make_paged_lm_decoder(tf, slots=2, spec_k=-1, device="cpu")
    with pytest.raises(ValueError, match="unknown bnn-transformer kind"):
        T._build_transformer_apply({**tf, "kind": "moe"}, "cpu")
    with pytest.raises(ValueError, match="kind='vit'"):
        T.FrozenViT(tf, "cpu")
    # kernels=False is refused on a CUDA device before any weight moves
    monkeypatch.setattr(T, "resolve_device", lambda d: torch.device("cuda"))
    with pytest.raises(ValueError, match="kernels=False"):
        T.make_paged_lm_decoder(tf, slots=2, kernels=False, device="cuda")
