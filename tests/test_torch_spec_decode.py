"""Self-speculative decoding in the PyTorch port, against the JAX package.

The cases follow the JAX package's ``tests/test_lm_spec.py``
(``TestEngineSpecDecode``) on the tiny LM of ``tests/torch_lm_util.py``
(weights from a numpy seed, random biases and LN parameters):

  * the verifier's projection (the packed one of the kernel route, K7
    at S x K >= 16 rows, K1 below; their plain versions here) equals K1's
    plain version (``_xnor_matmul_binarize``) bit for bit, at the tiny
    LM's and the chip's LM shapes and at K = 999, where rows chosen to
    sum to +-999, +-799 and other odd values above 256 must come out as
    the exact integer sums (a bf16 output would round them);
  * ``verify`` against the JAX package's (its Pallas kernels in
    interpret mode), on both paths of each side: log-probs and the K/V it
    writes within 1e-5 (flax's LayerNorm against the port's, and the
    softmax's order of summation, differ by float32 rounding);
  * the engine at ``spec_k = 4`` token for token the ``spec_k = 1``
    engine (the verifier alone) over three staggered streams, not the
    plain packed engine: drafts and verifier may part on last-ulp LN and
    attention differences, and every emitted token is a verifier argmax;
  * exact budgets ending inside a window, the fall back to plain rounds
    when a stream samples, chaos retried before the round's dispatches,
    the counters and the server's health fields.
"""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu.infer_transformer import (
    make_paged_lm_decoder as jax_paged_decoder,
)
from distributed_mnist_bnns_tpu_torch.infer_transformer import (
    _packed_dense_fn,
    make_paged_lm_decoder,
)
from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
from distributed_mnist_bnns_tpu_torch.obs import Telemetry, load_events
from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import prepack_weights
from distributed_mnist_bnns_tpu_torch.resilience import (
    ChaosController,
    reset_fire_counts,
)
from distributed_mnist_bnns_tpu_torch.serve.core import labeled
from distributed_mnist_bnns_tpu_torch.serve.lm import (
    LMEngine,
    LMServeConfig,
    LMServer,
)
from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests.torch_lm_util import frozen_pair

VERIFY_ATOL = 1e-5
PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], [4] * 9)   # JAX's staggered streams
WANTS = (14, 3, 6)


@pytest.fixture(autouse=True)
def _fresh_chaos_ledger():
    reset_fire_counts()
    yield
    reset_fire_counts()


@pytest.fixture(scope="module")
def pair():
    return frozen_pair(seed=0)


def _decoder(frozen, spec_k, slots=2, kernels=False, **kw):
    return make_paged_lm_decoder(frozen, slots=slots, page_size=4,
                                 prefill_chunk=8, spec_k=spec_k,
                                 kernels=kernels, device="cpu", **kw)


def _drain(req, timeout=120.0):
    toks, deadline = [], time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(deadline - time.monotonic(), 0.1))
        if ev["kind"] == "done":
            return toks, ev
        toks.append(ev["token"])


def _serve(dec, prompts, wants, req_kw=None, **kw):
    """Submit every prompt at once (the streams join as slots free) and
    drain them; returns (tokens of each, the stopped engine)."""
    eng = LMEngine(dec, queue_depth=8, **kw).start()
    try:
        reqs = [eng.submit(np.asarray(p, np.int32), n,
                           time.monotonic() + 120, **kw_r)
                for p, n, kw_r in zip(prompts, wants,
                                      req_kw or [{}] * len(prompts))]
        out = [_drain(r) for r in reqs]
    finally:
        eng.stop()
    assert all(d["status"] == "ok" for _, d in out), out
    assert eng.allocator.used_count() == 0
    return [t for t, _ in out], eng


# -- the verifier's GEMM -----------------------------------------------------


def _big_sum_rows(gen, k, n, m):
    """(m, k) real x whose signs make some sums with (k, n) ±1 w large
    and odd: +-w's columns (sum +-k) and one with 100 flips (k - 200)."""
    w = torch.where(torch.rand(k, n, generator=gen) > 0.5, 1.0, -1.0)
    x = torch.randn(m, k, generator=gen)
    x[0] = w[:, 0] * (0.5 + torch.rand(k, generator=gen))
    x[1] = -w[:, 1] * (0.5 + torch.rand(k, generator=gen))
    flip = w[:, 2].clone()
    flip[:100] = -flip[:100]
    x[2] = flip
    return x, w


@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("m,k,n", [
    (8, 32, 32), (8, 32, 64), (8, 64, 32),           # the tiny LM
    (16, 256, 256), (16, 256, 512), (16, 512, 256),  # the chip's LM
    (16, 999, 40),
])
def test_verifier_projection_equals_k1_bitwise(m, k, n, alpha):
    gen = torch.Generator().manual_seed(k + n)
    x, w = _big_sum_rows(gen, k, n, m)
    wp, kk, nn = prepack_weights(w)
    layer = {"wp": wp, "k": kk, "n": nn, "bias": torch.randn(n, generator=gen)}
    if alpha:
        layer["alpha"] = torch.rand(n, generator=gen)
    got = _packed_dense_fn(layer, fused=True)(x)   # verify's route
    want = _packed_dense_fn(layer)(x)              # K1's plain version
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    if k == 999:
        sums = _packed_dense_fn({**layer, "bias": torch.zeros(n),
                                 "alpha": None}, fused=True)(x)
        exact = torch.where(x >= 0, 1.0, -1.0).double() @ w.double()
        assert sums[0, 0] == k and sums[1, 1] == -k
        assert sums[2, 2] == k - 200
        assert torch.equal(sums.double(), exact)
        # what a bf16 output would give: its 8-bit mantissa rounds them
        rounded = exact.to(torch.bfloat16).double()
        assert not torch.equal(rounded, exact)


# -- verify against the JAX package -----------------------------------------


@pytest.mark.parametrize("kernels", [False, True])
def test_verify_matches_jax_verify(pair, kernels):
    """Prefill two sequences, then one verify window of 4 a slot (slot 1
    crossing a page boundary): log-probs and every written K/V row
    against the JAX package's verify on the same pools."""
    jfrozen, frozen = pair
    jdec = jax_paged_decoder(jfrozen, slots=2, page_size=4, prefill_chunk=8,
                             interpret=True, donate=False, spec_k=4,
                             kernels=kernels)
    dec = _decoder(frozen, 4, kernels=kernels)
    tables = np.zeros((2, dec.max_pages), np.int32)
    tables[0, :4] = [3, 1, 7, 2]
    tables[1, :4] = [5, 4, 6, 8]
    prompts = (np.asarray([5, 9, 13, 2, 7, 1, 3, 0], np.int32),
               np.asarray([11, 4, 4, 30, 17, 8, 0, 0], np.int32))
    lengths = (7, 6)
    pools, jpools = dec.init_pools(), jdec.init_pools()
    for s, (prompt, n) in enumerate(zip(prompts, lengths)):
        pools, _ = dec.prefill(pools, prompt, tables[s], 0, n)
        jpools, _ = jdec.prefill(jpools, jnp.asarray(prompt),
                                 jnp.asarray(tables[s]),
                                 jnp.asarray(np.int32(0)),
                                 jnp.asarray(np.int32(n)))
    window = np.asarray([[6, 12, 1, 30], [2, 2, 9, 14]], np.int32)
    positions = np.asarray(lengths, np.int32)
    pools, lp = dec.verify(pools, window, tables, positions)
    jpools, jlp = jdec.verify(jpools, jnp.asarray(window),
                              jnp.asarray(tables), jnp.asarray(positions))
    assert lp.shape == (2, 4, dec.vocab)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp),
                               atol=VERIFY_ATOL, rtol=VERIFY_ATOL)
    for (kp, vp), (jkp, jvp) in zip(pools, jpools):
        np.testing.assert_allclose(kp.numpy()[1:], np.asarray(jkp)[1:],
                                   atol=VERIFY_ATOL, rtol=VERIFY_ATOL)
        np.testing.assert_allclose(vp.numpy()[1:], np.asarray(jvp)[1:],
                                   atol=VERIFY_ATOL, rtol=VERIFY_ATOL)


def test_decoder_spec_k_geometry(pair):
    _, frozen = pair
    assert _decoder(frozen, 0).verify is None
    dec = _decoder(frozen, 3)
    assert dec.spec_k == 3 and dec.verify is not None
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        _decoder(frozen, -1)


# -- the engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def verifier_alone(pair):
    """The spec_k = 1 engine's tokens for the staggered streams."""
    toks, _ = _serve(_decoder(pair[1], 1), PROMPTS, WANTS)
    return toks


@pytest.mark.parametrize("kernels", [False, True])
def test_spec_engine_equals_verifier_alone(pair, verifier_alone, kernels,
                                           tmp_path):
    with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
        toks, eng = _serve(_decoder(pair[1], 4, kernels=kernels), PROMPTS,
                           WANTS, telemetry=tel, decode_event_every=1)
    assert toks == verifier_alone
    assert [len(t) for t in toks] == list(WANTS)
    assert eng.spec_acceptance_rate > 0.5
    assert eng.spec_rounds > 0
    spec = labeled(eng.spec_tokens_ctr)
    drafted = spec.get("outcome=accepted", 0) + spec.get(
        "outcome=rejected", 0)
    assert drafted == eng._spec_drafted > 0
    assert eng.metrics()["lm_spec_tokens_total"] == spec
    events = load_events(str(tmp_path / "tel" / "events.jsonl"))
    warm = next(e for e in events if e["kind"] == "lm_warmup")
    assert (warm["programs"], warm["spec_k"]) == (3, 4)
    rounds = [e for e in events if e["kind"] == "lm_spec_round"]
    assert rounds and all(e["spec_k"] == 4 for e in rounds)


def test_budget_ends_inside_a_window(pair):
    """Budgets of 5 and 9 tokens (no multiples of K = 4): each stream
    emits exactly its budget and equals the verifier alone."""
    prompts, wants = ([3, 1, 4], [2, 7, 1, 8]), (5, 9)
    spec, _ = _serve(_decoder(pair[1], 4), prompts, wants)
    alone, _ = _serve(_decoder(pair[1], 1), prompts, wants)
    assert [len(t) for t in spec] == [5, 9]
    assert spec == alone


def test_sampling_stream_falls_back_to_plain_rounds(pair):
    """A temperature stream turns the round plain; it samples the same
    tokens from the same seed, and its greedy batchmate still equals the
    verifier alone."""
    frozen = pair[1]
    prompts, wants = ([5, 6], [1, 2, 3]), (6, 6)
    req_kw = [{"temperature": 0.8, "seed": 7}, {}]
    a, eng = _serve(_decoder(frozen, 4), prompts, wants, req_kw=req_kw)
    b, _ = _serve(_decoder(frozen, 4), prompts, wants, req_kw=req_kw)
    alone, _ = _serve(_decoder(frozen, 1), prompts[1:], wants[1:])
    assert a[0] == b[0]
    assert a[1] == b[1] == alone[0]


def test_spec_round_retries_an_injected_error(pair, tmp_path):
    """Chaos fires before the round's first dispatch: the round is
    retried and the stream ends ok with every token."""
    dec = _decoder(pair[1], 4, slots=1)
    with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
        chaos = ChaosController.from_config("infer_error@step=2,times=2",
                                            seed=0, telemetry=tel)
        toks, eng = _serve(dec, ([1, 2, 3],), (12,), telemetry=tel,
                           chaos=chaos)
    alone, _ = _serve(_decoder(pair[1], 1, slots=1), ([1, 2, 3],), (12,))
    assert toks == alone and len(toks[0]) == 12
    assert eng.errors_ctr.value(kind="ChaosInferError") == 2
    kinds = {e["kind"] for e in load_events(
        str(tmp_path / "tel" / "events.jsonl"))}
    assert {"fault_injected", "lm_decode_error"} <= kinds


def test_server_spec_decode_and_prefix_cache_health(pair, tmp_path):
    """``serve --lm --spec-decode 4 --prefix-cache``: streams equal the
    verifier alone, /healthz reports the window, the acceptance rate and
    the cache, the drain returns every page."""
    from distributed_mnist_bnns_tpu_torch import cli

    path = tmp_path / "lm.msgpack"
    path.write_bytes(msgpack.msgpack_serialize(frozen_to_jax(pair[1])))
    args = cli.build_parser().parse_args(
        ["serve", "--lm", "--artifact", str(path), "--spec-decode", "4",
         "--prefix-cache"])
    assert (args.spec_decode, args.prefix_cache) == (4, True)
    srv = LMServer(LMServeConfig(
        artifact=str(path), device="cpu", port=0, slots=2, page_size=4,
        prefill_chunk=8, spec_decode=args.spec_decode,
        prefix_cache=args.prefix_cache))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        got = []
        for prompt, n in zip(PROMPTS, WANTS):
            code, events = lc.generate(base, prompt, max_new_tokens=n,
                                       deadline_ms=60000.0)
            assert code == 200 and events[-1]["status"] == "ok", events
            got.append([e["token"] for e in events[:-1]])
        health = json.loads(lc.healthz(base)[1])
    finally:
        srv.request_stop("test over")
        stats = srv.drain_and_stop()
    alone, _ = _serve(_decoder(pair[1], 1), PROMPTS, WANTS)
    assert got == alone
    assert health["spec_k"] == 4 and health["spec_acceptance_rate"] > 0.5
    assert health["prefix_cache_entries"] > 0
    assert 0 < health["shared_page_occupancy"] <= 1
    assert stats["pages_in_use"] == 0 and stats["prefix_cache_entries"] == 0
    assert stats["spec_acceptance_rate"] == health["spec_acceptance_rate"]
