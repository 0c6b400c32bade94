"""Copy-on-write prefix caching in the PyTorch port, against the JAX
package (``tests/test_lm_spec.py``: ``TestPrefixCacheIndex``,
``TestCowAndHitOracle``, ``TestEnginePrefixCache``), and the LM client's
retries before a stream opens.

  * the radix index: each of the JAX index tests' oracles, run on the
    port's ``PrefixCache`` and on the JAX package's (both over their own
    ``PageAllocator``), the same answers from both;
  * a forked prefix stays bitwise intact while the forking sequence
    prefills and decodes past it (both decoder paths);
  * a hit's suffix log-probs equal a cold prefill's within 1e-5 (the
    suffix attends through the shared pages; the causal softmax over
    the same keys, summed in another chunking);
  * the engine: a hit's tokens equal a cold engine's, admissions report
    cached and prefilled tokens, an undersized pool evicts LRU entries
    and still admits, a dispatch failure empties the index, speculative
    decoding composes with the cache.
"""

import json
import threading
import time
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

from distributed_mnist_bnns_tpu.ops.paged_kv import (
    PageAllocator as JaxAllocator,
)
from distributed_mnist_bnns_tpu.serve.lm.prefix_cache import (
    PrefixCache as JaxPrefixCache,
)
from distributed_mnist_bnns_tpu_torch.infer_transformer import (
    generate,
    make_lm_decoder,
    make_paged_lm_decoder,
)
from distributed_mnist_bnns_tpu_torch.obs import Telemetry, load_events
from distributed_mnist_bnns_tpu_torch.ops.paged_kv import PageAllocator
from distributed_mnist_bnns_tpu_torch.serve.core import labeled
from distributed_mnist_bnns_tpu_torch.serve.httpbase import JsonHandler
from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine, PrefixCache
from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc
from tests.torch_lm_util import frozen_pair, tokens

HIT_ATOL = 1e-5
IMPLS = {"port": (PageAllocator, PrefixCache),
         "jax": (JaxAllocator, JaxPrefixCache)}


def _cache(impl, num_pages=12, ps=4):
    alloc_cls, cache_cls = IMPLS[impl]
    alloc = alloc_cls(num_pages)
    return alloc, cache_cls(alloc, ps)


def _arange(n):
    return np.arange(n, dtype=np.int32)


# -- the radix index ----------------------------------------------------------


def _insert_then_lookup(impl):
    alloc, cache = _cache(impl)
    toks = _arange(10)                          # 2 full blocks + a tail
    pages = alloc.alloc(3)
    out = [cache.insert(toks, pages), alloc.refcount(pages[2])]
    n, hit = cache.lookup(toks, max_tokens=9)
    out += [n, hit == pages[:2], [alloc.refcount(p) for p in hit]]
    alloc.free(hit)
    other = np.concatenate([toks[:4], [9, 9, 9, 9, 0]]).astype(np.int32)
    n, hit = cache.lookup(other, max_tokens=len(other) - 1)
    out += [n, hit == pages[:1]]
    alloc.free(hit)
    n, hit = cache.lookup(toks, max_tokens=4)     # the cap holds
    out += [n, len(hit)]
    alloc.free(hit)
    return out, [2, 0, 8, True, [2, 2], 4, True, 4, 1]


def _miss_and_stats(impl):
    _, cache = _cache(impl)
    out = [cache.lookup(_arange(8), 7), cache.stats()["misses"]]
    cache.note_result(False)   # the admission's count, not the lookup's
    s = cache.stats()
    return out + [s["entries"], s["misses"]], [(0, []), 0, 0, 1]


def _dedup(impl):
    alloc, cache = _cache(impl)
    toks = _arange(8)
    out = [cache.insert(toks, alloc.alloc(2))]
    second = alloc.alloc(2)
    out += [cache.insert(toks, second),
            [alloc.refcount(p) for p in second], cache.entries]
    return out, [2, 0, [0, 0], 2]


def _lru_eviction(impl):
    alloc, cache = _cache(impl, num_pages=16)
    old = np.asarray([1, 1, 1, 1, 2, 2, 2, 2], np.int32)
    new = np.asarray([3, 3, 3, 3], np.int32)
    cache.insert(old, alloc.alloc(2))
    cache.insert(new, alloc.alloc(1))
    _, hit = cache.lookup(np.concatenate([new, [0]]).astype(np.int32), 4)
    alloc.free(hit)                  # `new` touched: `old` is older
    free0 = alloc.free_count()
    out = [cache.evict(2), alloc.free_count() - free0]
    out.append(cache.lookup(np.concatenate([old, [0]]).astype(np.int32),
                            8)[0])
    n, hit = cache.lookup(np.concatenate([new, [0]]).astype(np.int32), 4)
    alloc.free(hit)
    return out + [n], [2, 2, 0, 4]


def _eviction_skips_live(impl):
    alloc, cache = _cache(impl)
    toks = _arange(8)
    cache.insert(toks, alloc.alloc(2))
    n, hit = cache.lookup(toks, 8)             # a live sequence forks
    out = [n, cache.evict(5), cache.entries]
    alloc.free(hit)                            # it ends
    return out + [cache.evict(5), cache.entries], [8, 0, 2, 2, 0]


def _clear(impl):
    alloc, cache = _cache(impl)
    toks = _arange(8)
    cache.insert(toks, alloc.alloc(2))
    n, hit = cache.lookup(toks, 8)
    out = [n, cache.clear(), [alloc.refcount(p) for p in hit]]
    alloc.free(hit)
    return out + [alloc.free_count() == alloc.capacity], [8, 2, [1, 1], True]


@pytest.mark.parametrize("impl", ["port", "jax"])
@pytest.mark.parametrize("case", [
    _insert_then_lookup, _miss_and_stats, _dedup, _lru_eviction,
    _eviction_skips_live, _clear,
], ids=lambda f: f.__name__.strip("_") if callable(f) else f)
def test_index_oracle(case, impl):
    got, want = case(impl)
    assert got == want
    if impl == "port":
        assert case("jax")[0] == got      # the JAX package's, step by step


# -- copy-on-write and the cold-prefill oracle --------------------------------


@pytest.fixture(scope="module")
def frozen():
    return frozen_pair(seed=1)[1]


def _decoder(frozen, **kw):
    kw = {"slots": 2, "page_size": 4, "prefill_chunk": 8, **kw}
    return make_paged_lm_decoder(frozen, device="cpu", **kw)


@pytest.mark.parametrize("kernels", [False, True])
def test_forked_prefix_stays_bitwise_intact(frozen, kernels):
    dec = _decoder(frozen, kernels=kernels)
    prompt = np.asarray([5, 9, 13, 2, 7, 1, 3, 4], np.int32)   # 2 pages
    pools = dec.init_pools()
    table_a = np.zeros(dec.max_pages, np.int32)
    table_a[:4] = [1, 2, 3, 4]
    pools, _ = dec.prefill(pools, prompt, table_a, 0, 8)
    shared = [1, 2]
    before = [(k[shared].clone(), v[shared].clone()) for k, v in pools]
    table_b = np.zeros(dec.max_pages, np.int32)
    table_b[:4] = [1, 2, 5, 6]
    pools, _ = dec.prefill(pools, np.asarray([9, 9, 6, 1, 0, 0, 0, 0],
                                             np.int32), table_b, 8, 12)
    tables = np.zeros((2, dec.max_pages), np.int32)
    tables[0] = table_b
    for t in (12, 13, 14):
        pools, _ = dec.decode(pools, np.asarray([(t * 7) % 32, 0]), tables,
                              np.asarray([t, 0]))
    for (kb, vb), (k, v) in zip(before, pools):
        assert k[shared].equal(kb) and v[shared].equal(vb)


@pytest.mark.parametrize("kernels", [False, True])
def test_hit_suffix_logprobs_equal_cold_prefill(frozen, kernels):
    dec = _decoder(frozen, slots=1, kernels=kernels)
    prompt = tokens(3, 12)
    table = np.zeros(dec.max_pages, np.int32)
    table[:3] = [1, 2, 3]
    pools, cold = dec.init_pools(), []
    padded = np.pad(prompt, (0, 4))
    for start in (0, 8):
        pools, lp = dec.prefill(pools, padded[start:start + 8], table,
                                start, 12)
        cold.append(lp)
    cold = np.concatenate([c.numpy() for c in cold])[:12]
    hit_table = np.zeros(dec.max_pages, np.int32)
    hit_table[:3] = [1, 2, 4]                   # shared, shared, its own
    sfx = np.zeros(8, np.int32)
    sfx[:4] = prompt[8:]
    pools, hit = dec.prefill(pools, sfx, hit_table, 8, 12)
    np.testing.assert_allclose(hit.numpy()[:4], cold[8:12], atol=HIT_ATOL,
                               rtol=HIT_ATOL)


# -- the engine ---------------------------------------------------------------


def _drain(req, timeout=120.0):
    toks, deadline = [], time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(deadline - time.monotonic(), 0.1))
        if ev["kind"] == "done":
            return toks, ev
        toks.append(ev["token"])


def _greedy(frozen, prompt, n):
    out = generate(frozen, np.asarray(prompt)[None], n,
                   decoder=make_lm_decoder(frozen, device="cpu"))
    return out[0, len(prompt):].tolist()


SHARED = np.asarray([7, 3, 1, 4, 9, 2, 6, 5, 8, 1], np.int32)


@pytest.mark.parametrize("kernels", [False, True])
def test_hit_tokens_equal_a_cold_engine(frozen, kernels, tmp_path):
    ext = np.concatenate([SHARED, [11, 12]]).astype(np.int32)
    runs = (("cold", SHARED, 8), ("hit", SHARED, 8), ("partial", ext, 5))
    outs = {}
    with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
        eng = LMEngine(_decoder(frozen, kernels=kernels), queue_depth=8,
                       telemetry=tel, prefix_cache=True).start()
        for name, prompt, n in runs:
            toks, done = _drain(eng.submit(prompt, n, time.monotonic() + 120))
            assert done["status"] == "ok", done
            outs[name] = toks
        stats = eng.prefix_cache_stats()
        assert stats["entries"] > 0 and stats["hits"] == 2
        assert eng.allocator.used_count() == stats["pages"]
        prefill_tokens = labeled(eng.tokens_ctr)["phase=prefill"]
        hits = labeled(eng.prefix_hits_ctr)
        eng.stop()
        assert eng.allocator.used_count() == 0
    cold = LMEngine(_decoder(frozen, kernels=kernels), queue_depth=8).start()
    try:
        want = {name: _drain(cold.submit(p, n, time.monotonic() + 120))[0]
                for name, p, n in runs}
    finally:
        cold.stop()
    assert outs == want
    assert outs["cold"] == _greedy(frozen, SHARED, 8)
    assert prefill_tokens == 10 + 2 + 4       # suffixes only on a hit
    assert hits == {"result=miss": 1, "result=hit": 2}
    events = load_events(str(tmp_path / "tel" / "events.jsonl"))
    admits = [e for e in events if e["kind"] == "lm_admit"]
    assert [(a["cached_tokens"], a["prefill_tokens"]) for a in admits] == [
        (0, 10), (8, 2), (8, 4)]
    assert len([e for e in events if e["kind"] == "lm_prefix_hit"]) == 2
    assert any(e.get("pages_published", 0) > 0 for e in events
               if e["kind"] == "lm_evict")


def test_pool_pressure_evicts_lru_entries(frozen):
    """7 allocatable pages; a 10-token prompt with 6 new tokens needs 4:
    the first request's published pages must make room for the second."""
    eng = LMEngine(_decoder(frozen, slots=1, num_pages=8), queue_depth=4,
                   prefix_cache=True).start()
    try:
        _, d1 = _drain(eng.submit(_arange(10) + 1, 6,
                                  time.monotonic() + 120))
        assert d1["status"] == "ok" and eng.prefix_cache_stats()["pages"] > 0
        b = np.asarray([30, 29, 28, 27, 26, 25, 24, 23, 22, 21], np.int32)
        toks, d2 = _drain(eng.submit(b, 6, time.monotonic() + 120))
    finally:
        eng.stop()
    assert d2["status"] == "ok" and toks == _greedy(frozen, b, 6)


def test_dispatch_failure_invalidates_the_index(frozen, tmp_path):
    dec = _decoder(frozen, slots=1)
    real_decode, fail = dec.decode, [False]

    def flaky_decode(*args):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("simulated mid-dispatch failure")
        return real_decode(*args)

    prompt = _arange(9) + 1
    with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
        eng = LMEngine(dec._replace(decode=flaky_decode), queue_depth=4,
                       telemetry=tel, prefix_cache=True).start()
        try:
            _, d1 = _drain(eng.submit(prompt, 4, time.monotonic() + 120))
            assert d1["status"] == "ok"
            assert eng.prefix_cache_stats()["entries"] > 0
            fail[0] = True
            _, d2 = _drain(eng.submit(prompt, 4, time.monotonic() + 120))
            assert d2["status"] == "error"
            assert eng.prefix_cache_stats()["entries"] == 0
            r3 = eng.submit(prompt, 4, time.monotonic() + 120)
            toks3, d3 = _drain(r3)
        finally:
            eng.stop()
    assert d3["status"] == "ok" and toks3 == _greedy(frozen, prompt, 4)
    admits = {e["id"]: e for e in load_events(
        str(tmp_path / "tel" / "events.jsonl")) if e["kind"] == "lm_admit"}
    assert admits[r3.id]["cached_tokens"] == 0       # nothing stale


def test_spec_decoding_composes_with_the_cache(frozen):
    """A forked-prefix admission through a spec_k = 4 engine equals the
    same requests through a spec_k = 4 engine without the cache."""
    outs = []
    for cache in (True, False):
        eng = LMEngine(_decoder(frozen, spec_k=4), queue_depth=8,
                       prefix_cache=cache).start()
        try:
            runs = [_drain(eng.submit(SHARED, n, time.monotonic() + 120))
                    for n in (10, 6)]
            if cache:
                assert eng.prefix_cache_stats()["hits"] == 1
        finally:
            eng.stop()
        assert all(d["status"] == "ok" for _, d in runs)
        assert eng.allocator.used_count() == 0
        outs.append([t for t, _ in runs])
    assert outs[0] == outs[1]
    assert outs[0][1] == outs[0][0][:6]


# -- the client's retries -----------------------------------------------------


class _Flaky:
    """A stub /generate: ``sheds`` 503s with Retry-After first, then a
    stream, cut before its done event when ``truncate``."""

    def __init__(self, sheds, truncate=False):
        self.sheds, self.truncate, self.calls = sheds, truncate, 0
        stub = self

        class Handler(JsonHandler):
            def do_POST(self):  # noqa: N802 (http.server API)
                self._read_json()
                stub.calls += 1
                if stub.calls <= stub.sheds:
                    self._reply(503, {"error": "shed",
                                      "reason": "queue_full"},
                                headers={"Retry-After": "0.010"})
                    return
                lines = [{"i": 0, "token": 3}, {"i": 1, "token": 4}]
                if not stub.truncate:
                    lines.append({"done": True, "status": "ok", "n": 2})
                data = b"".join(json.dumps(x).encode() + b"\n"
                                for x in lines)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        host, port = self.httpd.server_address[:2]
        self.base = f"http://{host}:{port}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.mark.parametrize("sheds,truncate", [(2, False), (0, True), (9, False)])
def test_generate_with_retries_only_before_the_stream(sheds, truncate):
    stub, slept = _Flaky(sheds, truncate), []
    try:
        code, events = lc.generate_with_retries(
            stub.base, [1, 2], max_attempts=4, sleep=slept.append)
    finally:
        stub.close()
    if sheds >= 4:                      # every attempt shed
        assert code == 503 and stub.calls == 4
        assert events[0]["_retry_after"] == 0.01
        assert slept == [0.01] * 3
        return
    assert code == 200 and stub.calls == sheds + 1
    assert slept == [0.01] * sheds      # the server's Retry-After
    assert [e.get("token") for e in events[:2]] == [3, 4]
    if truncate:                        # never a second generation
        assert events[-1]["truncated"] and "done event" in events[-1]["error"]
    else:
        assert events[-1]["done"]


def test_generate_with_retries_on_a_refused_connect():
    stub = _Flaky(0)
    stub.close()                        # nothing listens there now
    slept = []
    code, events = lc.generate_with_retries(stub.base, [1], max_attempts=3,
                                            sleep=slept.append)
    assert code == -1 and "transport" in events[0]["error"]
    assert len(slept) == 2
