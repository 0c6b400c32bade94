"""The port's AOT store (``distributed_mnist_bnns_tpu_torch/aot/``) on the
CPU, held to the JAX package's ``aot/`` where the two can meet.

The port banks kernel libraries, not XLA executables, and on the CPU a
program launches none: its entry holds no library, and a hit checks the
key and the manifest. The verify-then-``dlopen`` path runs here on a
shared library that ``g++`` builds from a few lines of C, installed
through ``ops._kernels.install`` as the card's libraries are: a flipped
or truncated library is quarantined and never reaches ``ctypes.CDLL``.

Counterparts of the JAX tests that pass (``tests/test_aot.py``):
``TestCacheKey``, ``TestCorruption``, ``TestLsGc``, the LM pair's
all-or-nothing miss, the LM geometry, the ``kernels`` flip, the
trainer's unsupported dispatch and its events. The pure file logic
(``entries``, ``gc``'s reasons, quarantine names, the in-flight grace)
runs through JAX's ``AotStore`` and the port's over one tree. The
classifier server booted from the store answers bitwise as the port's
predictor built without it, which holds JAX's packed predictor on the
same artifact to ``test_torch_infer``'s tolerance (atol 1e-5, equal
argmax: the log-softmax rounds differently), the LM engine from the store streams
JAX's engine's greedy tokens, and the trainer's step from the store is
bitwise its online step.
"""

import ctypes
import json
import os
import shutil
import subprocess
import time

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch.aot import (
    AotStore,
    TensorSpec,
    load_packed_aot,
    load_paged_lm_decoder_aot,
    make_key,
    sha256_hex,
)
from distributed_mnist_bnns_tpu_torch.aot.programs import (
    lm_decoder_keys,
    lm_geometry,
)
from distributed_mnist_bnns_tpu_torch.obs import Telemetry
from distributed_mnist_bnns_tpu_torch.obs.events import load_events
from distributed_mnist_bnns_tpu_torch.ops import _kernels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs, restored after: the
    suite runs in parallel workers, whose default pools oversubscribe
    the CPU (a first training step here took seconds with eight)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy_key(**over):
    base = dict(name="classifier_predict",
                avals=TensorSpec((4,), torch.float32), consts="w0",
                extra={"family": "bnn-mlp"}, device="cpu")
    base.update(over)
    return make_key(base.pop("name"), **base)


@pytest.fixture()
def store(tmp_path):
    return AotStore(str(tmp_path / "store"))


# -- a real shared library: g++ from a few lines of C -------------------------

_TOY_C = 'extern "C" int toy_add(int a, int b) { return a + b; }\n'


@pytest.fixture(scope="module")
def toy_lib(tmp_path_factory):
    """(source dir holding toy.c, the library's bytes)."""
    d = tmp_path_factory.mktemp("toy")
    (d / "toy.c").write_text(_TOY_C)
    out = d / "libtoy.so"
    subprocess.run(["g++", "-x", "c++", "-shared", "-fPIC", "-o", str(out),
                    str(d / "toy.c")], check=True, timeout=120)
    return str(d), out.read_bytes()


@pytest.fixture()
def toy_kernels(toy_lib, tmp_path, monkeypatch):
    """``ops._kernels`` pointed at the toy source, an empty build
    directory, no loaded library; every ``ctypes.CDLL`` path recorded
    with the sha256 of its bytes."""
    from distributed_mnist_bnns_tpu_torch.aot.programs import (
        current_code_rev,
    )

    current_code_rev("classifier_predict")   # of the real csrc/, first
    src_dir, lib = toy_lib
    monkeypatch.setattr(_kernels, "CSRC_DIR", src_dir)
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_kernels, "_libs", {})
    monkeypatch.setitem(_kernels.SIGNATURES, "toy.c",
                        {"toy_add": [ctypes.c_int, ctypes.c_int]})
    opened = []
    real = ctypes.CDLL

    def cdll(path, *a, **kw):
        with open(path, "rb") as f:
            opened.append(sha256_hex(f.read()))
        return real(path, *a, **kw)

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    return lib, opened


def _bank_toy(root, lib, telemetry=None):
    store = AotStore(root, telemetry=telemetry)
    key = _toy_key()
    assert store.put(key, {"toy.c": lib})
    bin_p = os.path.join(store.root, key.name, f"{key.digest}.bin")
    man_p = os.path.join(store.root, key.name, f"{key.digest}.json")
    return store, key, bin_p, man_p


class TestCacheKey:
    def test_miss_on_each_key_component(self, store):
        key = _toy_key()
        store.put(key, {})
        assert store.get(key) == {}
        variants = {
            "shape": _toy_key(avals=TensorSpec((8,), torch.float32)),
            "dtype": _toy_key(avals=TensorSpec((4,), torch.bfloat16)),
            "consts": _toy_key(consts="w1"),
            "extra": _toy_key(extra={"family": "bnn-cnn"}),
            "mesh": _toy_key(mesh="data=8"),
            "code_rev": _toy_key(code_rev="0" * 64),
        }
        digests = {key.digest}
        for component, k in variants.items():
            assert store.get(k) is None, f"{component} must miss"
            assert k.digest not in digests, f"{component} digest collided"
            digests.add(k.digest)
        # the runtime and the device are fields too
        for field in ("runtime_version", "backend"):
            other = type(key)(**{**key.asdict(), field: "other"})
            assert other.digest not in digests and store.get(other) is None

    def test_build_is_idempotent(self, store, toy_kernels):
        lib, opened = toy_kernels
        key = _toy_key()
        built = []

        def build():
            built.append(1)
            return {"toy.c": lib}

        _, s1 = store.load_or_build(key, build, _kernels.install)
        _kernels._libs.clear()
        _, s2 = store.load_or_build(key, build, _kernels.install)
        _kernels._libs.clear()
        _, s3 = AotStore(store.root).load_or_build(key, build,
                                                   _kernels.install)
        assert (s1, s2, s3) == ("miss", "hit", "hit") and built == [1]
        assert _kernels._libs["toy.c"].toy_add(2, 3) == 5
        assert set(opened) == {sha256_hex(lib)}


class TestCorruption:
    @pytest.mark.parametrize("damage", ["truncate", "flip"])
    def test_bad_library_is_quarantined_before_dlopen(
            self, tmp_path, toy_kernels, damage):
        lib, opened = toy_kernels
        with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
            store, key, bin_p, _ = _bank_toy(str(tmp_path / "s"), lib, tel)
            with open(bin_p, "r+b") as f:
                if damage == "truncate":
                    f.truncate(64)
                else:
                    blob = bytearray(f.read())
                    blob[len(blob) // 2] ^= 0x01
                    f.seek(0)
                    f.write(blob)
            with open(bin_p, "rb") as f:
                bad = sha256_hex(f.read())
            _, status = store.load_or_build(
                key, lambda: {"toy.c": lib}, _kernels.install)
            assert store.get(key) == {"toy.c": lib}   # re-banked
        assert status == "miss"
        assert os.path.exists(bin_p + ".quarantined")
        assert opened == [sha256_hex(lib)] and bad not in opened
        assert _kernels._libs["toy.c"].toy_add(40, 2) == 42
        events = load_events(str(tmp_path / "tel" / "events.jsonl"))
        falls = [e for e in events if e["kind"] == "aot_fallback"]
        assert [f["reason"] for f in falls] == ["payload_digest_mismatch"]
        kinds = [e["kind"] for e in events]
        assert kinds.count("aot_bank") == 2 and "aot_hit" in kinds

    def test_library_row_mismatch_with_matching_payload_digest(
            self, tmp_path, toy_lib):
        """A payload whose digest the manifest was rewritten to match, but
        whose library does not hash to its row: still never returned."""
        store, key, bin_p, man_p = _bank_toy(str(tmp_path / "s"),
                                             toy_lib[1])
        garbage = b"\x7fELF but not a library" * 4
        with open(bin_p, "wb") as f:
            f.write(garbage)
        with open(man_p, "r+", encoding="utf-8") as f:
            man = json.load(f)
            man["payload_sha256"] = sha256_hex(garbage)
            f.seek(0)
            f.truncate()
            json.dump(man, f)
        assert store.get(key) is None
        assert os.path.exists(bin_p + ".quarantined")

    def test_missing_manifest_half_quarantined_after_grace(self, tmp_path):
        store, key, bin_p, man_p = _bank_toy(str(tmp_path / "s"), b"x" * 9)
        os.remove(man_p)
        assert store.get(key) is None                # a bank in flight
        assert os.path.exists(bin_p)
        assert not os.path.exists(bin_p + ".quarantined")
        old = time.time() - 3600
        os.utime(bin_p, (old, old))                  # a crashed bank
        assert store.get(key) is None
        assert os.path.exists(bin_p + ".quarantined")

    def test_corrupt_manifest_json(self, tmp_path):
        store, key, bin_p, man_p = _bank_toy(str(tmp_path / "s"), b"x")
        with open(man_p, "w") as f:
            f.write("{not json")
        assert store.get(key) is None
        assert os.path.exists(man_p + ".quarantined")


class TestLsGc:
    def test_entries_and_gc_prune_stale_code_rev(self, store):
        fresh = _toy_key()
        store.put(fresh, {"a.cu": b"lib"})
        stale = _toy_key(consts="stale-one", code_rev="f" * 64)
        store.put(stale, {"a.cu": b"old"})
        rows = store.entries()
        assert {r["digest"] for r in rows if r.get("digest")} == {
            fresh.digest, stale.digest}
        assert all("bytes" in r for r in rows if r.get("digest"))
        dry = store.gc(dry_run=True)
        assert [x["reason"] for x in dry["removed"]] == [
            "stale_code_rev", "stale_code_rev"]
        assert store.get(stale) is not None          # dry run removed none
        res = store.gc()
        assert res["removed"] == dry["removed"] and res["kept"] == 2
        assert store.get(fresh) is not None

    def test_gc_collects_orphans_and_quarantined(self, store):
        key = _toy_key()
        store.put(key, {})
        d = os.path.join(store.root, key.name)
        with open(os.path.join(d, "deadbeef.bin"), "wb") as f:
            f.write(b"orphan payload")
        with open(os.path.join(d, "cafe.json.quarantined"), "w") as f:
            f.write("{}")
        res = store.gc()
        reasons = sorted(x["reason"] for x in res["removed"])
        assert reasons == ["orphan_payload", "quarantined"]
        assert store.get(key) is not None


def _jax_store(root):
    from distributed_mnist_bnns_tpu.aot import AotStore as JaxStore

    return JaxStore(root)


class TestFileLogicAgainstJax:
    """``entries``, ``gc`` and the quarantine of halves, by JAX's store
    and the port's over the same directory trees."""

    def _tree(self, root):
        store = AotStore(root)
        stale = [_toy_key(consts=f"c{i}", code_rev="f" * 64)
                 for i in range(2)]
        for k in stale:
            store.put(k, {"x.cu": b"lib" * 5})
        d = os.path.join(root, "classifier_predict")
        for name, data in (("aa.bin", b"orphan"), ("bb.json", "{}"),
                           ("cc.json", "{not json"), ("cc.bin", b"x"),
                           ("dd.bin.quarantined", b"q"),
                           ("ee.json.tmp", "{}")):
            mode = "wb" if isinstance(data, bytes) else "w"
            with open(os.path.join(d, name), mode) as f:
                f.write(data)
        other = os.path.join(root, "not_a_program")
        os.makedirs(other)
        for ext in ("bin", "json"):
            with open(os.path.join(other, f"ff.{ext}"), "w") as f:
                f.write("{}")

    def test_entries_equal(self, tmp_path):
        root = str(tmp_path / "s")
        self._tree(root)

        def rows(store):
            return [{k: v for k, v in r.items() if k != "age_s"}
                    for r in store.entries()]

        assert rows(AotStore(root)) == rows(_jax_store(root))

    @pytest.mark.parametrize("dry_run", [True, False])
    def test_gc_equal(self, tmp_path, dry_run):
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        self._tree(a)
        shutil.copytree(a, b)
        got = AotStore(a).gc(dry_run=dry_run)
        want = _jax_store(b).gc(dry_run=dry_run)
        assert got == want
        assert sorted(os.listdir(os.path.join(a, "classifier_predict"))) \
            == sorted(os.listdir(os.path.join(b, "classifier_predict")))

    @pytest.mark.parametrize("half", ["bin", "json"])
    def test_half_entry_grace_and_quarantine_names(self, tmp_path, half):
        from distributed_mnist_bnns_tpu.aot import make_key as jax_make_key

        import jax

        outcomes = []
        for side in ("port", "jax"):
            root = str(tmp_path / side)
            if side == "port":
                store, key = AotStore(root), _toy_key()
            else:
                store = _jax_store(root)
                key = jax_make_key(
                    "classifier_predict",
                    avals=jax.ShapeDtypeStruct((4,), jax.numpy.float32),
                    consts="w0")
            d = os.path.join(root, key.name)
            os.makedirs(d)
            path = os.path.join(d, f"{key.digest}.{half}")
            with open(path, "w") as f:
                f.write("{}")
            fresh = (store.get(key), sorted(os.listdir(d)))
            old = time.time() - 3600
            os.utime(path, (old, old))
            aged = (store.get(key), sorted(os.listdir(d)))
            outcomes.append([(got, [n.replace(key.digest, "D") for n in ls])
                             for got, ls in (fresh, aged)])
        assert outcomes[0] == outcomes[1]
        assert outcomes[0][1][1] == [f"D.{half}.quarantined"]


# -- the classifier server from the store ------------------------------------


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """A packed ``bnn-mlp-small`` artifact with random weights, which the
    JAX package's ``load_packed`` reads as its own."""
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model

    path = str(tmp_path_factory.mktemp("art") / "cls.msgpack")
    model = get_model("bnn-mlp-small", backend="xla",
                      generator=torch.Generator().manual_seed(0))
    export_packed(model.eval(), path)
    return path


def test_classifier_server_from_store_fenced_and_bitwise_jax(
        jax_artifact, tmp_path):
    from distributed_mnist_bnns_tpu.infer import load_packed as jax_load
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )

    from distributed_mnist_bnns_tpu_torch.infer import load_packed

    images = np.random.RandomState(0).randn(8, 28, 28, 1).astype(np.float32)
    jfn, _ = jax_load(jax_artifact, interpret=True)
    jax_want = np.asarray(jfn(images))
    fn, _ = load_packed(jax_artifact, device="cpu")
    want = fn(images).numpy()      # the port's predictor without the store
    # the port's predictor against JAX's: test_torch_infer's tolerance
    np.testing.assert_allclose(want, jax_want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(want.argmax(-1), jax_want.argmax(-1))
    store_dir = str(tmp_path / "store")
    statuses = []
    for _ in range(2):
        srv = PackedInferenceServer(ServeConfig(
            artifact=jax_artifact, device="cpu", port=0, batch_size=8,
            aot=True, aot_dir=store_dir,
            telemetry_dir=str(tmp_path / f"tel{len(statuses)}")))
        srv.start()
        try:
            req = srv.engine.submit(images, time.monotonic() + 60)
            assert req.event.wait(60) and req.status == "ok"
            got = np.asarray(req.log_probs)
            health = srv.health()
            info = srv.reload_artifact()   # a reload from the store
            health_after = srv.health()
        finally:
            srv.request_stop()
            srv.drain_and_stop()
        np.testing.assert_array_equal(got, want)
        assert info["family"] == health["family"]
        statuses.append((health["aot"], health["fence_budget"],
                         health["recompiles_post_boot"],
                         health_after["aot"], health_after["fence_error"]))
    assert statuses == [("miss", None, 0, "hit", None),
                        ("hit", 0, 0, "hit", None)]
    events = load_events(str(tmp_path / "tel1" / "events.jsonl"))
    kinds = [e["kind"] for e in events]
    # the boot's store events follow the manifest that opens the log
    assert kinds[0] == "run_manifest" and "aot_hit" in kinds
    assert events[0]["config"]["aot"] == "hit"


def test_classifier_fence_trips_on_a_build_after_a_hit(jax_artifact,
                                                       tmp_path):
    from distributed_mnist_bnns_tpu_torch.obs import get_tracker
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )

    cfg = ServeConfig(artifact=jax_artifact, device="cpu", port=0,
                      batch_size=8, aot=True, aot_dir=str(tmp_path / "s"))
    load_packed_aot(jax_artifact, batch_size=8, input_shape=(28, 28, 1),
                    device="cpu", store=AotStore(cfg.aot_dir))
    srv = PackedInferenceServer(cfg)
    srv.start()
    try:
        assert srv.aot_status == "hit"
        get_tracker().record("kernel_build", 0.0)   # a build after boot
        req = srv.engine.submit(np.zeros((1, 28, 28, 1), np.float32),
                                time.monotonic() + 30)
        req.event.wait(30)
        deadline = time.monotonic() + 10
        while srv.engine.fence_error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.engine.fence_error is not None
        assert srv.health()["status"] == "failed"
    finally:
        srv.request_stop()
        srv.drain_and_stop()


# -- the LM decoder from the store --------------------------------------------


@pytest.fixture(scope="module")
def lm_frozen_pair():
    """(the JAX layout's frozen dict, the port's) of a tiny LM with random
    weights and biases (``tests/torch_lm_util.TINY``'s widths)."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        _freeze_lm_tensors,
    )
    from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from tests.torch_lm_util import TINY

    gen = torch.Generator().manual_seed(0)
    model = BinarizedLM(**TINY, generator=gen).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):   # zero biases tie exactly
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    frozen = _freeze_lm_tensors(model)
    return frozen_to_jax(frozen), frozen


@pytest.fixture(scope="module")
def lm_artifact(lm_frozen_pair, tmp_path_factory):
    from distributed_mnist_bnns_tpu_torch.utils import msgpack

    path = str(tmp_path_factory.mktemp("lm") / "lm.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.msgpack_serialize(lm_frozen_pair[0]))
    return path


def _stream(engine, prompt, n):
    req = engine.submit(np.asarray(prompt, np.int32), n,
                        time.monotonic() + 120)
    toks = []
    while True:
        ev = req.events.get(timeout=120)
        if ev["kind"] == "done":
            assert ev["status"] == "ok", ev
            return toks
        toks.append(int(ev["token"]))


def test_lm_engine_from_store_streams_jax_engines_tokens(
        lm_artifact, lm_frozen_pair, tmp_path):
    from distributed_mnist_bnns_tpu.infer_transformer import (
        make_paged_lm_decoder as jax_decoder,
    )
    from distributed_mnist_bnns_tpu.serve.lm import LMEngine as JaxEngine
    from distributed_mnist_bnns_tpu_torch.analysis.guards import (
        fenced_build_count,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine
    from tests.torch_lm_util import tokens

    prompts = [(tokens(1, 5), 6), (tokens(2, 11), 5)]
    jeng = JaxEngine(jax_decoder(lm_frozen_pair[0], slots=2, page_size=8,
                                 interpret=True)).start()
    try:
        want = [_stream(jeng, p, n) for p, n in prompts]
    finally:
        jeng.stop()
    store_dir = str(tmp_path / "store")
    for status in ("miss", "hit"):
        mark = fenced_build_count()
        dec, _, meta = load_paged_lm_decoder_aot(
            lm_artifact, slots=2, page_size=8, device="cpu",
            store=AotStore(store_dir))
        assert meta["status"] == status
        eng = LMEngine(dec, boot_fence_baseline=(
            mark if status == "hit" else None)).start()
        try:
            assert [_stream(eng, p, n) for p, n in prompts] == want
            assert eng.fence_error is None
        finally:
            eng.stop()


def test_partial_lm_pair_is_a_pair_miss_no_false_hit(lm_artifact, tmp_path):
    store_dir = str(tmp_path / "store")
    _, _, meta = load_paged_lm_decoder_aot(
        lm_artifact, slots=2, page_size=8, device="cpu",
        store=AotStore(store_dir))
    assert meta["status"] == "miss"
    shutil.rmtree(os.path.join(store_dir, "lm_decode"))
    with Telemetry(str(tmp_path / "tel"), heartbeat=False) as tel:
        _, _, meta2 = load_paged_lm_decoder_aot(
            lm_artifact, slots=2, page_size=8, device="cpu",
            store=AotStore(store_dir, telemetry=tel))
    assert meta2["status"] == "miss"
    kinds = [e["kind"] for e in load_events(
        str(tmp_path / "tel" / "events.jsonl"))
        if e["kind"].startswith("aot_")]
    assert "aot_hit" not in kinds and kinds.count("aot_bank") == 2
    _, _, meta3 = load_paged_lm_decoder_aot(
        lm_artifact, slots=2, page_size=8, device="cpu",
        store=AotStore(store_dir))
    assert meta3["status"] == "hit"
    # with spec decode the pair alone is a miss for the triple
    _, _, meta4 = load_paged_lm_decoder_aot(
        lm_artifact, slots=2, page_size=8, spec_k=3, device="cpu",
        store=AotStore(store_dir))
    assert meta4["status"] == "miss" and len(meta4["digests"]) == 3
    assert os.listdir(os.path.join(store_dir, "lm_verify"))


def test_lm_loader_geometry_matches_decoder(lm_artifact, lm_frozen_pair,
                                            tmp_path):
    from distributed_mnist_bnns_tpu.aot.programs import (
        _lm_geometry as jax_geometry,
    )
    from distributed_mnist_bnns_tpu_torch.infer import load_frozen
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )

    kw = dict(slots=3, page_size=4, num_pages=None, prefill_chunk=8,
              max_len=None, spec_k=2)
    dec, _, meta = load_paged_lm_decoder_aot(
        lm_artifact, device="cpu", store=AotStore(str(tmp_path / "s")),
        **{k: v for k, v in kw.items() if v is not None})
    ref = make_paged_lm_decoder(load_frozen(lm_artifact), slots=3,
                                page_size=4, prefill_chunk=8, spec_k=2,
                                kernels=False, device="cpu")
    fields = ("slots", "page_size", "num_pages", "max_pages", "max_len",
              "prefill_chunk", "vocab", "num_blocks", "spec_k")
    assert [getattr(dec, f) for f in fields] == [getattr(ref, f)
                                                 for f in fields]
    got = lm_geometry(load_frozen(lm_artifact), **kw)
    assert got == jax_geometry(lm_frozen_pair[0], **kw)


def test_kernels_flip_is_a_miss(lm_artifact, tmp_path):
    """The kernel path (K8, K7) and the gather path are other programs:
    ``kernels`` is in all three keys, so banking one path must not serve
    the other."""
    from distributed_mnist_bnns_tpu_torch.infer import load_frozen

    store = AotStore(str(tmp_path / "s"))
    _, _, meta = load_paged_lm_decoder_aot(
        lm_artifact, slots=2, page_size=8, spec_k=2, device="cpu",
        store=store)
    assert meta["status"] == "miss"
    with open(lm_artifact, "rb") as f:
        digest = sha256_hex(f.read())
    geom = lm_geometry(load_frozen(lm_artifact), slots=2, page_size=8,
                       num_pages=None, prefill_chunk=16, max_len=None,
                       spec_k=2)
    gather = lm_decoder_keys(digest, geom, device="cpu", kernels=False)
    armed = lm_decoder_keys(digest, geom, device="cpu", kernels=True)
    assert [k.digest for k in gather] == meta["digests"]
    for g, k in zip(gather, armed):
        assert g.digest != k.digest
        assert store.get(g) is not None and store.get(k) is None


# -- the trainer ----------------------------------------------------------------


def _train_cfg(tmp_path, **over):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig

    base = dict(model="bnn-mlp-small", backend="xla", batch_size=8,
                epochs=1, seed=0, log_interval=10 ** 9, device="cpu",
                aot=True, aot_dir=str(tmp_path / "store"),
                handle_preemption=False)
    base.update(over)
    return TrainConfig(**base)


def _two_steps(t):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.rand(8, 28, 28, 1).astype(np.float32))
        y = torch.from_numpy((np.arange(8) % 10).astype(np.int64))
        loss, _ = t.train_step(t.model, t.optimizer, x, y)
        out.append(float(loss))
    return out, {k: v.clone() for k, v in t.model.state_dict().items()}


def test_trainer_step_from_store_bitwise_online(tmp_path):
    """An online trainer banks its step's program (a miss) and steps; a
    trainer booted with ``aot`` hits and steps bitwise the same."""
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    online = Trainer(_train_cfg(tmp_path, aot=False))
    assert online.aot_status == "disabled"
    assert online.load_aot_train_step(
        (28, 28, 1), store_dir=str(tmp_path / "store")) == "miss"
    hit = Trainer(_train_cfg(tmp_path))
    assert hit.aot_status == "hit"
    (want, want_state), (got, got_state) = _two_steps(online), _two_steps(hit)
    assert got == want
    for k, v in want_state.items():
        assert torch.equal(got_state[k], v), k


def test_unsupported_dispatch_stays_online(tmp_path):
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    t = Trainer(_train_cfg(tmp_path, scan_steps=4))
    assert t.aot_status == "unsupported_dispatch"
    assert not os.path.exists(str(tmp_path / "store"))


def test_events_miss_bank_then_hit(tmp_path):
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    def kinds(run):
        ev = load_events(str(tmp_path / f"tel{run}" / "events.jsonl"))
        return [e["kind"] for e in ev if e["kind"].startswith("aot_")]

    Trainer(_train_cfg(tmp_path, telemetry_dir=str(tmp_path / "tel1")))
    Trainer(_train_cfg(tmp_path, telemetry_dir=str(tmp_path / "tel2")))
    assert kinds(1) == ["aot_miss", "aot_bank"]
    assert kinds(2) == ["aot_hit"]


# -- the CLI ----------------------------------------------------------------------


def test_cli_aot_build_ls_gc(jax_artifact, lm_artifact, tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch import cli

    store = str(tmp_path / "store")
    argv = ["aot", "build", "--store", store, "--device", "cpu",
            "--artifact", jax_artifact, "--batch-size", "8",
            "--lm-artifact", lm_artifact, "--slots", "2",
            "--page-size", "8", "--spec-decode", "2", "--train",
            "--model", "bnn-mlp-small", "--backend", "pallas_xnor",
            "--train-batch-size", "8"]
    assert cli.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [b.get("status") for b in first["built"]] == ["miss"] * 3
    assert cli.main(argv) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [b.get("status") for b in again["built"]] == ["hit"] * 3
    assert cli.main(["aot", "ls", "--store", store, "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert sorted(r["name"] for r in rows) == [
        "classifier_predict", "lm_decode", "lm_prefill", "lm_verify",
        "train_step"]
    with open(os.path.join(store, "train_step", "aa.bin"), "w") as f:
        f.write("orphan")
    assert cli.main(["aot", "gc", "--store", store, "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert [r["reason"] for r in res["removed"]] == ["orphan_payload"]
    assert res["kept"] == 10
    assert cli.main(["aot", "build", "--store", store]) == 2


def test_aot_flags_parse_and_fleet_passes_them_on():
    from distributed_mnist_bnns_tpu_torch.cli import build_parser

    from distributed_mnist_bnns_tpu_torch.cli import _replica_flags

    p = build_parser()
    for argv in (["train", "--aot", "--aot-dir", "d"],
                 ["serve", "--artifact", "a", "--aot", "--aot-dir", "d"],
                 ["serve", "--lm", "--artifact", "a", "--aot"],
                 ["fleet", "--artifact", "a", "--aot", "--aot-dir", "d"]):
        args = p.parse_args(argv)
        assert args.aot is True
        assert args.aot_dir == ("d" if "--aot-dir" in argv else None)
    assert p.parse_args(["train"]).aot is False
    replica = p.parse_args(["serve", "--artifact", "a", *_replica_flags(
        args)])
    assert (replica.aot, replica.aot_dir) == (True, "d")
    with open(os.path.join(os.path.dirname(__file__), "..",
                           ".gitignore")) as f:
        assert ".torch_aot/" in f.read().split()
