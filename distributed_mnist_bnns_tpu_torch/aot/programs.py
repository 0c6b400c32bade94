"""The known AOT programs and their store loaders (the port's copy of the
JAX package's ``aot/programs.py``).

Five programs cover every hot entry point's first dispatch:

  * ``classifier_predict``: the packed classifier at the server's ONE
    micro-batch shape (K2 and K3; K1 in the conv families);
  * ``lm_prefill`` / ``lm_decode``: the continuous-batching engine's
    two calls (``infer_transformer.make_paged_lm_decoder``: K1, K7, K8);
  * ``lm_verify``: the engine's third call when speculative decoding is
    armed (``spec_k > 0``). The LM pair is all-or-nothing, and so is the
    triple: one absent member is a miss for all of them;
  * ``train_step``: the single-device train step (K1 on ``pallas_xnor``;
    the mesh dispatches stay online with status
    ``unsupported_dispatch``, as JAX's do).

What a program stores is the set of kernel libraries it launches
(``PROGRAM_SOURCES``; none on the CPU, where the plain versions run),
built by ``nvcc`` on a miss and installed with no ``nvcc`` on a hit
(``store.py``). Each loader builds its key itself, and the same
function serves ``cli aot build`` (bank), a server's boot (hit ->
install) and its hot reload, so the key cannot drift between writer
and reader.

Code revision: each program hashes the port's modules that define what
it runs (``_REV_MODULES``) and the ``csrc/`` sources its libraries come
from with every header there. Conservative by design: an edit to any of
them invalidates the program's entries, and ``cli aot gc`` prunes the
casualties.

Every artifact-derived key carries the artifact file's sha256 in
``consts``, as the JAX key does: the same shapes with other weights
must miss, although the libraries themselves hold no weights.

The JAX module's ``aot_donate`` / ``JG_AOT_DONATE`` guard a jaxlib
double free of donated buffers in deserialized executables. Nothing is
deserialized or donated here; the port has no such switch.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

from .store import (
    AotKey,
    AotStore,
    TensorSpec,
    format_avals,
    make_key,
    sha256_hex,
)

log = logging.getLogger(__name__)

_PKG = __package__.rsplit(".", 1)[0]  # distributed_mnist_bnns_tpu_torch

_LM_MODULES = (
    f"{_PKG}.infer", f"{_PKG}.infer_transformer", f"{_PKG}.ops.paged_kv",
    f"{_PKG}.ops.binarize", f"{_PKG}.ops.bitpack", f"{_PKG}.ops.xnor_gemm",
    f"{_PKG}.ops._kernels",
)

# Source modules whose text defines what each program runs. Hashing
# FILES (not live objects) keeps this import-light and makes the
# revision a pure function of the checked-out tree.
_REV_MODULES: Dict[str, Tuple[str, ...]] = {
    "classifier_predict": (
        f"{_PKG}.infer", f"{_PKG}.infer_conv", f"{_PKG}.infer_moe",
        f"{_PKG}.infer_qnn", f"{_PKG}.infer_transformer",
        f"{_PKG}.ops.binarize", f"{_PKG}.ops.bitpack",
        f"{_PKG}.ops.xnor_gemm", f"{_PKG}.ops._kernels",
    ),
    "lm_prefill": _LM_MODULES,
    "lm_decode": _LM_MODULES,
    "lm_verify": _LM_MODULES,
    "train_step": (
        f"{_PKG}.train.trainer", f"{_PKG}.train.optim",
        f"{_PKG}.ops.losses", f"{_PKG}.ops.binarize",
        f"{_PKG}.ops.augment", f"{_PKG}.ops.bitpack",
        f"{_PKG}.ops.xnor_gemm", f"{_PKG}.ops.flash_attention",
        f"{_PKG}.ops._kernels",
        f"{_PKG}.models.registry", f"{_PKG}.models.layers",
        f"{_PKG}.models.mlp", f"{_PKG}.models.cnn",
        f"{_PKG}.models.bnn_cnn", f"{_PKG}.models.convnet",
        f"{_PKG}.models.resnet", f"{_PKG}.models.transformer",
        f"{_PKG}.models.moe",
    ),
}

KNOWN_PROGRAMS = tuple(_REV_MODULES)

_LM_SOURCES = ("paged_attn.cu", "xnor_gemm.cu", "xnor_unpack.cu")

#: the csrc sources whose libraries each program may launch on a card
#: (the code revision hashes them all; ``program_sources`` picks a run's)
PROGRAM_SOURCES: Dict[str, Tuple[str, ...]] = {
    "classifier_predict": ("xnor_gemm.cu", "xnor_unpack.cu"),
    "lm_prefill": _LM_SOURCES,
    "lm_decode": _LM_SOURCES,
    "lm_verify": _LM_SOURCES,
    "train_step": ("flash_attn.cu", "flash_bwd.cu", "xnor_gemm.cu"),
}

_rev_cache: Dict[str, str] = {}


def current_code_rev(name: str) -> str:
    """sha256 over the source bytes of the program's ``_REV_MODULES``, its
    ``PROGRAM_SOURCES`` and every ``csrc/`` header, and the store module
    itself (a store-format change must invalidate too)."""
    if name in _rev_cache:
        return _rev_cache[name]
    if name not in _REV_MODULES:
        raise KeyError(
            f"unknown AOT program {name!r} (have: {KNOWN_PROGRAMS})")
    from ..ops import _kernels

    files = []
    for mod in _REV_MODULES[name] + (f"{_PKG}.aot.store",):
        spec = importlib.util.find_spec(mod)
        if spec is None or not spec.origin:
            raise RuntimeError(f"cannot locate source of module {mod}")
        files.append(spec.origin)
    headers = sorted(f for f in os.listdir(_kernels.CSRC_DIR)
                     if f.endswith(_kernels.HEADER_SUFFIXES))
    for src in (*PROGRAM_SOURCES[name], *headers):
        files.append(os.path.join(_kernels.CSRC_DIR, src))
    h = hashlib.sha256()
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
        h.update(b"\x00")
    _rev_cache[name] = h.hexdigest()
    return _rev_cache[name]


def program_sources(name: str, device: Any, *, family: str = "",
                    backend: Optional[str] = None,
                    attention: Optional[str] = None) -> Tuple[str, ...]:
    """The sources whose libraries program ``name`` launches on
    ``device``: none on the CPU (the plain versions run there); on a card
    the classifier's K1-K3 (and K7 for a transformer family), the LM's
    K1, K7 and K8, and the train step's K1 under ``pallas_xnor`` and
    K4-K6 under flash attention."""
    import torch

    if torch.device(device).type != "cuda":
        return ()
    if name == "classifier_predict":
        return (("xnor_gemm.cu", "xnor_unpack.cu")
                if "transformer" in family else ("xnor_gemm.cu",))
    if name == "train_step":
        out = []
        if attention == "flash":
            out += ["flash_attn.cu", "flash_bwd.cu"]
        if backend == "pallas_xnor":
            out.append("xnor_gemm.cu")
        return tuple(out)
    return PROGRAM_SOURCES[name]


def nvcc_release() -> Optional[str]:
    """The release line of ``nvcc --version`` (recorded in a banked
    manifest), or None where ``nvcc`` cannot be run."""
    from ..ops import _kernels

    try:
        out = subprocess.run([_kernels._nvcc(), "--version"],
                             capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if "release" in ln]
    return lines[0] if lines else None


class _Builder:
    """``load_or_build``'s build and meta for a set of sources: ``nvcc``
    into the kernel build directory, the seconds per source kept."""

    def __init__(self, sources, **meta: Any):
        self.sources = tuple(sources)
        self.nvcc_s: Dict[str, float] = {}
        self._meta = meta

    def __call__(self) -> Dict[str, bytes]:
        from ..ops import _kernels

        if self.sources:   # build([]) would build every source
            self.nvcc_s.update(_kernels.build(list(self.sources)))
        return _kernels.library_bytes(self.sources)

    def meta(self) -> Dict[str, Any]:
        return {**self._meta, "sources": list(self.sources),
                "nvcc_s": dict(self.nvcc_s),
                "nvcc": nvcc_release() if self.sources else None}


def _install(libs: Dict[str, bytes]) -> List[str]:
    from ..ops import _kernels

    return _kernels.install(libs)


def _read_artifact(path: str) -> Tuple[Dict[str, Any], str]:
    """(frozen dict, sha256 of the file bytes): the digest is the key's
    ``consts``."""
    from ..infer import load_frozen

    with open(path, "rb") as f:
        digest = sha256_hex(f.read())
    return load_frozen(path), digest


# ---------------------------------------------------------------------------
# classifier predict
# ---------------------------------------------------------------------------


def classifier_predict_key(
    artifact_digest: str, *, batch_size: int, input_shape, device: Any,
    family: str = "",
) -> AotKey:
    import torch

    spec = TensorSpec((int(batch_size), *[int(d) for d in input_shape]),
                      torch.float32)
    return make_key(
        "classifier_predict", avals=format_avals(spec), device=device,
        consts=artifact_digest, extra={"family": family})


def load_packed_aot(path: str, *, batch_size: int, input_shape,
                    device: Any, store: AotStore):
    """AOT-aware ``infer.load_packed`` at ONE batch shape. Returns
    ``(predict_fn, info, aot_meta)``: on a hit the program's libraries
    were installed from the store (no ``nvcc``); on a miss they were
    built and banked. ``aot_meta``: ``status``, ``digest``, ``nvcc_s``
    (the seconds of each source this call built)."""
    from ..infer import _build_any, resolve_device

    dev = resolve_device(device)
    frozen, digest = _read_artifact(path)
    info = dict(frozen["info"])
    family = str(info.get("family", ""))
    key = classifier_predict_key(
        digest, batch_size=batch_size, input_shape=input_shape,
        device=dev, family=family)
    builder = _Builder(program_sources("classifier_predict", dev,
                                       family=family),
                       artifact=path, family=family)
    _, status = store.load_or_build(key, builder, _install,
                                    meta=builder.meta)
    fn = _build_any(frozen, dev)
    return fn, info, {"status": status, "digest": key.digest,
                      "nvcc_s": dict(builder.nvcc_s)}


# ---------------------------------------------------------------------------
# paged LM decoder (prefill + decode [+ verify])
# ---------------------------------------------------------------------------


def lm_geometry(
    frozen: Dict[str, Any], *, slots: int, page_size: int,
    num_pages: Optional[int], prefill_chunk: int, max_len: Optional[int],
    spec_k: int = 0,
) -> Dict[str, int]:
    """Host-side mirror of ``make_paged_lm_decoder``'s geometry (held to
    the real decoder after every load, so drift cannot ship silently):
    the key is built before the decoder."""
    from ..ops.paged_kv import pages_needed

    if frozen.get("kind") != "lm":
        raise ValueError(
            f"make_paged_lm_decoder needs a kind='lm' artifact, got "
            f"{frozen.get('kind')!r}")
    num_heads = int(frozen["num_heads"])
    embed_dim = int(frozen["tok_embed"].shape[1])
    vocab = int(frozen["tok_embed"].shape[0])
    pos_len = int(frozen["pos_embed"].shape[1])
    max_len = pos_len if max_len is None else int(max_len)
    if not 1 <= max_len <= pos_len:
        raise ValueError(
            f"max_len {max_len} outside [1, trained pos_embed length "
            f"{pos_len}]")
    slots = int(slots)
    if slots < 1:
        raise ValueError(f"need >= 1 batch slot, got {slots}")
    page_size, prefill_chunk = int(page_size), int(prefill_chunk)
    max_pages = pages_needed(max_len, page_size)
    if num_pages is None:
        num_pages = slots * max_pages + 1
    spec_k = int(spec_k)
    if spec_k < 0:
        raise ValueError(f"spec_k must be >= 0, got {spec_k}")
    return {
        "slots": slots, "page_size": page_size,
        "num_pages": int(num_pages), "max_pages": max_pages,
        "max_len": max_len, "prefill_chunk": prefill_chunk,
        "vocab": vocab, "num_blocks": len(frozen["blocks"]),
        "num_heads": num_heads, "head_dim": embed_dim // num_heads,
        "spec_k": spec_k,
    }


def lm_avals(geom: Dict[str, int]):
    """(prefill, decode, verify-or-None) input signatures, the JAX
    ``_lm_avals``' (the pools first)."""
    import torch

    pool = TensorSpec((geom["num_pages"], geom["page_size"],
                       geom["num_heads"], geom["head_dim"]), torch.float32)
    pools = tuple((pool, pool) for _ in range(geom["num_blocks"]))
    i32 = torch.int32
    prefill = (pools, TensorSpec((geom["prefill_chunk"],), i32),
               TensorSpec((geom["max_pages"],), i32), TensorSpec((), i32),
               TensorSpec((), i32))
    decode = (pools, TensorSpec((geom["slots"],), i32),
              TensorSpec((geom["slots"], geom["max_pages"]), i32),
              TensorSpec((geom["slots"],), i32))
    verify = None
    if geom.get("spec_k"):
        verify = (pools, TensorSpec((geom["slots"], geom["spec_k"]), i32),
                  TensorSpec((geom["slots"], geom["max_pages"]), i32),
                  TensorSpec((geom["slots"],), i32))
    return prefill, decode, verify


def lm_decoder_keys(
    artifact_digest: str, geom: Dict[str, int], *, device: Any,
    kernels: bool,
) -> Tuple[AotKey, AotKey, Optional[AotKey]]:
    """(prefill, decode, verify-or-None) keys. ``spec_k`` shapes only the
    verify key, so the pair a plain boot banked serves a spec-armed boot
    too, which still misses as a set until ``lm_verify`` is banked.
    ``kernels`` keys all three: K8 + K7 and the gather path are other
    programs, so flipping it must miss."""
    prefill_avals, decode_avals, verify_avals = lm_avals(geom)
    extra = {k: v for k, v in geom.items() if k != "spec_k"}
    extra["kernels"] = bool(kernels)
    key_v = None
    if verify_avals is not None:
        key_v = make_key(
            "lm_verify", avals=format_avals(verify_avals), device=device,
            consts=artifact_digest, extra={**extra, "spec_k": geom["spec_k"]})
    return (
        make_key("lm_prefill", avals=format_avals(prefill_avals),
                 device=device, consts=artifact_digest, extra=extra),
        make_key("lm_decode", avals=format_avals(decode_avals),
                 device=device, consts=artifact_digest, extra=extra),
        key_v,
    )


def load_paged_lm_decoder_aot(
    path: str, *, slots: int, page_size: int = 16,
    num_pages: Optional[int] = None, prefill_chunk: int = 16,
    max_len: Optional[int] = None, spec_k: int = 0, device: Any,
    store: AotStore,
):
    """AOT-aware ``make_paged_lm_decoder`` from an artifact file. The
    decoder runs the kernels on a card and the gather path on the CPU
    (``kernels`` follows the device). Returns ``(PagedLMDecoder, info,
    aot_meta)``: a hit (EVERY program present, verified and loaded) has
    installed the libraries with no ``nvcc``; a partial set is a miss for
    all of them, which builds and banks every member."""
    from ..infer import resolve_device
    from ..infer_transformer import make_paged_lm_decoder

    dev = resolve_device(device)
    kernels = dev.type == "cuda"
    frozen, digest = _read_artifact(path)
    info = dict(frozen.get("info", {}))
    geom = lm_geometry(
        frozen, slots=slots, page_size=page_size, num_pages=num_pages,
        prefill_chunk=prefill_chunk, max_len=max_len, spec_k=spec_k)
    key_p, key_d, key_v = lm_decoder_keys(digest, geom, device=dev,
                                          kernels=kernels)
    keys = [key_p, key_d] + ([key_v] if key_v is not None else [])
    sources = program_sources("lm_decode", dev)
    builder = _Builder(sources, artifact=path, kernels=kernels, **geom)
    # All-or-nothing: get() (which counts and emits hit/miss) runs only
    # when EVERY member is present, so a partial set cannot record an
    # aot_hit for a program this boot then builds anyway.
    status = "miss"
    if all(store.contains(k) for k in keys):
        libs: Dict[str, bytes] = {}
        for k in keys:
            got = store.get(k)
            if got is None:
                break
            libs.update(got)
        else:
            try:
                _install(libs)
                status = "hit"
            except OSError as e:
                for k in keys:
                    store._quarantine(k, "load_error",
                                      f"{type(e).__name__}: {e}")
    if status == "miss":
        libs = builder()
        meta = builder.meta()
        for k in keys:
            store.put(k, libs, meta=meta)
        _install(libs)
    dec = make_paged_lm_decoder(
        frozen, slots=slots, page_size=page_size, num_pages=num_pages,
        prefill_chunk=prefill_chunk, max_len=max_len, spec_k=spec_k,
        kernels=kernels, device=dev)
    derived = tuple(geom[k] for k in (
        "slots", "page_size", "num_pages", "max_pages", "max_len",
        "prefill_chunk", "vocab", "num_blocks", "spec_k"))
    actual = (dec.slots, dec.page_size, dec.num_pages, dec.max_pages,
              dec.max_len, dec.prefill_chunk, dec.vocab, dec.num_blocks,
              dec.spec_k)
    if derived != actual:
        raise RuntimeError(
            f"aot LM geometry drifted from make_paged_lm_decoder: derived "
            f"{derived} != actual {actual}: fix aot/programs.lm_geometry")
    return dec, info, {"status": status, "digests": [k.digest for k in keys],
                       "nvcc_s": dict(builder.nvcc_s)}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def load_or_build_train_step(store: AotStore, *, model: torch.nn.Module,
                             images: TensorSpec, labels: TensorSpec,
                             device: Any, extra: Dict[str, Any],
                             attention: Optional[str] = None):
    """Install (hit) or build and bank (miss) the libraries of the
    single-device train step. Returns ``(status, nvcc_s)``. The step
    itself is the trainer's own: a hit changes where its libraries come
    from, never what runs."""
    # the model's state (every parameter and buffer, by name), the
    # batch's signature and the run's static config
    state = {name: TensorSpec(tuple(t.shape), t.dtype)
             for name, t in model.state_dict().items()}
    key = make_key("train_step", avals=format_avals((state, images, labels)),
                   device=device, extra=extra)
    builder = _Builder(program_sources(
        "train_step", device, backend=extra.get("backend"),
        attention=attention), model=extra.get("model"))
    t0 = time.perf_counter()
    _, status = store.load_or_build(key, builder, _install,
                                    meta=builder.meta)
    log.info("aot train step %s in %.3f s", status, time.perf_counter() - t0)
    return status, dict(builder.nvcc_s)
