"""Content-addressed store of the port's compiled artifacts: the kernel
libraries that ``ops/_kernels.py`` builds with ``nvcc``.

The port's counterpart of the JAX package's ``aot/store.py``. There the
store banks serialized XLA executables; here nothing is traced or
lowered, and the only thing a boot compiles is the set of ``csrc/``
libraries its program launches (``nvcc`` at first use, seconds a
source). A CUDA-graph capture cannot be serialized, so a stored
*program* is that set of shared libraries plus its manifest, keyed by
everything that decides whether the bytes are the right ones:

    (program name, code revision of the port's modules and of the
     csrc sources and headers its libraries come from, the runtime
     (torch and CUDA runtime versions), the device (name and compute
     capability, or "cpu"), input shapes, artifact digest, static
     config)

A boot that *hits* installs the banked libraries (written into the
kernel build directory and loaded with ``ctypes``) and runs no
``nvcc``: it works on a host where ``nvcc`` cannot be found (``aot_hit``
event). A miss builds the libraries as a cold boot would and banks them
(``aot_miss`` / ``aot_bank``). The ``nvcc`` release that built them is
recorded in the manifest (``meta.nvcc``), not in the key: a boot from
the store must find its entry where no ``nvcc`` can be asked.

Verify before acting, as the JAX store does: the payload's sha256 is
checked against the manifest, and each library's against its own row,
BEFORE anything is written out or ``dlopen``ed. A bad shared object can
kill the process rather than raise, so a truncated or flipped library
never reaches ``ctypes.CDLL``: the entry is quarantined (renamed
``*.quarantined``) with a loud ``aot_fallback`` event and its reason,
and the caller rebuilds and re-banks.

Layout (the JAX store's)::

    <root>/<name>/<digest>.bin    the libraries, concatenated
    <root>/<name>/<digest>.json   manifest: key fields, payload sha256,
                                  each library's (source, file name,
                                  offset, bytes, sha256), meta

Both files are written as a tmp file then renamed, the manifest LAST,
so a crash mid-bank leaves an orphan ``.bin`` that ``gc`` collects,
never a manifest pointing at missing or short bytes. On the CPU a
program launches no kernel, and its entry holds no library: a hit there
checks the key and the manifest only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

HITS_TOTAL = "aot_hits_total"
MISSES_TOTAL = "aot_misses_total"
BANKS_TOTAL = "aot_banks_total"
FALLBACKS_TOTAL = "aot_fallbacks_total"

_SCHEMA_V = 1

#: the store root without an argument: this env var, else ``.torch_aot``
#: at the repository root (listed in ``.gitignore``)
STORE_ENV = "JG_TORCH_AOT_STORE"


def default_store_dir(path: Optional[str] = None) -> str:
    """``path``, else ``$JG_TORCH_AOT_STORE``, else ``<repo>/.torch_aot``."""
    return (path or os.environ.get(STORE_ENV) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".torch_aot"))


def _dtype_name(dtype: Any) -> str:
    # torch.float32 -> "float32", numpy's dtype("float32") -> "float32":
    # the names the JAX store's canonical dtypes print
    return str(getattr(dtype, "name", dtype)).replace("torch.", "")


def _leaves(tree: Any) -> List[Any]:
    """Array-like leaves (``.shape`` and ``.dtype``) in JAX's flattening
    order: dict keys sorted, sequences in order."""
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return []


def format_avals(tree: Any) -> str:
    """Canonical string of a tree of tensors, arrays or ``TensorSpec``s:
    ``float32[8,784];int32[8]`` in flattening order, as the JAX store
    prints it. Part of the key: any shape or dtype change must miss."""
    return ";".join(
        _dtype_name(leaf.dtype)
        + f"[{','.join(str(int(d)) for d in leaf.shape)}]"
        for leaf in _leaves(tree))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A shape and a dtype, the port's ``jax.ShapeDtypeStruct``."""

    shape: Tuple[int, ...]
    dtype: Any


def canonical_extra(extra: Dict[str, Any]) -> str:
    """Deterministic JSON for the static-config key component."""
    return json.dumps(extra, sort_keys=True, separators=(",", ":"),
                      default=str)


def sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def runtime_version() -> str:
    """The runtime that loads the libraries: torch and its CUDA runtime
    (the key field where the JAX store has ``jax_version``)."""
    import torch

    return f"torch {torch.__version__}; cuda {torch.version.cuda}"


def device_backend(device: Any = None) -> str:
    """``"cpu"``, or a card's name and compute capability, e.g.
    ``"NVIDIA H100 80GB HBM3 sm_90"`` (the key field where the JAX store
    has ``backend``). ``None``: the first card if there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    major, minor = torch.cuda.get_device_capability(index)
    return f"{torch.cuda.get_device_name(index)} sm_{major}{minor}"


@dataclasses.dataclass(frozen=True)
class AotKey:
    """Everything that decides the stored libraries. Two keys with equal
    digests MUST be interchangeable entries; anything that changes what
    the program runs (code, shapes, constants, static config) or whether
    the bytes load (runtime, device) is a field."""

    name: str             # logical program: classifier_predict, lm_decode…
    code_rev: str         # programs.current_code_rev(name)
    runtime_version: str  # runtime_version()
    backend: str          # device_backend(device)
    avals: str            # format_avals of the input signature
    mesh: str = ""        # "" = no mesh (every stored program is one rank)
    consts: str = ""      # digest of the artifact the program serves
    extra: str = ""       # canonical_extra of static config

    @property
    def digest(self) -> str:
        blob = json.dumps(dataclasses.asdict(self), sort_keys=True,
                          separators=(",", ":")).encode()
        return sha256_hex(blob)

    def asdict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


def make_key(
    name: str,
    *,
    avals: Any,
    device: Any = None,
    consts: str = "",
    mesh: str = "",
    extra: Optional[Dict[str, Any]] = None,
    code_rev: Optional[str] = None,
) -> AotKey:
    """An :class:`AotKey` with the environment fields (runtime, device)
    and the program's code revision filled in."""
    if code_rev is None:
        from .programs import current_code_rev

        code_rev = current_code_rev(name)
    return AotKey(
        name=name,
        code_rev=code_rev,
        runtime_version=runtime_version(),
        backend=device_backend(device),
        avals=avals if isinstance(avals, str) else format_avals(avals),
        mesh=mesh,
        consts=consts,
        extra=canonical_extra(extra or {}),
    )


Libraries = Dict[str, bytes]   # source name -> shared library bytes


class DeferredEvents:
    """An event sink that holds the store's events until ``flush``: a
    server loads its artifact (through the store) before its manifest
    opens the event log, and the log's summary scopes a run from its
    manifest on."""

    def __init__(self):
        self.events: List[Tuple[str, Dict[str, Any]]] = []

    def emit(self, kind: str, **fields: Any) -> None:
        self.events.append((kind, fields))

    def flush(self, telemetry: Any) -> None:
        for kind, fields in self.events:
            telemetry.emit(kind, **fields)
        self.events.clear()


class AotStore:
    """On-disk library store (module docstring).

    ``telemetry`` (an obs ``Telemetry``/``EventLog``) receives the
    ``aot_hit`` / ``aot_miss`` / ``aot_bank`` / ``aot_fallback`` events;
    the counters land in the metrics registry regardless."""

    def __init__(self, root: Optional[str] = None, *,
                 telemetry: Any = None, registry: Any = None):
        self.root = default_store_dir(root)
        self.telemetry = telemetry
        if registry is None:
            if telemetry is not None and hasattr(telemetry, "registry"):
                registry = telemetry.registry
            else:
                from ..obs import default_registry

                registry = default_registry()
        self._hits = registry.counter(
            HITS_TOTAL, "AOT store hits (boot installed stored kernel "
            "libraries; no nvcc)")
        self._misses = registry.counter(
            MISSES_TOTAL, "AOT store misses (the libraries were built)")
        self._banks = registry.counter(
            BANKS_TOTAL, "programs banked into the AOT store")
        self._fallbacks = registry.counter(
            FALLBACKS_TOTAL,
            "corrupt/incompatible entries quarantined (reason label)")

    # -- paths ---------------------------------------------------------------

    def _entry_paths(self, key: AotKey) -> Tuple[str, str]:
        d = os.path.join(self.root, key.name)
        return (os.path.join(d, f"{key.digest}.bin"),
                os.path.join(d, f"{key.digest}.json"))

    def _emit(self, kind: str, **fields: Any) -> None:
        if self.telemetry is None:
            return
        try:
            self.telemetry.emit(kind, **fields)
        except Exception:
            # the store must never take a boot down over telemetry
            log.exception("aot %s event emission failed", kind)

    def _quarantine(self, key: AotKey, reason: str, detail: str) -> None:
        """Move the entry's files aside (``*.quarantined``): the next boot
        re-banks a fresh entry instead of tripping on the same bad bytes,
        and the bad bytes stay inspectable."""
        for path in self._entry_paths(key):
            try:
                if os.path.exists(path):
                    os.replace(path, path + ".quarantined")
            except OSError:
                log.exception("aot quarantine of %s failed", path)
        self._fallbacks.inc(reason=reason)
        self._emit("aot_fallback", name=key.name, digest=key.digest,
                   reason=reason, detail=detail[:500])
        log.warning("aot entry %s/%s quarantined: %s (%s)", key.name,
                    key.digest[:12], reason, detail[:200])

    # Grace window for a half-written entry: put() renames the payload
    # and then the manifest; a reader seeing only one file younger than
    # this treats it as a bank in flight (plain miss), not corruption.
    _IN_FLIGHT_GRACE_S = 60.0

    def _in_flight(self, path: str) -> bool:
        try:
            return (time.time() - os.stat(path).st_mtime
                    < self._IN_FLIGHT_GRACE_S)
        except OSError:
            return True    # vanished underneath us: a writer or another
            #                reader is active; don't quarantine

    def contains(self, key: AotKey) -> bool:
        """Both entry files present: NO load, NO events or counters. The
        LM loader decides all-or-nothing with it before any ``get``."""
        bin_p, man_p = self._entry_paths(key)
        return os.path.exists(bin_p) and os.path.exists(man_p)

    # -- read ----------------------------------------------------------------

    def get(self, key: AotKey) -> Optional[Libraries]:
        """The stored libraries of ``key``, every byte verified, or None
        (a plain miss, or a quarantined bad entry: either way the caller
        builds and re-banks with :meth:`put`). Loads nothing."""
        bin_p, man_p = self._entry_paths(key)
        if not (os.path.exists(bin_p) and os.path.exists(man_p)):
            half = bin_p if os.path.exists(bin_p) else (
                man_p if os.path.exists(man_p) else None)
            if half is not None and not self._in_flight(half):
                # half an entry, old enough that no writer is between its
                # two renames: a crashed bank or a deleted file. A FRESH
                # half is a concurrent put() mid-bank: miss quietly.
                self._quarantine(key, "incomplete_entry",
                                 "payload or manifest missing")
            else:
                self._misses.inc(name=key.name)
                self._emit("aot_miss", name=key.name, digest=key.digest)
            return None
        try:
            with open(man_p, "r", encoding="utf-8") as f:
                manifest = json.load(f)
            rows = list(manifest["libraries"])
        except (OSError, ValueError, KeyError, TypeError) as e:
            self._quarantine(key, "corrupt_manifest",
                             f"{type(e).__name__}: {e}")
            return None
        try:
            with open(bin_p, "rb") as f:
                blob = f.read()
        except OSError as e:
            self._quarantine(key, "unreadable_payload",
                             f"{type(e).__name__}: {e}")
            return None
        if sha256_hex(blob) != manifest.get("payload_sha256"):
            self._quarantine(
                key, "payload_digest_mismatch",
                f"{len(blob)} bytes on disk do not hash to the manifest's "
                "payload_sha256 (truncated or tampered)")
            return None
        libs: Libraries = {}
        try:
            for row in rows:
                lo = int(row["offset"])
                data = blob[lo:lo + int(row["bytes"])]
                if sha256_hex(data) != row["sha256"]:
                    raise ValueError(
                        f"library {row['source']} does not hash to its row")
                libs[str(row["source"])] = data
        except (KeyError, TypeError, ValueError) as e:
            self._quarantine(key, "corrupt_payload",
                             f"{type(e).__name__}: {e}")
            return None
        self._hits.inc(name=key.name)
        self._emit("aot_hit", name=key.name, digest=key.digest,
                   payload_bytes=len(blob), libraries=sorted(libs))
        return libs

    # -- write ---------------------------------------------------------------

    def put(self, key: AotKey, libs: Libraries, *,
            meta: Optional[Dict[str, Any]] = None) -> bool:
        """Bank ``libs`` ({source: library bytes}) under ``key``. Returns
        False, never raises, when the write fails: banking is an
        optimisation, and a failed bank must not take down the boot that
        just built its libraries."""
        try:
            rows, parts, offset = [], [], 0
            for source in sorted(libs):
                data = bytes(libs[source])
                rows.append({"source": source, "offset": offset,
                             "bytes": len(data), "sha256": sha256_hex(data)})
                parts.append(data)
                offset += len(data)
            blob = b"".join(parts)
            bin_p, man_p = self._entry_paths(key)
            os.makedirs(os.path.dirname(bin_p), exist_ok=True)
            manifest = {
                "v": _SCHEMA_V,
                "name": key.name,
                "digest": key.digest,
                "key": key.asdict(),
                "payload_sha256": sha256_hex(blob),
                "payload_bytes": len(blob),
                "libraries": rows,
                "created_at": time.time(),
                "meta": meta or {},
            }
            for path, data in (
                (bin_p, blob),
                (man_p, json.dumps(manifest, indent=1).encode()),
            ):
                tmp = path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, path)
        except Exception as e:
            self._fallbacks.inc(reason="bank_failed")
            self._emit("aot_fallback", name=key.name, digest=key.digest,
                       reason="bank_failed",
                       detail=f"{type(e).__name__}: {e}"[:500])
            log.warning("aot bank of %s/%s failed: %s: %s", key.name,
                        key.digest[:12], type(e).__name__, e)
            return False
        self._banks.inc(name=key.name)
        self._emit("aot_bank", name=key.name, digest=key.digest,
                   payload_bytes=manifest["payload_bytes"],
                   libraries=sorted(libs))
        log.info("aot banked %s/%s (%d bytes)", key.name, key.digest[:12],
                 manifest["payload_bytes"])
        return True

    def load_or_build(
        self, key: AotKey, build: Callable[[], Libraries],
        install: Callable[[Libraries], Any], *,
        meta: Optional[Callable[[], Dict[str, Any]]] = None,
    ) -> Tuple[Any, str]:
        """The central path: hit -> ``install`` the verified libraries;
        miss -> ``build()`` them, bank, ``install``. A verified library
        that still fails to load (an ``OSError`` from ``install``) is
        quarantined as ``load_error`` and rebuilt. ``meta`` is called
        after a build, for the manifest. Returns ``(install's result,
        "hit" | "miss")``."""
        libs = self.get(key)
        if libs is not None:
            try:
                return install(libs), "hit"
            except OSError as e:
                self._quarantine(key, "load_error",
                                 f"{type(e).__name__}: {e}")
        libs = build()
        self.put(key, libs, meta=meta() if meta is not None else None)
        return install(libs), "miss"

    # -- inventory (cli aot ls / gc) -----------------------------------------

    def entries(self) -> List[Dict[str, Any]]:
        """Manifest summaries of every entry (quarantined and orphaned
        files flagged as such): the ``cli aot ls`` view."""
        out: List[Dict[str, Any]] = []
        if not os.path.isdir(self.root):
            return out
        for name in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, name)
            if not os.path.isdir(d):
                continue
            files = sorted(os.listdir(d))
            manifests = {f[:-5] for f in files if f.endswith(".json")}
            payloads = {f[:-4] for f in files if f.endswith(".bin")}
            for digest in sorted(manifests | payloads):
                row: Dict[str, Any] = {
                    "name": name, "digest": digest,
                    "orphan": digest not in manifests
                    or digest not in payloads,
                }
                bin_p = os.path.join(d, f"{digest}.bin")
                if os.path.exists(bin_p):
                    st = os.stat(bin_p)
                    row["bytes"] = st.st_size
                    row["age_s"] = max(time.time() - st.st_mtime, 0.0)
                man_p = os.path.join(d, f"{digest}.json")
                if digest in manifests:
                    try:
                        with open(man_p, "r", encoding="utf-8") as f:
                            m = json.load(f)
                        row["key"] = m.get("key", {})
                        row["created_at"] = m.get("created_at")
                        row.setdefault("bytes", m.get("payload_bytes"))
                    except (OSError, ValueError):
                        row["orphan"] = True
                out.append(row)
            quarantined = [f for f in files if f.endswith(".quarantined")]
            if quarantined:
                out.append({"name": name, "digest": None,
                            "quarantined": len(quarantined)})
        return out

    def gc(self, *, dry_run: bool = False) -> Dict[str, Any]:
        """Prune entries that can never hit again: a code revision that no
        longer matches the current tree, unknown program names, orphaned
        halves and quarantined files. Entries of another runtime or
        device are stale by construction (they write other digests) and
        go with reason ``environment``."""
        from .programs import KNOWN_PROGRAMS, current_code_rev

        removed: List[Dict[str, str]] = []
        kept = 0
        if not os.path.isdir(self.root):
            return {"removed": removed, "kept": 0, "dry_run": dry_run}
        current = {n: current_code_rev(n) for n in KNOWN_PROGRAMS}
        runtime, backend = runtime_version(), device_backend()
        for name in sorted(os.listdir(self.root)):
            d = os.path.join(self.root, name)
            if not os.path.isdir(d):
                continue
            # decided per ENTRY (the manifest speaks for its payload), so
            # a dry run reports every file a real run would delete
            doomed: Dict[str, str] = {}   # file name -> reason
            for fname in sorted(os.listdir(d)):
                if fname.endswith(".quarantined") or fname.endswith(".tmp"):
                    doomed[fname] = "quarantined"
                elif fname.endswith(".bin"):
                    if not os.path.exists(
                            os.path.join(d, fname[:-4] + ".json")):
                        doomed[fname] = "orphan_payload"
                elif fname.endswith(".json"):
                    digest = fname[:-5]
                    reason = None
                    if not os.path.exists(os.path.join(d, digest + ".bin")):
                        reason = "orphan_manifest"
                    elif name not in current:
                        reason = "unknown_program"
                    else:
                        try:
                            with open(os.path.join(d, fname), "r",
                                      encoding="utf-8") as f:
                                key = json.load(f).get("key", {})
                        except (OSError, ValueError):
                            reason = "corrupt_manifest"
                        else:
                            if key.get("code_rev") != current[name]:
                                reason = "stale_code_rev"
                            elif (key.get("runtime_version") != runtime
                                  or key.get("backend") != backend):
                                reason = "environment"
                    if reason is not None:
                        doomed[fname] = reason
                        if reason != "orphan_manifest":
                            # a pruned manifest takes its payload along
                            doomed.setdefault(digest + ".bin", reason)
            for fname in sorted(os.listdir(d)):
                reason = doomed.get(fname)
                if reason is None:
                    kept += 1
                    continue
                removed.append({"name": name, "file": fname,
                                "reason": reason})
                if not dry_run:
                    try:
                        os.remove(os.path.join(d, fname))
                    except OSError:
                        log.exception("aot gc could not remove %s/%s",
                                      name, fname)
        return {"removed": removed, "kept": kept, "dry_run": dry_run}
