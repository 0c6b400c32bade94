"""ctypes bindings for the native data runtime: idx decode, normalize,
bitpack, the CIFAR-10 binary decode and the threaded batch pool.

The port's counterpart of the JAX package's ``native/``, with its own
copies of ``idx_loader.cpp`` and ``batch_pool.cpp`` (the same C ABI and
arithmetic, so every output is bitwise that library's). This is
host-side data loading, not a device kernel.

The library is built by ``g++`` at first use into the package's
``_build/`` directory (``ops._kernels.BUILD_DIR``, listed in
``.gitignore``); its file name carries a hash of both sources and the
flags, so an edited source is rebuilt and a stale library is never
loaded, and nothing is ever written beside the sources. The build goes
to a per-process temporary name and is renamed into place, so concurrent
processes never load a half-written file. Without ``g++``, when the
build fails, or with ``DMB_TPU_NO_NATIVE=1``, every entry returns None
(``BatchPool.create`` too) and the callers take their numpy paths, as
the JAX package's do. Nothing runs at import time.

  available()                         the library built and loaded
  load_idx_native(path)               an idx file's uint8 array
  normalize_native(u8, mean, std)     (x / 255 - mean) / std, float32
  pack_bits_native(x)                 (rows, k) ±1 -> (rows, ceil(k/32))
                                      int32 bitplanes (bit = x > 0)
  BatchPool.create(images, labels, idx, batch)
                                      worker threads gather shuffled
                                      batches ahead of the consumer, in
                                      index order
  cifar_bin_decode_native(path, n)    a CIFAR-10 binary batch as NHWC
                                      uint8 images and int32 labels
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("idx_loader.cpp", "batch_pool.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
ENV_DISABLE = "DMB_TPU_NO_NATIVE"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """The library's path under ``ops._kernels.BUILD_DIR``: named by a
    hash of the flags and both sources."""
    from ..ops import _kernels

    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    return os.path.join(_kernels.BUILD_DIR,
                        f"libdmbnative-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS,
                        *(os.path.join(_DIR, s) for s in SOURCES),
                        "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get(ENV_DISABLE):
            return None
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            try:
                lib = ctypes.CDLL(path)
            except OSError:   # a library another machine built: rebuild
                _build(path)
                lib = ctypes.CDLL(path)
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            log.debug("native library unavailable (%s); numpy paths", e)
            return None
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    P, i64 = ctypes.POINTER, ctypes.c_int64
    lib.idx_header.restype = ctypes.c_int
    lib.idx_header.argtypes = [ctypes.c_char_p, P(i64)]
    lib.idx_read_u8.restype = ctypes.c_int
    lib.idx_read_u8.argtypes = [ctypes.c_char_p, P(ctypes.c_uint8), i64]
    lib.u8_normalize.restype = ctypes.c_int
    lib.u8_normalize.argtypes = [P(ctypes.c_uint8), P(ctypes.c_float), i64,
                                 ctypes.c_float, ctypes.c_float]
    lib.pack_bits_pm1.restype = ctypes.c_int
    lib.pack_bits_pm1.argtypes = [P(ctypes.c_float), P(ctypes.c_int32), i64,
                                  i64, i64]
    lib.cifar_bin_decode.restype = ctypes.c_int
    lib.cifar_bin_decode.argtypes = [ctypes.c_char_p, P(ctypes.c_uint8),
                                     P(ctypes.c_uint8), i64]
    lib.bp_create.restype = ctypes.c_void_p
    lib.bp_create.argtypes = [P(ctypes.c_float), P(ctypes.c_int32), i64,
                              P(i64), i64, i64, ctypes.c_int, ctypes.c_int]
    lib.bp_next.restype = i64
    lib.bp_next.argtypes = [ctypes.c_void_p, P(ctypes.c_float),
                            P(ctypes.c_int32)]
    lib.bp_destroy.restype = None
    lib.bp_destroy.argtypes = [ctypes.c_void_p]


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    return _load() is not None


def load_idx_native(path: str) -> Optional[np.ndarray]:
    """The idx file's array; None without the library or for a gzipped
    file (the python parser reads those)."""
    if path.endswith(".gz"):
        return None
    lib = _load()
    if lib is None:
        return None
    dims = (ctypes.c_int64 * 4)()
    ndim = lib.idx_header(path.encode(), dims)
    if ndim < 1:
        raise ValueError(f"{path}: bad idx file (code {ndim})")
    shape = tuple(int(dims[i]) for i in range(ndim))
    out = np.empty(int(np.prod(shape)), dtype=np.uint8)
    rc = lib.idx_read_u8(path.encode(), _ptr(out, ctypes.c_uint8), out.size)
    if rc != 0:
        raise ValueError(f"{path}: idx payload read failed (code {rc})")
    return out.reshape(shape)


def normalize_native(images_u8: np.ndarray, mean: float, std: float
                     ) -> Optional[np.ndarray]:
    """``(u8 / 255 - mean) / std`` as float32, computed as the JAX
    package's library computes it: ``u8 * (inv_std / 255) + (-mean *
    inv_std)`` with ``inv_std = 1 / std``, all in float32."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(images_u8, dtype=np.uint8).reshape(-1)
    out = np.empty(flat.size, dtype=np.float32)
    lib.u8_normalize(_ptr(flat, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                     flat.size, ctypes.c_float(mean),
                     ctypes.c_float(1.0 / std))
    return out.reshape(images_u8.shape)


def pack_bits_native(x: np.ndarray) -> Optional[np.ndarray]:
    """(rows, k) ±1 float32 -> (rows, ceil(k/32)) int32 bitplanes."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    rows, k = x.shape
    kw = -(-k // 32)
    out = np.empty((rows, kw), dtype=np.int32)
    lib.pack_bits_pm1(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_int32),
                      rows, k, kw)
    return out


class BatchPool:
    """Threaded native batch loader: worker threads gather the shuffled
    batches' rows (``images[idx]``) into a ring of slots ahead of the
    consumer, the capability of a torch ``DataLoader``'s workers for this
    pipeline. Batches come in index order, whatever the threads'
    schedule.

    Iterating gives (images (batch, *item_shape) float32, labels (batch,)
    int32), arrays the caller owns. Close it (a context manager) or let
    ``__del__`` join the workers. ``BatchPool.create`` returns None
    without the library."""

    def __init__(self, lib, images: np.ndarray, labels: np.ndarray,
                 idx: np.ndarray, batch: int, n_threads: int,
                 n_slots: int):
        self._lib = lib
        self._handle = None
        # the pool reads these buffers from C++: keep them alive
        self._images = np.ascontiguousarray(images, dtype=np.float32)
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        self._item_shape = self._images.shape[1:]
        self._feat = (int(np.prod(self._item_shape))
                      if self._item_shape else 1)
        self._batch = int(batch)
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        self._n_batches = len(idx) // self._batch
        idx = idx[: self._n_batches * self._batch]
        if idx.size and (idx.min() < 0 or idx.max() >= len(self._labels)):
            raise IndexError("batch indices out of range")
        self._handle = lib.bp_create(
            _ptr(self._images, ctypes.c_float),
            _ptr(self._labels, ctypes.c_int32), self._feat,
            _ptr(idx, ctypes.c_int64), self._n_batches, self._batch,
            n_threads, n_slots)
        if not self._handle:
            raise RuntimeError("bp_create failed")

    @classmethod
    def create(cls, images, labels, idx, batch, *, n_threads: int = 2,
               n_slots: int = 4) -> Optional["BatchPool"]:
        lib = _load()
        if lib is None:
            return None
        return cls(lib, images, labels, idx, batch, n_threads, n_slots)

    def __iter__(self):
        while self._handle:
            images = np.empty((self._batch, self._feat), np.float32)
            labels = np.empty((self._batch,), np.int32)
            b = self._lib.bp_next(self._handle,
                                  _ptr(images, ctypes.c_float),
                                  _ptr(labels, ctypes.c_int32))
            if b < 0:
                return
            yield images.reshape((self._batch, *self._item_shape)), labels

    def close(self) -> None:
        if self._handle:
            self._lib.bp_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):   # interpreter teardown
            pass


def cifar_bin_decode_native(path: str, n_records: int):
    """A CIFAR-10 binary batch as (images (n, 32, 32, 3) uint8 NHWC,
    labels (n,) int32); None without the library. The CHW -> HWC
    transpose is fused into the one read pass."""
    lib = _load()
    if lib is None:
        return None
    images = np.empty((n_records, 32, 32, 3), dtype=np.uint8)
    labels_u8 = np.empty((n_records,), dtype=np.uint8)
    rc = lib.cifar_bin_decode(path.encode(), _ptr(images, ctypes.c_uint8),
                              _ptr(labels_u8, ctypes.c_uint8), n_records)
    if rc != 0:
        raise ValueError(f"{path}: cifar bin decode failed (code {rc})")
    return images, labels_u8.astype(np.int32)
