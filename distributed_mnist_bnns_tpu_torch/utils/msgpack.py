"""A msgpack codec for the trees the JAX package serializes with flax.

The counterpart of ``flax.serialization``'s ``to_bytes`` / ``from_bytes``
(checkpoints) and ``msgpack_serialize`` / ``msgpack_restore`` (packed
artifacts), written out so that the port needs neither flax nor the
``msgpack`` package. It makes the type choices flax's ``msgpack.packb(
tree, default=_msgpack_ext_pack, strict_types=True)`` makes, so the same
tree gives the same bytes (and the same sha256):

  dict          fixmap / map16 / map32, in the dict's order
  list, tuple   fixarray / array16 / array32
  str           fixstr / str8 / str16 / str32 (utf-8)
  bytes         bin8 / bin16 / bin32
  int           the smallest form: positive / negative fixint, then
                uint8..64 for positive and int8..64 for negative values
  float         float64 (a Python float)
  bool, None    true / false, nil
  ndarray       ext 1: the packb of ``(shape, dtype name, C-order
                bytes)``; a 0-d array is an ndarray with shape ()
  numpy scalar  ext 3, the same payload
  ext payloads  fixext 1/2/4/8/16 when the payload has exactly that
                length, else ext8 / ext16 / ext32

A torch tensor packs as the ndarray of its values; ``bfloat16`` goes by
name, as flax writes it, and decodes to a torch bfloat16 tensor (numpy
has no such dtype). Leaves over ``MAX_CHUNK_SIZE`` bytes (2^30) are
written in flax's ``__msgpack_chunked_array__`` form (flat chunks of at
most 2^30 bytes, shape and chunks as ``{"0": ..., "1": ...}`` maps) and
read back whole.

  to_bytes(tree)            flax ``to_bytes`` of a state dict: the tree
                            in its own order
  msgpack_serialize(tree)   flax ``msgpack_serialize``: every dict's keys
                            sorted first, as its ``tree_map`` copy sorts
  from_bytes(data)          the tree (flax ``from_bytes`` / ``msgpack_
                            restore``); arrays as numpy (bfloat16: torch)
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Bf16:
    """A bfloat16 array in flight: its shape and raw C-order bytes."""

    def __init__(self, t: torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        self.shape = tuple(t.shape)
        self.nbytes = t.numel() * 2
        self.data = t.view(torch.int16).numpy().tobytes()


def _as_array(x: Any):
    """A torch tensor as a numpy array (bfloat16 as ``_Bf16``); any other
    leaf as it is."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return _Bf16(x)
        return x.detach().to("cpu").numpy()
    return x


def _nbytes(a) -> int:
    return a.nbytes if isinstance(a, (np.ndarray, _Bf16)) else 0


# -- encoding ----------------------------------------------------------------

def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        if x < 1 << 8:
            out += b"\xcc" + struct.pack(">B", x)
        elif x < 1 << 16:
            out += b"\xcd" + struct.pack(">H", x)
        elif x < 1 << 32:
            out += b"\xce" + struct.pack(">I", x)
        elif x < 1 << 64:
            out += b"\xcf" + struct.pack(">Q", x)
        else:
            raise OverflowError(f"int {x} too large for msgpack")
    elif x >= -(1 << 7):
        out += b"\xd0" + struct.pack(">b", x)
    elif x >= -(1 << 15):
        out += b"\xd1" + struct.pack(">h", x)
    elif x >= -(1 << 31):
        out += b"\xd2" + struct.pack(">i", x)
    elif x >= -(1 << 63):
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"int {x} too small for msgpack")


def _pack_len(out: bytearray, n: int, fix: Tuple[int, int],
              codes: Tuple[Tuple[int, int, str], ...]) -> None:
    """A length header: ``fix`` = (prefix, limit) for the fix form, then
    (code, limit, struct format) in order."""
    prefix, limit = fix
    if limit and n < limit:
        out.append(prefix | n)
        return
    for code, lim, fmt in codes:
        if n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"object of length {n} too large for msgpack")


_STR = ((0xA0, 32), ((0xD9, 1 << 8, ">B"), (0xDA, 1 << 16, ">H"),
                     (0xDB, 1 << 32, ">I")))
_BIN = ((0, 0), ((0xC4, 1 << 8, ">B"), (0xC5, 1 << 16, ">H"),
                 (0xC6, 1 << 32, ">I")))
_ARRAY = ((0x90, 16), ((0xDC, 1 << 16, ">H"), (0xDD, 1 << 32, ">I")))
_MAP = ((0x80, 16), ((0xDE, 1 << 16, ">H"), (0xDF, 1 << 32, ">I")))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(_FIXEXT[n])
    elif n < 1 << 8:
        out += b"\xc7" + struct.pack(">B", n)
    elif n < 1 << 16:
        out += b"\xc8" + struct.pack(">H", n)
    elif n < 1 << 32:
        out += b"\xc9" + struct.pack(">I", n)
    else:
        raise ValueError(f"ext payload of {n} bytes too large for msgpack")
    out.append(code)
    out += payload


def _ndarray_payload(a) -> bytes:
    """flax ``_ndarray_to_bytes``: packb((shape, dtype name, bytes))."""
    if isinstance(a, _Bf16):
        shape, name, data = a.shape, "bfloat16", a.data
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes do not serialize")
        shape, name, data = a.shape, a.dtype.name, a.tobytes("C")
    out = bytearray()
    _pack(out, [list(shape), name, data])
    return bytes(out)


def _pack(out: bytearray, x: Any) -> None:
    x = _as_array(x)
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), *_STR)
        out += data
    elif type(x) in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), *_BIN)
        out += data
    elif type(x) is dict:
        _pack_len(out, len(x), *_MAP)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) in (list, tuple):
        _pack_len(out, len(x), *_ARRAY)
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, _Bf16)):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} to msgpack")


def _chunk(a) -> Dict[str, Any]:
    """flax ``_chunk``: a flat array cut into pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    if isinstance(a, _Bf16):
        flat = torch.frombuffer(bytearray(a.data), dtype=torch.bfloat16)
        itemsize, shape = 2, a.shape
    else:
        flat, itemsize, shape = a.reshape(-1), a.dtype.itemsize, a.shape
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _prepare(x: Any, sort: bool) -> Any:
    """Chunk the oversized array leaves (flax chunks them in dicts and at
    the root) and, with ``sort``, order every dict's keys."""
    x = _as_array(x)
    if isinstance(x, dict):
        items = sorted(x.items()) if sort else x.items()
        out = {}
        for k, v in items:
            v = _as_array(v)
            out[k] = (_chunk(v) if _nbytes(v) > MAX_CHUNK_SIZE
                      else _prepare(v, sort))
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(_prepare(v, sort) for v in x)
    return x


def to_bytes(tree: Any) -> bytes:
    """The msgpack bytes of ``tree`` in its own dict order (flax
    ``to_bytes`` of a state dict)."""
    tree = _prepare(tree, sort=False)
    if _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def msgpack_serialize(tree: Any) -> bytes:
    """flax ``msgpack_serialize``: ``to_bytes`` with every dict's keys
    sorted."""
    tree = _prepare(tree, sort=True)
    if _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# -- decoding ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data truncated")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_from_payload(payload: bytes):
    shape, name, buf = _decode(payload, raw=True)
    name = name.decode() if isinstance(name, bytes) else name
    shape = tuple(shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(payload)
    if code == EXT_NPSCALAR:
        return _array_from_payload(payload)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


def _read(r: _Reader, raw: bool) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return r.unpack(fixed[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
        return _str(r.take(n), raw)
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_read(r, raw) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"invalid msgpack byte 0x{b:02x}")


def _str(data: memoryview, raw: bool):
    return bytes(data) if raw else str(data, "utf-8")


def _read_map(r: _Reader, n: int, raw: bool) -> Dict[Any, Any]:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _decode(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data)
    out = _read(r, raw)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data after "
                         "the msgpack object")
    return out


def _unchunk(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if parts and isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def from_bytes(data: bytes) -> Any:
    """The tree of msgpack ``data`` (flax ``msgpack_restore``): maps as
    dicts, arrays as read-only numpy arrays over the data (bfloat16 as
    torch tensors), chunked leaves whole."""
    return _unchunk_tree(_decode(bytes(data)))

