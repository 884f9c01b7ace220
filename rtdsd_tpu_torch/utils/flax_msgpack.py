"""flax's msgpack checkpoint bytes, read and written without flax or
msgpack: the port's counterpart of ``flax.serialization.msgpack_restore``
and ``msgpack_serialize`` / ``to_bytes`` as the JAX package calls them
(``rtdsd_tpu/cli/common.py:138-151``, ``rtdsd_tpu/engine/checkpoint.py``,
``rtdsd_tpu/cli/convert.py``).

The subset flax writes, and nothing more:

- maps with string keys (flax's state dicts turn tuples and lists into
  maps keyed ``"0"``, ``"1"``, ...), arrays, nil, bool, int, float, str
  and bin;
- ext type 1, an ndarray: a msgpack ``(shape, dtype name, row-major
  bytes)`` triple; ext type 3, a numpy scalar in the same form; ext type 2,
  a complex as ``(real, imag)``;
- arrays over ``MAX_CHUNK_SIZE`` bytes split into flat chunks under a
  ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}`` map.

Leaves come back as numpy arrays, or as CPU tensors for ``bfloat16``,
which numpy lacks. :func:`read` reads a file once into one buffer and
views every array leaf out of it, so a full-width ``weights.msgpack``
(about 1.3 GB) is not copied a second time.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Callable, Dict

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30           # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_SCALAR = 1, 2, 3

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


# ------------------------------------------------------------------ decode

class _Reader:
    def __init__(self, buf, start: int = 0, end: int = None):
        self.buf = buf
        self.mv = memoryview(buf)
        self.pos = start
        self.end = len(self.mv) if end is None else end

    def take(self, n: int) -> int:
        """Advance past ``n`` bytes; -> their offset."""
        at = self.pos
        if at + n > self.end:
            raise ValueError("flax msgpack: truncated data")
        self.pos = at + n
        return at

    def unpack(self, fmt: str):
        return struct.unpack_from(fmt, self.mv, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        b = self.mv[self.take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):                       # bin 8/16/32
            return bytes(self.bin(b))
        if b in (0xC7, 0xC8, 0xC9):                       # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:                             # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(">" + "HI"[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"flax msgpack: unsupported type byte 0x{b:02x}")

    def bin(self, b: int) -> memoryview:
        n = self.unpack(">" + "BHI"[b - 0xC4])
        at = self.take(n)
        return self.mv[at:at + n]

    def str(self, n: int) -> str:
        at = self.take(n)
        return bytes(self.mv[at:at + n]).decode("utf-8")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        at = self.take(n)
        inner = _Reader(self.buf, at, at + n)
        if code == _EXT_NDARRAY:
            return inner.ndarray()
        if code == _EXT_SCALAR:
            arr = inner.ndarray()
            return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
        if code == _EXT_COMPLEX:
            re, im = inner.obj()
            return complex(re, im)
        raise ValueError(f"flax msgpack: unknown ext type {code}")

    def ndarray(self):
        """The ``(shape, dtype name, bytes)`` triple of an ndarray ext, its
        array a view of the buffer (a copy for bfloat16)."""
        if self.mv[self.take(1)] != 0x93:
            raise ValueError("flax msgpack: an ndarray ext is not a triple")
        shape, name = tuple(self.obj()), self.obj()
        b = self.mv[self.take(1)]
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("flax msgpack: an ndarray's data is not bin")
        raw = self.bin(b)
        if name == "bfloat16":
            bits = np.frombuffer(raw, np.uint16).copy()
            return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
        return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore`` of ``data`` (bytes, a
    bytearray or a memoryview); array leaves are views of ``data``."""
    r = _Reader(data)
    tree = r.obj()
    if r.pos != r.end:
        raise ValueError(f"flax msgpack: {r.end - r.pos} trailing bytes")
    return _unchunk(tree)


def read(path: str) -> Any:
    """The tree of the flax msgpack file ``path``, its leaves views of one
    writable buffer holding the file."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise OSError(f"{path}: short read")
    return restore(buf)


# ------------------------------------------------------------------ encode

def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F:
        return struct.pack("B", x)
    if -32 <= x < 0:
        return struct.pack("b", x)
    if x > 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF),
                               (0xCE, "I", 0xFFFFFFFF),
                               (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
            if x <= top:
                return struct.pack(">B" + fmt, code, x)
    for code, fmt, bits in ((0xD0, "b", 7), (0xD1, "h", 15), (0xD2, "i", 31),
                            (0xD3, "q", 63)):
        if x >= -(1 << bits):
            return struct.pack(">B" + fmt, code, x)
    raise OverflowError(f"int {x} does not fit msgpack")


def _sized(n: int, fix_base: int, fix_max: int, codes, what: str) -> bytes:
    if fix_base is not None and n <= fix_max:
        return struct.pack("B", fix_base | n)
    for code, fmt, top in zip(codes, "BHI", (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return struct.pack(">B" + fmt, code, n)
    raise OverflowError(f"{what} of {n} entries does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), "str") + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6), "bin")


def _ext_header(n: int, code: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = (struct.pack("B", fixed[n]) if n in fixed
            else _sized(n, None, 0, (0xC7, 0xC8, 0xC9), "ext"))
    return head + struct.pack("b", code)


def _as_numpy(x) -> tuple:
    """(C-contiguous numpy array of the raw bytes' layout, dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"flax msgpack: unsupported tensor dtype {t.dtype}")
        name = _TORCH_NAMES[t.dtype]
        arr = t.view(torch.int16).numpy() if name == "bfloat16" else t.numpy()
        return arr, name
    arr = np.asarray(x, order="C")
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise TypeError("flax msgpack: object and structured dtypes are not "
                        "supported")
    return arr, arr.dtype.name


def _array(x, code: int, write: Callable[[bytes], Any]) -> None:
    arr, name = _as_numpy(x)
    head = (b"\x93" + _sized(arr.ndim, 0x90, 15, (None, 0xDC, 0xDD), "array")
            + b"".join(_int(int(d)) for d in arr.shape) + _str(name)
            + _bin_header(arr.nbytes))
    write(_ext_header(len(head) + arr.nbytes, code))
    write(head)
    if arr.nbytes:
        write(memoryview(arr.reshape(-1)).cast("B"))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else x.nbytes


def _chunked(x) -> dict:
    """flax's ``_chunk``: a flat split at ``MAX_CHUNK_SIZE`` bytes."""
    flat = x.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // (x.element_size()
                                     if isinstance(x, torch.Tensor)
                                     else x.dtype.itemsize))
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in
                                      enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in
                       enumerate(range(0, flat.shape[0], size))}}


def _pack(x, write: Callable[[bytes], Any], keep_order: bool = False) -> None:
    """msgpack ``x``: a dict's keys sorted, as ``msgpack_serialize``'s
    ``tree_map`` copy orders them, but a chunked array's map
    (``keep_order``) in flax's insertion order."""
    if isinstance(x, (list, tuple)):
        write(_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD), "array"))
        for v in x:
            _pack(v, write, keep_order)
    elif isinstance(x, dict):
        write(_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF), "map"))
        if not all(isinstance(k, str) for k in x):
            raise TypeError(f"flax msgpack: map keys {list(x)} are not all str")
        for k in (x if keep_order else sorted(x)):
            v = x[k]
            write(_str(k))
            big = (isinstance(v, (np.ndarray, torch.Tensor))
                   and _nbytes(v) > MAX_CHUNK_SIZE)
            _pack(_chunked(v) if big else v, write, keep_order or big)
    elif x is None:
        write(b"\xc0")
    elif isinstance(x, bool):
        write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, np.generic):
        _array(np.asarray(x), _EXT_SCALAR, write)
    elif isinstance(x, int):
        write(_int(x))
    elif isinstance(x, float):
        write(struct.pack(">Bd", 0xCB, x))
    elif isinstance(x, str):
        write(_str(x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        write(_bin_header(len(b)))
        write(b)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _array(x, _EXT_NDARRAY, write)
    else:
        raise TypeError(f"flax msgpack: cannot serialise {type(x).__name__}")


def packb(tree) -> bytes:
    """flax's ``msgpack_serialize`` of ``tree`` (nested dicts and lists of
    numpy arrays, tensors, numpy scalars and Python values)."""
    parts = []
    _pack(tree, parts.append)
    return b"".join(parts)


def write(path: str, tree) -> None:
    """Write ``tree`` to ``path`` in flax's msgpack format, streamed to a
    temporary file that is then moved into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack(tree, f.write)
    os.replace(tmp, path)
