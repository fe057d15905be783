"""A reader and a writer for the msgpack that ``flax.serialization``
writes, without msgpack or Flax.

``flax.serialization.msgpack_serialize`` packs a tree of dicts whose
leaves are numpy arrays; each array is msgpack ext type 1, whose payload
is itself a msgpack array ``[shape, dtype name, C-order bytes]``.  This
module decodes the subset of msgpack that such a file uses — maps,
arrays, str, bin, ints, floats, nil and bool, ext type 1 — into dicts,
lists, Python scalars and numpy arrays, so that a host with neither
package (the GPU host) can read the committed checkpoints.

``bfloat16`` leaves (numpy has no such dtype) come back as float32 with
the same value, widened bit for bit: each 16-bit pattern shifted into the
top half of a 32-bit float.  Other arrays are read-only views of the
input bytes, as Flax returns them.

Raises :class:`ValueError` on what Flax files do not hold here: ext types
2 (complex) and 3 (numpy scalar), other ext types, and Flax's chunked
arrays (a leaf above 1 GiB is split into ``__msgpack_chunked_array__``
maps).

:func:`serialize` writes a tree of dicts (str keys) and arrays as
``flax.serialization.msgpack_serialize`` writes it, byte for byte: the
keys of every map in sorted order (Flax copies the tree through
``jax.tree_util``, which sorts them), each header in its shortest form,
and each array as ext type 1 ``[shape, dtype name, C-order bytes]``.
A ``torch.bfloat16`` tensor is written as Flax writes a bf16 array.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

NDARRAY_EXT = 1
CHUNKED_KEY = "__msgpack_chunked_array__"

_BE = {1: ">B", 2: ">H", 4: ">I", 8: ">Q"}
_BE_SIGNED = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(need {n} more)")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return struct.unpack(_BE[n], self.take(n))[0]

    def value(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:                      # bin 8 / 16 / 32
            return self.take(self.uint(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:                      # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:                      # uint 8 .. 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:                      # int 8 .. 64
            n = 1 << (b - 0xD0)
            return struct.unpack(_BE_SIGNED[n], self.take(n))[0]
        if 0xD4 <= b <= 0xD8:                      # fixext 1 .. 16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:                      # str 8 / 16 / 32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} is not "
                         f"a type this reader knows")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if key == CHUNKED_KEY:
                raise ValueError("msgpack: Flax chunked arrays (leaves above "
                                 "1 GiB) are not supported")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> np.ndarray:
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack: ext type {code} is not supported "
                             f"(only {NDARRAY_EXT}, a Flax ndarray)")
        return _ndarray(payload)


def _ndarray(payload) -> np.ndarray:
    """An ext-type-1 payload ``[shape, dtype name, bytes]`` → ndarray."""
    inner = _Reader(payload)
    fields = inner.value()
    if (not isinstance(fields, list) or len(fields) != 3
            or inner.pos != len(inner.buf)):
        raise ValueError("msgpack: malformed Flax ndarray payload")
    shape, name, data = fields
    name = bytes(name).decode() if not isinstance(name, str) else name
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, np.dtype(name)).reshape(shape)


def restore(data) -> Any:
    """``flax.serialization.msgpack_restore`` for the committed
    checkpoints: decode the one msgpack object that fills ``data``; bf16
    leaves come back widened to float32."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         f"after the object")
    return out


def _header(out: bytearray, n: int, fix: int, fix_max: int,
            codes: Tuple[int, ...]) -> None:
    """A container / string / bin header: the fix form where n fits it,
    else the first of 8-, 16-, 32-bit lengths (``codes``; 0 where a width
    has no form) that holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code and n < 1 << (8 * width):
            out.append(code)
            out += struct.pack(_BE[width], n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, width in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
            if v < 1 << (8 * width):
                out.append(code)
                out += struct.pack(_BE[width], v)
                return
        raise ValueError(f"msgpack: {v} does not fit 64 bits")
    else:
        for code, width in ((0xD0, 1), (0xD1, 2), (0xD2, 4), (0xD3, 8)):
            if v >= -(1 << (8 * width - 1)):
                out.append(code)
                out += struct.pack(_BE_SIGNED[width], v)
                return
        raise ValueError(f"msgpack: {v} does not fit 64 bits")


def _pack_str(out: bytearray, text: str) -> None:
    raw = text.encode("utf-8")
    _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out += raw


def _array_fields(leaf) -> Tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if hasattr(leaf, "detach"):                    # a torch tensor
        t = leaf.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":
            import torch
            return (tuple(t.shape), "bfloat16",
                    t.view(torch.int16).numpy().tobytes())
        leaf = t.numpy()
    if not isinstance(leaf, np.ndarray):
        # Flax writes numpy scalars as ext type 3, which the reader refuses
        raise ValueError(f"msgpack: a leaf must be an array or a tensor, "
                         f"not {type(leaf).__name__}")
    arr = leaf
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"msgpack: cannot write a {arr.dtype} array")
    return tuple(arr.shape), arr.dtype.name, arr.tobytes("C")


def _pack(out: bytearray, value: Any) -> None:
    if isinstance(value, dict):
        _header(out, len(value), 0x80, 15, (0, 0xDE, 0xDF))
        for key in sorted(value):
            if not isinstance(key, str):
                raise ValueError(f"msgpack: map key {key!r} is not a str")
            _pack_str(out, key)
            _pack(out, value[key])
        return
    shape, name, data = _array_fields(value)
    payload = bytearray()
    _header(payload, 3, 0x90, 15, (0, 0xDC, 0xDD))
    _header(payload, len(shape), 0x90, 15, (0, 0xDC, 0xDD))
    for dim in shape:
        _pack_int(payload, int(dim))
    _pack_str(payload, name)
    _header(payload, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    payload += data
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", NDARRAY_EXT)
    out += payload


def serialize(tree: dict) -> bytes:
    """``flax.serialization.msgpack_serialize`` of a tree of dicts (str
    keys) whose leaves are numpy arrays or tensors, byte for byte (leaves
    below Flax's 1 GiB chunking limit)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


__all__ = ["restore", "serialize"]
