"""A msgpack encoder and decoder for the subset the port's two snapshot
formats use, without the ``msgpack`` or ``flax`` packages (neither is
promised where the port runs).

Types: nil, bool, int (every width), float32/64 (Python floats encode as
float64), str, bin, array (from list or tuple), map, and flax's ext types
(flax ``serialization.py``): 1, an ndarray as the packed triple
``(shape, dtype name, C-order bytes)``, and 3, a numpy scalar packed the
same way as a 0-d array.  The encoder picks the smallest encoding, as
``msgpack.packb(..., use_bin_type=True)`` does, so its output is byte for
byte msgpack's; the decoder returns ``bytes`` for bin and ``str`` for str,
and an ndarray that is a read-only view into the input buffer (one copy
at most, made by the caller where it must write).

flax splits an array over 2^30 bytes into a chunked map
(``__msgpack_chunked_array__``); the decoder refuses one rather than
misreading it, and the encoder refuses to write one.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2**30  # flax's chunking threshold
_CHUNKED = "__msgpack_chunked_array__"


# -- encoder ------------------------------------------------------------------


def _int(out: list, v: int) -> int:
    if 0 <= v < 0x80:
        b = struct.pack("B", v)
    elif -32 <= v < 0:
        b = struct.pack("b", v)
    elif v >= 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                              (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                b = bytes([tag]) + struct.pack(fmt, v)
                break
        else:
            raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                              (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                b = bytes([tag]) + struct.pack(fmt, v)
                break
        else:
            raise OverflowError(f"int {v} does not fit msgpack")
    out.append(b)
    return len(b)


def _header(n: int, fix: int | None, fix_max: int, tags: tuple) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit ``tags`` (None where the format has no such width)."""
    if fix is not None and n < fix_max:
        return bytes([fix | n])
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < top:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


def _bin(out: list, data) -> int:
    n = memoryview(data).nbytes
    h = _header(n, None, 0, (0xC4, 0xC5, 0xC6))
    out += [h, data]
    return len(h) + n


def _ndarray_payload(arr: np.ndarray) -> tuple[list, int]:
    """flax's ndarray ext payload: packb((shape, dtype name, bytes))."""
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError(f"cannot serialize an array of dtype {arr.dtype}")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes would need flax's chunked form")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")
    parts: list = [b"\x93"]
    n = 1 + _pack(parts, list(arr.shape)) + _pack(parts, arr.dtype.name)
    n += _bin(parts, memoryview(arr).cast("B") if arr.ndim else arr.tobytes())
    return parts, n


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}  # payload size -> tag


def _ext(out: list, code: int, parts: list, n: int) -> int:
    if n in _FIXEXT:
        h = bytes([_FIXEXT[n], code])
    else:
        h = _header(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])
    out.append(h)
    out += parts
    return len(h) + n


def _pack(out: list, obj) -> int:
    if obj is None:
        out.append(b"\xc0")
        return 1
    if obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
        return 1
    if isinstance(obj, np.ndarray):
        return _ext(out, _EXT_NDARRAY, *_ndarray_payload(obj))
    if isinstance(obj, np.generic):
        return _ext(out, _EXT_NPSCALAR, *_ndarray_payload(np.asarray(obj)))
    if isinstance(obj, int):
        return _int(out, obj)
    if isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
        return 9
    if isinstance(obj, str):
        data = obj.encode("utf-8")
        h = _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += [h, data]
        return len(h) + len(data)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return _bin(out, obj)
    if isinstance(obj, (list, tuple)):
        h = _header(len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        out.append(h)
        return len(h) + sum(_pack(out, v) for v in obj)
    if isinstance(obj, dict):
        h = _header(len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        out.append(h)
        return len(h) + sum(_pack(out, k) + _pack(out, v) for k, v in obj.items())
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes.  The document is built as a list of
    chunks (array buffers by reference) and joined once."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


# -- decoder ------------------------------------------------------------------

_FIXED = {  # tag -> (struct format, size) of the scalar types
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def length(self, size: int) -> int:
        return struct.unpack(_LEN[size], self.take(size))[0]

    def value(self, raw_bin: bool = False):
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F, raw_bin)
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in _FIXED:
            fmt, size = _FIXED[tag]
            return struct.unpack(fmt, self.take(size))[0]
        if tag in (0xC4, 0xC5, 0xC6):
            data = self.take(self.length(1 << (tag - 0xC4)))
            return data if raw_bin else bytes(data)
        if tag in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.length(1 << (tag - 0xD9))), "utf-8")
        if tag in (0xDC, 0xDD):
            return self.array(self.length(2 if tag == 0xDC else 4), raw_bin)
        if tag in (0xDE, 0xDF):
            return self.map(self.length(2 if tag == 0xDE else 4))
        if 0xD4 <= tag <= 0xD8:
            return self.ext(1 << (tag - 0xD4))
        if tag in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(1 << (tag - 0xC7)))
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")

    def array(self, n: int, raw_bin: bool = False) -> list:
        return [self.value(raw_bin) for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if out.get(_CHUNKED) is True:
            raise ValueError("a flax chunked array (over 2^30 bytes) is not supported")
        return out

    def ext(self, n: int):
        code = self.take(1)[0]
        payload = _Reader(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, data = payload.value(raw_bin=True)
        if isinstance(dtype, (bytes, memoryview)):
            dtype = bytes(dtype).decode()
        arr = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data) -> object:
    """Decode one msgpack document from ``data`` (bytes or a buffer)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of extra data after the document")
    return out
