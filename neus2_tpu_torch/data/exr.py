"""Minimal OpenEXR scanline codec, pure numpy + stdlib ``zlib`` (port of
``neus2_tpu/data/exr.py``; the reference decodes EXR depth maps and HDR
images with tinyexr, src/nerf_loader.cu:218-220).

The subset capture rigs emit:

  * single-part scanline images (no tiles, deep data or multi-part);
  * pixel types HALF / FLOAT / UINT;
  * compression NONE, ZIPS (1 line a chunk) and ZIP (16 lines a chunk) with
    the standard byte-delta + interleave predictor;
  * increasing-Y line order, dataWindow == displayWindow.

``read_exr`` returns {channel name: (H, W) float32}; ``write_exr`` writes a
dict of channels.  The card's machine has neither OpenEXR nor imageio,
hence a codec of the port's own.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = 20000630  # 0x01312f76 little-endian
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_CODES = {v: k for k, v in _PIXEL_DTYPES.items()}
_LINES_PER_CHUNK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstr(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_chlist(data: bytes) -> list[tuple[str, int]]:
    """-> [(name, pixel_type)] in file (alphabetical) order."""
    channels = []
    pos = 0
    while data[pos] != 0:
        name, pos = _read_cstr(data, pos)
        (ptype,) = struct.unpack_from("<i", data, pos)
        # skip pLinear + reserved (4) + xSampling (4) + ySampling (4)
        pos += 16
        channels.append((name, ptype))
    return channels


def _unpredict(raw: bytes) -> bytes:
    """Invert the EXR zip predictor: cumulative byte delta, then
    de-interleave (first half -> even offsets, second half -> odd)."""
    t = np.frombuffer(raw, np.uint8).astype(np.int16)
    t = (np.cumsum(t + (np.arange(len(t)) > 0) * -128, dtype=np.int64) % 256).astype(
        np.uint8
    )
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _predict(raw: bytes) -> bytes:
    """Forward predictor for writing: interleave, then byte delta."""
    t = np.frombuffer(raw, np.uint8)
    half = (len(t) + 1) // 2
    inter = np.empty_like(t)
    inter[:half] = t[0::2]
    inter[half:] = t[1::2]
    d = inter.astype(np.int16)
    d[1:] = d[1:] - inter[:-1].astype(np.int16) + 128
    return (d % 256).astype(np.uint8).tobytes()


def read_exr(path: str | Path) -> dict[str, np.ndarray]:
    """Decode an EXR file -> {channel: (H, W) float32}."""
    buf = Path(path).read_bytes()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    if version & 0x1800:
        raise ValueError(f"{path}: multi-part/deep EXR not supported")

    pos = 8
    attrs: dict[str, bytes] = {}
    while True:
        name, pos = _read_cstr(buf, pos)
        if not name:
            break
        _, pos = _read_cstr(buf, pos)  # attribute type
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = buf[pos : pos + size]
        pos += size

    channels = _parse_chlist(attrs["channels"])
    compression = attrs["compression"][0]
    if compression not in _LINES_PER_CHUNK:
        raise ValueError(f"{path}: unsupported EXR compression {compression}")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1

    lines_per = _LINES_PER_CHUNK[compression]
    n_chunks = -(-h // lines_per)
    offsets = struct.unpack_from(f"<{n_chunks}q", buf, pos)

    line_bytes = sum(w * _PIXEL_DTYPES[pt].itemsize for _, pt in channels)
    out = {
        name: np.empty((h, w), np.float32) for name, _ in channels
    }
    for off in offsets:
        y, packed = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + packed]
        rows = min(lines_per, y1 - y + 1)
        raw_size = rows * line_bytes
        if compression != 0 and packed < raw_size:
            data = _unpredict(zlib.decompress(data))
        if len(data) != raw_size:
            raise ValueError(f"{path}: chunk at y={y} has wrong size")
        p = 0
        for r in range(rows):
            for name, ptype in channels:
                dt = _PIXEL_DTYPES[ptype]
                n = w * dt.itemsize
                row = np.frombuffer(data, dt, count=w, offset=p)
                out[name][y - y0 + r] = row.astype(np.float32)
                p += n
    return out


def read_exr_rgba(path: str | Path) -> np.ndarray:
    """-> (H, W, 4) float32 linear RGBA (A=1, missing channels replicated)."""
    ch = read_exr(path)
    if all(k in ch for k in "RGB"):
        rgb = np.stack([ch["R"], ch["G"], ch["B"]], axis=-1)
    else:  # gray (e.g. single Y/Z channel)
        first = next(iter(ch.values()))
        rgb = first[..., None].repeat(3, axis=-1)
    a = ch.get("A")
    if a is None:
        a = np.ones_like(rgb[..., 0])
    return np.concatenate([rgb, a[..., None]], axis=-1).astype(np.float32)


def read_exr_depth(path: str | Path) -> np.ndarray:
    """-> (H, W) float32 depth: prefers Z, else the first channel."""
    ch = read_exr(path)
    return ch.get("Z", next(iter(ch.values())))


def write_exr(
    path: str | Path,
    channels: dict[str, np.ndarray],
    compression: str = "zip",
    half: bool = False,
) -> None:
    """Write a scanline EXR. ``channels``: {name: (H, W) array}."""
    comp = {"none": 0, "zips": 2, "zip": 3}[compression]
    names = sorted(channels)
    h, w = np.asarray(channels[names[0]]).shape
    dt = np.dtype("<f2") if half else np.dtype("<f4")
    ptype = _PIXEL_CODES[dt]

    def attr(name: str, typ: str, data: bytes) -> bytes:
        return (
            name.encode() + b"\0" + typ.encode() + b"\0"
            + struct.pack("<i", len(data)) + data
        )

    chlist = b"".join(
        n.encode() + b"\0" + struct.pack("<iBBBBii", ptype, 0, 0, 0, 0, 1, 1)
        for n in names
    ) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (
        struct.pack("<ii", _MAGIC, 2)
        + attr("channels", "chlist", chlist)
        + attr("compression", "compression", bytes([comp]))
        + attr("dataWindow", "box2i", box)
        + attr("displayWindow", "box2i", box)
        + attr("lineOrder", "lineOrder", b"\0")
        + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
        + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
        + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
        + b"\0"
    )

    lines_per = _LINES_PER_CHUNK[comp]
    n_chunks = -(-h // lines_per)
    arrs = {n: np.ascontiguousarray(channels[n], dtype=dt) for n in names}
    chunks = []
    for c in range(n_chunks):
        y = c * lines_per
        rows = min(lines_per, h - y)
        raw = b"".join(
            arrs[n][y + r].tobytes() for r in range(rows) for n in names
        )
        if comp != 0:
            packed = zlib.compress(_predict(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append((y, packed))

    table_pos = len(header)
    data_pos = table_pos + 8 * n_chunks
    offsets, body = [], []
    for y, packed in chunks:
        offsets.append(data_pos)
        entry = struct.pack("<ii", y, len(packed)) + packed
        body.append(entry)
        data_pos += len(entry)
    Path(path).write_bytes(
        header + struct.pack(f"<{n_chunks}q", *offsets) + b"".join(body)
    )
