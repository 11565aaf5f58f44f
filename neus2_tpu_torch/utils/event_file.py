"""TensorBoard scalar event files, written and read without the
``tensorboard``, ``tensorflow`` or ``protobuf`` packages (none is promised
where the port runs).

An event file is a sequence of TFRecords: a little-endian uint64 length,
the masked CRC32C of those 8 bytes, the payload, and the masked CRC32C of
the payload.  Each payload is one serialized ``tensorflow.Event``; this
module writes and reads the fields a scalar log uses:

    Event   { double wall_time = 1; int64 step = 2; string file_version = 3;
              Summary summary = 5; }
    Summary { repeated Value value = 1; }
    Value   { string tag = 1; float simple_value = 2; }

``EventFileWriter`` is the subset of PyTorch's TensorBoard ``SummaryWriter``
that the CLI calls (``add_scalar``, ``flush``, ``close``); TensorBoard reads
its files as it reads SummaryWriter's.  ``read_scalars`` reads them back.
"""

from __future__ import annotations

import atexit
import os
import socket
import struct
import time
from pathlib import Path


def _crc32c_table() -> list[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1  # Castagnoli, reflected
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC32C_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """The TFRecord checksum: the CRC rotated right by 15 bits plus a constant."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _record(payload: bytes) -> bytes:
    length = struct.pack("<Q", len(payload))
    return (length + struct.pack("<I", masked_crc32c(length)) + payload
            + struct.pack("<I", masked_crc32c(payload)))


# -- protobuf wire format -----------------------------------------------------


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1  # a negative int64 as its two's complement
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _len_field(number: int, data: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(data)) + data


def _event(wall_time: float, step: int = 0, file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    out = b"\x09" + struct.pack("<d", wall_time)  # field 1, fixed64
    if step:
        out += b"\x10" + _varint(step)  # field 2, varint
    if file_version is not None:
        out += _len_field(3, file_version.encode())
    if summary is not None:
        out += _len_field(5, summary)
    return out


def _scalar_summary(tag: str, value: float) -> bytes:
    # tag: field 1, length-delimited; simple_value: field 2, fixed32
    value_msg = _len_field(1, tag.encode()) + b"\x15" + struct.pack("<f", value)
    return _len_field(1, value_msg)


def _fields(data: bytes):
    """(field number, value) of each field of one message: varints as
    ints, fixed64, fixed32 and length-delimited fields as their bytes."""
    pos = 0

    def varint():
        nonlocal pos
        shift = v = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7

    while pos < len(data):
        key = varint()
        number, wire = key >> 3, key & 7
        if wire == 0:
            value = varint()
        elif wire in (1, 5):
            size = 8 if wire == 1 else 4
            value, pos = data[pos:pos + size], pos + size
        elif wire == 2:
            size = varint()
            value, pos = data[pos:pos + size], pos + size
        else:
            raise ValueError(f"protobuf wire type {wire} is not read here")
        if pos > len(data):
            raise ValueError("truncated protobuf message")
        yield number, value


# -- writer and reader --------------------------------------------------------


class EventFileWriter:
    """Scalars appended to a new event file in ``log_dir``, named as
    TensorBoard names them (``events.out.tfevents.<time>.<host>.<pid>.<n>``).
    Records are buffered and written every FLUSH_SECS (as SummaryWriter's
    default), on ``flush()``, on ``close()`` and when the process exits."""

    FLUSH_SECS = 120.0
    _count = 0  # writers opened by this process: the name's last part

    def __init__(self, log_dir):
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / (f"events.out.tfevents.{int(time.time()):010d}."
                               f"{socket.gethostname()}.{os.getpid()}.{EventFileWriter._count}")
        EventFileWriter._count += 1
        self._file = open(self.path, "wb")
        self._flushed = time.monotonic()
        self._file.write(_record(_event(time.time(), file_version="brain.Event:2")))
        self.flush()
        atexit.register(self.close)

    def add_scalar(self, tag: str, value, step: int) -> None:
        """One Event with ``value`` (a float32 ``simple_value``) under
        ``tag`` at ``step``."""
        self._file.write(_record(_event(time.time(), int(step),
                                        summary=_scalar_summary(tag, float(value)))))
        if time.monotonic() - self._flushed >= self.FLUSH_SECS:
            self.flush()

    def flush(self) -> None:
        self._file.flush()
        self._flushed = time.monotonic()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()
        atexit.unregister(self.close)


def _read_records(path: Path):
    data = path.read_bytes()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"{path}: truncated record header at byte {pos}")
        head = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", head)
        (head_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        if head_crc != masked_crc32c(head):
            raise ValueError(f"{path}: bad length checksum at byte {pos}")
        start, end = pos + 12, pos + 12 + length
        if end + 4 > len(data):
            raise ValueError(f"{path}: truncated record at byte {pos}")
        payload = data[start:end]
        (crc,) = struct.unpack("<I", data[end:end + 4])
        if crc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad payload checksum at byte {pos}")
        yield payload
        pos = end + 4


def read_scalars(path_or_dir) -> dict[str, list[tuple[int, float]]]:
    """{tag: [(step, value), ...]} of the scalar events of one event file,
    or of the event files directly in a directory (in name order), each
    record's two checksums checked."""
    path = Path(path_or_dir)
    files = sorted(path.glob("events.out.tfevents.*")) if path.is_dir() else [path]
    out: dict[str, list[tuple[int, float]]] = {}
    for f in files:
        for payload in _read_records(f):
            step, summary = 0, None
            for number, value in _fields(payload):
                if number == 2:
                    step = value - (1 << 64) if value >= 1 << 63 else value
                elif number == 5:
                    summary = value
            if summary is None:
                continue
            for number, value_msg in _fields(summary):
                if number != 1:
                    continue
                tag, scalar = None, None
                for n, v in _fields(value_msg):
                    if n == 1:
                        tag = bytes(v).decode()
                    elif n == 2:
                        (scalar,) = struct.unpack("<f", v)
                if tag is not None and scalar is not None:
                    out.setdefault(tag, []).append((step, scalar))
    return out
