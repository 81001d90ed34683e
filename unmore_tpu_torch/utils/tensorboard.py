"""Dependency-free TensorBoard scalar event writer (copy of the JAX package's
``utils/tensorboard.py``, pure Python).

The reference flushes training scalars through detectron2's
``TensorboardXWriter`` every 20 iterations
(``cad/engine/defaults.py:243-262``). This needs no tensorboard package:
it implements the on-disk format directly, which is small and stable, a
TFRecord stream of serialized ``Event`` protos,

  record := len(uint64 LE) | masked_crc32c(len) | data | masked_crc32c(data)

with hand-encoded protos (only varint/fixed64/length-delimited fields
are needed for scalar summaries). Readable by standard TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ----------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------- minimal protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3) + _varint(value)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _field_bytes(num: int, data: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(data)) + data


def _scalar_event(step: int, tag: str, value: float, wall_time: float) -> bytes:
    # Summary.Value { tag=1: string, simple_value=2: float }
    sval = _field_bytes(1, tag.encode()) + _field_float(2, value)
    summary = _field_bytes(1, sval)  # Summary { value=1: repeated Value }
    # Event { wall_time=1: double, step=2: int64, summary=5: Summary }
    return _field_double(1, wall_time) + _field_varint(2, step) + _field_bytes(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3: string }
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class EventWriter:
    """Append-only ``events.out.tfevents.*`` scalar writer."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._f = open(os.path.join(log_dir, fname), "ab")
        self._record(_file_version_event(time.time()))

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._record(_scalar_event(step, tag, float(value), time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
