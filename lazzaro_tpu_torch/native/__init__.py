"""The port's native host runtime: the CRC-framed write-ahead log.

Counterpart of the WAL part of ``lazzaro_tpu/native``. ``WriteAheadLog``
runs the C++ of ``csrc/wal.cc`` (built by ``build.py`` with ``g++`` at first
use) over ``ctypes``. Each record is framed ``<u32 magic 0x4C5A5731, u32
length, u32 crc32(payload)> payload``, little-endian, one ``write`` per
record, so a crash mid-append leaves at most one torn tail record, which
replay drops. ``frame`` and ``unframe`` are the same framing in plain Python:
the tests hold the native log's bytes and its replay against them.
"""

from __future__ import annotations

import ctypes
import os
import struct
import zlib
from typing import List

import numpy as np

from lazzaro_tpu_torch.native.build import load

MAGIC = 0x4C5A5731


def frame(payload: bytes) -> bytes:
    """One record as the log stores it (the plain version of an append)."""
    return struct.pack("<III", MAGIC, len(payload), zlib.crc32(payload)) + payload


def unframe(raw: bytes) -> List[bytes]:
    """The payloads of a log's bytes up to the first torn or foreign record
    (the plain version of a replay)."""
    records, pos = [], 0
    while pos + 12 <= len(raw):
        magic, ln, crc = struct.unpack_from("<III", raw, pos)
        if magic != MAGIC or pos + 12 + ln > len(raw):
            break
        payload = raw[pos + 12:pos + 12 + ln]
        if zlib.crc32(payload) != crc:
            break
        records.append(payload)
        pos += 12 + ln
    return records


class WriteAheadLog:
    """Append-only CRC-framed journal at ``path``. ``fsync`` makes each
    append durable (``fdatasync``) before it returns. Payloads are opaque
    bytes."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._lib = load()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    def append(self, payload: bytes) -> None:
        buf = np.frombuffer(payload or b"\0", np.uint8).copy()
        rc = self._lib.lz_wal_append(
            self.path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(payload), 1 if self.fsync else 0)
        if rc != 0:
            raise OSError(f"WAL append failed (rc={rc}) for {self.path}")

    def replay(self) -> List[bytes]:
        """Every intact record, in order; a torn tail is dropped."""
        out_len = ctypes.c_int64()
        ptr = self._lib.lz_wal_load(self.path.encode(), ctypes.byref(out_len))
        if not ptr or out_len.value <= 0:
            if ptr:
                self._lib.lz_free(ptr)
            return []
        raw = ctypes.string_at(ptr, out_len.value)
        self._lib.lz_free(ptr)
        records, pos = [], 0
        while pos + 4 <= len(raw):
            ln = int.from_bytes(raw[pos:pos + 4], "little")
            records.append(raw[pos + 4:pos + 4 + ln])
            pos += 4 + ln
        return records

    def reset(self) -> None:
        """Truncate the log."""
        rc = self._lib.lz_wal_reset(self.path.encode())
        if rc != 0:
            raise OSError(f"WAL reset failed (rc={rc}) for {self.path}")
