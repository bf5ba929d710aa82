"""Byte-buffer helpers of the port's host-side container layer (its own copy
of cpprcoder_tpu/core/bytesutil.py's `as_u8`, `ByteWriter`,
`CorruptContainerError` and `ByteReader`).

Containers are whole u8 arrays with explicit offsets, so the host only needs
tiny header pack/unpack helpers.
"""

from __future__ import annotations

import struct

import numpy as np


def as_u8(data) -> np.ndarray:
    """View input (bytes / bytearray / ndarray) as a 1-D uint8 numpy array."""
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise TypeError(f"expected uint8 array, got {data.dtype}")
        return data.reshape(-1)
    return np.frombuffer(bytes(data), dtype=np.uint8)


class ByteWriter:
    """Small append-only header builder."""

    def __init__(self):
        self._parts: list[bytes] = []

    def u8(self, v: int) -> "ByteWriter":
        self._parts.append(struct.pack("<B", v))
        return self

    def u32(self, v: int) -> "ByteWriter":
        self._parts.append(struct.pack("<I", v))
        return self

    def u16s(self, arr) -> "ByteWriter":
        self._parts.append(np.asarray(arr, dtype="<u2").tobytes())
        return self

    def u32s(self, arr) -> "ByteWriter":
        self._parts.append(np.asarray(arr, dtype="<u4").tobytes())
        return self

    def raw(self, b) -> "ByteWriter":
        self._parts.append(bytes(b) if not isinstance(b, bytes) else b)
        return self

    def getvalue(self) -> bytes:
        return b"".join(self._parts)


class CorruptContainerError(ValueError):
    """A container header or payload is malformed/truncated: a typed
    exception, so callers can tell bad input from bugs."""


class ByteReader:
    """Sequential header reader over a bytes-like object. Every read is
    bounds-checked and raises CorruptContainerError on underrun."""

    def __init__(self, buf, pos: int = 0):
        self.buf = memoryview(bytes(buf) if isinstance(buf, bytearray) else buf)
        self.pos = pos

    def _need(self, count: int):
        if count < 0 or self.pos + count > len(self.buf):
            raise CorruptContainerError(
                f"container truncated: need {count} bytes at offset "
                f"{self.pos}, have {len(self.buf) - self.pos}")

    def u8(self) -> int:
        self._need(1)
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def u32(self) -> int:
        self._need(4)
        v = struct.unpack_from("<I", self.buf, self.pos)[0]
        self.pos += 4
        return v

    def u16s(self, count: int) -> np.ndarray:
        self._need(2 * count)
        v = np.frombuffer(self.buf, dtype="<u2", count=count, offset=self.pos)
        self.pos += 2 * count
        return v.astype(np.uint32)

    def u32s(self, count: int) -> np.ndarray:
        self._need(4 * count)
        v = np.frombuffer(self.buf, dtype="<u4", count=count, offset=self.pos)
        self.pos += 4 * count
        return v.astype(np.uint32)

    def raw(self, count: int) -> np.ndarray:
        self._need(count)
        v = np.frombuffer(self.buf, dtype=np.uint8, count=count, offset=self.pos)
        self.pos += count
        return v

    def rest(self) -> np.ndarray:
        v = np.frombuffer(self.buf, dtype=np.uint8, offset=self.pos)
        self.pos = len(self.buf)
        return v
