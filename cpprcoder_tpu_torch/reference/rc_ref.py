"""The scalar range-coder lane and the lane-descriptor and size-table helpers
shared by the port's CT-RCX and CT-RCQ oracles (its own copy of the parts of
cpprcoder_tpu/reference/rc_ref.py it uses).

LZMA-style carry-delayed range coder: 32-bit low/range, renormalization at
2^24, carry through a cache byte plus a 0xFF run; flush rounds low up to a
multiple of 2^24 and shifts twice (FORMATS.md "Shared range-coder core").
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import MASK32, RC_TOP
from cpprcoder_tpu_torch.core.bytesutil import ByteWriter, CorruptContainerError


class LaneEncoder:
    """One range-coder lane (see FORMATS.md 'Shared range-coder core')."""

    def __init__(self):
        self.low = 0              # python int; bit 32 is the pending carry
        self.range = MASK32
        self.cache = 0
        self.cache_size = 1       # includes the initial dummy byte
        self.out = bytearray()

    def _shift_low(self):
        low32 = self.low & MASK32
        if low32 < 0xFF000000 or self.low > MASK32:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            if self.cache_size > 1:
                self.out.extend(((0xFF + carry) & 0xFF,) * (self.cache_size - 1))
            self.cache = (low32 >> 24) & 0xFF
            self.cache_size = 0
        self.cache_size += 1
        self.low = (low32 << 8) & MASK32

    def encode(self, cum: int, freq: int, total: int, t: int):
        self.low += t * cum
        if cum + freq == total:
            self.range -= t * cum
        else:
            self.range = t * freq
        while self.range < RC_TOP:
            self._shift_low()
            self.range = (self.range << 8) & MASK32

    def finish(self) -> bytes:
        # round the code value up to a multiple of 2^24 (valid: range >= 2^24)
        self.low += (-self.low) & 0xFFFFFF
        self._shift_low()
        self._shift_low()
        return bytes(self.out[1:])  # drop the initial dummy byte


class LaneDecoder:
    def __init__(self, payload: np.ndarray):
        self.data = payload
        self.pos = 0
        self.range = MASK32
        code = 0
        for _ in range(4):
            code = (code << 8) | self._next_byte()
        self.code = code

    def _next_byte(self) -> int:
        b = int(self.data[self.pos]) if self.pos < len(self.data) else 0
        self.pos += 1
        return b

    def consume(self, cum: int, freq: int, total: int, t: int):
        self.code -= t * cum
        if cum + freq == total:
            self.range -= t * cum
        else:
            self.range = t * freq
        while self.range < RC_TOP:
            self.code = ((self.code << 8) | self._next_byte()) & MASK32
            self.range = (self.range << 8) & MASK32


def _lane_desc(k: int, wide_sizes: bool) -> int:
    return (k.bit_length() - 1) | (0x80 if wide_sizes else 0)


def _parse_lane_desc(b: int) -> tuple[int, bool]:
    log2k = b & 0x1F
    if log2k > 16:
        raise CorruptContainerError(f"absurd lane count 2^{log2k}")
    return 1 << log2k, bool(b & 0x80)


def _write_sizes(w: ByteWriter, sizes: list[int], wide: bool):
    if wide:
        w.u32s(sizes)
    else:
        w.u16s(sizes)
