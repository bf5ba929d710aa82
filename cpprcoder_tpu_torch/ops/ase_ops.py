"""CT-ASE1 container path in PyTorch (counterpart of
cpprcoder_tpu/ops/ase_ops.py).

Format: reference/ase_ref.py. K interleaved lanes: lane i codes x[j*K + i]
at step j. Each lane keeps its own 64-entry recency table: a symbol found
at index idx of the table's first `size` entries is a hit at distance
d = size - 1 - idx from the back, written as (d << 1) | 1 in bits + 1 bits
(the old `bits`), and moves to the back; any other symbol is a literal,
sym << 1 in 9 bits, appended at the back (evicting entry 0 when the table
is full; only an append into a table that is not full sets bits to
ENTROPY[size + 1]). Bits go LSB-first into u16 words, at most one a
symbol; a lane's flush writes its partial word if it holds a bit.

Container: u32 n, u8 lane_desc (log2 K), K u32 bit counts, then each
lane's ceil(bits / 16) u16-LE words, lane after lane.

`encode_words_plain` and `decode_symbols_plain` are the plain versions of
kernels S and T (ops/ase_kernels.py): step loops over int64 lane vectors
with the tables as [K, 64] tensors, the update as the JAX package's
masked shift (`_update`). `ase_encode`/`ase_decode` build containers
around the kernel wrappers, so the same code runs the kernels on a CUDA
device and the plain versions on the CPU.

The decoder reads each lane's words up to the lane's end and zeros past
it, as the JAX package does (the oracle reads on into the next lane's
words; both give the same symbols on a valid container). A hit at a
distance past the table (only a corrupt container gives one) takes entry
0, clipped as the JAX package clips it.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.config import pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.ops import layout, rans_ops
from cpprcoder_tpu_torch.reference.ase_ref import ENTROPY, TABLE_SIZE, _lane_desc

LITERAL_BITS = 9      # the widest symbol: a literal


def words_cap(stride: int) -> int:
    """The most u16 words a lane of `stride` steps writes: 9 bits a symbol
    at most, its last word partial."""
    return -(-LITERAL_BITS * stride // 16)


def _update(table, size, sym, hit, idx0):
    """The JAX package's table update (ops/ase_ops.py `_update`): table
    [K, 64], size/sym/idx0 [K] int64, hit [K] bool -> (table, size). A hit
    moves entry idx0 to the back (entries idx0+1..size-1 shift down); a
    miss appends at `size`, or on a full table shifts every entry down and
    puts the symbol at 63."""
    j = torch.arange(TABLE_SIZE, device=table.device)[None, :]
    shifted = torch.roll(table, -1, dims=1)
    full = size >= TABLE_SIZE
    start = torch.where(hit, idx0, torch.where(full, 0, size))
    place = torch.where(hit, size - 1,
                        torch.where(full, TABLE_SIZE - 1, size))
    new = torch.where((j >= start[:, None]) & (j < place[:, None]), shifted,
                      table)
    new = torch.where(j == place[:, None], sym[:, None], new)
    return new, torch.where(hit | full, size, size + 1)


def _next_bits(bits, size, hit, entropy):
    """bits after a step: ENTROPY[size + 1] after a miss into a table that
    is not full, else unchanged."""
    return torch.where(hit | (size >= TABLE_SIZE), bits,
                       entropy[torch.clamp(size + 1, max=TABLE_SIZE)])


def encode_words_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                       stats: dict | None = None):
    """Plain version of kernel S: x2d [stride, K] uint8 (x2d[j, i] =
    x[j*K + i]) -> (payload int16 [K * words_cap(stride)]: the lanes' u16
    words lane after lane, zero past them; bits [K] int32, each lane's bit
    count). stats, if given, gets "table_ops" added: the table entries a
    scalar coder compares and moves, size for a hit or a miss plus 63
    for a miss into a full table, summed over the coded symbols."""
    stride, k = x2d.shape
    dev = x2d.device
    entropy = torch.from_numpy(ENTROPY).to(dev)
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    z = torch.zeros(k, dtype=torch.int64, device=dev)
    table = torch.zeros((k, TABLE_SIZE), dtype=torch.int64, device=dev)
    size, bits, acc, nb, count = z, z, z, z, z
    slot = torch.arange(TABLE_SIZE, device=dev)[None, :]
    events = torch.zeros((stride + 1, k), dtype=torch.int64, device=dev)
    work = z
    for j in range(stride):
        active = j < lens
        sym = xs[j]
        found = (table == sym[:, None]) & (slot < size[:, None])
        hit = found.any(dim=1)
        idx0 = found.to(torch.int64).argmax(dim=1)
        val = torch.where(hit, ((size - 1 - idx0) << 1) | 1, sym << 1)
        width = torch.where(hit, bits + 1, LITERAL_BITS)
        table2, size2 = _update(table, size, sym, hit, idx0)
        bits2 = _next_bits(bits, size, hit, entropy)
        acc2 = acc | (val << nb)
        nb2 = nb + width
        emit = nb2 >= 16
        events[j] = torch.where(active & emit, rans_ops.EMIT, 0) \
            | (acc2 & 0xFFFF)
        acc2 = torch.where(emit, acc2 >> 16, acc2)
        nb2 = torch.where(emit, nb2 - 16, nb2)
        if stats is not None:
            work = work + torch.where(active, size + torch.where(
                ~hit & (size >= TABLE_SIZE), TABLE_SIZE - 1, 0), 0)
        table = torch.where(active[:, None], table2, table)
        size, bits, acc, nb = (torch.where(active, a, b) for a, b in
                               ((size2, size), (bits2, bits), (acc2, acc),
                                (nb2, nb)))
        count = count + torch.where(active, width, 0)
    events[stride] = torch.where(nb > 0, rans_ops.EMIT, 0) | (acc & 0xFFFF)
    if stats is not None:
        stats["table_ops"] = stats.get("table_ops", 0) + int(work.sum())
    words, _ = rans_ops.lane_words(events)
    payload = torch.zeros(k * words_cap(stride), dtype=torch.int64,
                          device=dev)
    payload[:words.numel()] = words
    payload = torch.where(payload >= 1 << 15, payload - (1 << 16), payload)
    return payload.to(torch.int16), count.to(torch.int32)


def decode_symbols_plain(words: torch.Tensor, bases: torch.Tensor,
                         counts: torch.Tensor, lane_len: torch.Tensor,
                         n: int, stride: int) -> torch.Tensor:
    """Plain version of kernel T: words [P] int16 (the container's u16
    words), bases and counts [K] int32 (each lane's first word and word
    count) -> uint8 [n] (byte j*K + i is lane i's step j). Per step, a lane
    with at most 16 bits in its window takes its next word (0 past its
    end); the window's bit 0 tells a hit from a literal."""
    k = bases.numel()
    dev = words.device
    entropy = torch.from_numpy(ENTROPY).to(dev)
    w = words.to(torch.int64) & 0xFFFF
    p = w.numel()
    lens = lane_len.to(torch.int64)
    cur = bases.to(torch.int64)
    end = torch.clamp(cur + counts.to(torch.int64), max=p)
    lane = torch.arange(k, device=dev)
    z = torch.zeros(k, dtype=torch.int64, device=dev)
    table = torch.zeros((k, TABLE_SIZE), dtype=torch.int64, device=dev)
    size, bits, win, nb = z, z, z, z
    out = torch.zeros((stride, k), dtype=torch.uint8, device=dev)
    for j in range(stride):
        active = j < lens
        need = nb <= 16
        word = w[torch.clamp(cur, 0, max(p - 1, 0))] if p else z
        word = torch.where((cur >= 0) & (cur < end), word, 0)
        win = torch.where(need, win | (word << nb), win)
        nb = torch.where(need, nb + 16, nb)
        cur = cur + need.to(torch.int64)
        hit = (win & 1) == 1
        d = (win >> 1) & ((1 << bits) - 1)
        idx0 = torch.clamp(size - 1 - d, min=0)
        sym = torch.where(hit, table[lane, idx0], (win >> 1) & 0xFF)
        consumed = torch.where(active, torch.where(hit, 1 + bits,
                                                   LITERAL_BITS), 0)
        table2, size2 = _update(table, size, sym, hit, idx0)
        bits2 = _next_bits(bits, size, hit, entropy)
        table = torch.where(active[:, None], table2, table)
        size = torch.where(active, size2, size)
        bits = torch.where(active, bits2, bits)
        win = win >> consumed
        nb = nb - consumed
        out[j] = torch.where(active, sym, 0).to(torch.uint8)
    return out.reshape(-1)[:n]


# ------------------------------------------------------------ containers

def ase_encode(data, lanes: int | None = None, *, device) -> bytes:
    """CT-ASE1 container of `data`, coded on `device` (kernel S on CUDA,
    its plain version on the CPU). Same parameters as ase_ref.ase_encode.
    The bit counts come to the host (the header holds them, and they give
    the payload's size), then the payload's bytes, once."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    w = ByteWriter().u32(n).u8(_lane_desc(k))
    if n == 0:
        return w.getvalue()
    from cpprcoder_tpu_torch.ops import ase_kernels

    stride = -(-n // k)
    xt = torch.from_numpy(x.copy()).to(device)
    payload, bits = ase_kernels.encode_words(
        layout.pad2d_interleaved(xt, k, stride),
        layout.lane_lengths_interleaved(n, k, stride, xt.device))
    bits = bits.cpu().numpy()
    p = int(((bits.astype(np.int64) + 15) // 16).sum())
    w.u32s(bits)
    w.raw(payload[:p].view(torch.uint8).cpu().numpy().tobytes())
    return w.getvalue()


def ase_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    if n == 0:
        return b""
    from cpprcoder_tpu_torch.ops import ase_kernels

    bits = r.u32s(k).astype(np.int64)
    counts = (bits + 15) // 16
    words = r.u16s(int(counts.sum()))
    bases = np.cumsum(counts) - counts
    stride = -(-n // k)
    dev = torch.device(device)
    out = ase_kernels.decode_symbols(
        torch.from_numpy(words.astype(np.uint16).view(np.int16)).to(dev),
        torch.from_numpy(bases.astype(np.int32)).to(dev),
        torch.from_numpy(counts.astype(np.int32)).to(dev),
        layout.lane_lengths_interleaved(n, k, stride, dev), n, stride)
    return out.cpu().numpy().tobytes()
