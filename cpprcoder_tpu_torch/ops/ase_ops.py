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
masked shift (`_update`). The encoder's table is a function of the input
alone, which kernel S's design rests on; its plain formulations are
`segment_states_plain` (each segment's start table, the LRU composition
of the segments before it) and `stack_distance_plain` (each step's code
from the input), both packed by `pack_words_plain`. `ase_encode`/`ase_decode` build containers
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
# kernel S's segments: a call aims at SEG_TARGET of them, each at least
# SEG_MIN steps (fewer segments a lane keep pass 2's walk short), so that
# it has at most SEG_TARGET + K; MAX_SEGMENTS is the kernel's own bound
SEG_TARGET = 1 << 15
SEG_MIN = 32
MAX_SEGMENTS = 1 << 25
SEG_SCRATCH_WORDS = 44          # 32-bit scratch words a segment
LANE_SCRATCH_WORDS = (1 << 16) + 4   # the lanes' first words and the total


def words_cap(stride: int) -> int:
    """The most u16 words a lane of `stride` steps writes: 9 bits a symbol
    at most, its last word partial."""
    return -(-LITERAL_BITS * stride // 16)


def segment_steps(k: int, stride: int) -> int:
    """Kernel S's steps a segment at K lanes of `stride` steps: K * stride
    / SEG_TARGET, at least SEG_MIN, at most the stride (one segment a lane
    from K = SEG_TARGET lanes on). The segment count is then at most
    SEG_TARGET + K, so the scratch stays under 4 * (44 * (2^15 + 2^16) +
    2^16 + 4) bytes (17.6 MB) whatever n."""
    if stride <= 0:
        return 1
    return min(max(-(-k * stride // SEG_TARGET), SEG_MIN), stride)


def segment_scratch_words(k: int, stride: int, seg: int) -> int:
    """Kernel S's scratch in int32 words (csrc/ase.cu `seg_scratch`): 44 a
    segment (start table, own bytes, their set, counts, offsets) and the
    lanes' first words."""
    return SEG_SCRATCH_WORDS * k * -(-stride // seg) + LANE_SCRATCH_WORDS


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
    size, bits = z, z
    slot = torch.arange(TABLE_SIZE, device=dev)[None, :]
    val = torch.zeros((stride, k), dtype=torch.int64, device=dev)
    width = torch.zeros_like(val)
    work = z
    for j in range(stride):
        active = j < lens
        sym = xs[j]
        found = (table == sym[:, None]) & (slot < size[:, None])
        hit = found.any(dim=1)
        idx0 = found.to(torch.int64).argmax(dim=1)
        val[j] = torch.where(active, torch.where(
            hit, ((size - 1 - idx0) << 1) | 1, sym << 1), 0)
        width[j] = torch.where(active, torch.where(hit, bits + 1,
                                                   LITERAL_BITS), 0)
        table2, size2 = _update(table, size, sym, hit, idx0)
        bits2 = _next_bits(bits, size, hit, entropy)
        if stats is not None:
            work = work + torch.where(active, size + torch.where(
                ~hit & (size >= TABLE_SIZE), TABLE_SIZE - 1, 0), 0)
        table = torch.where(active[:, None], table2, table)
        size = torch.where(active, size2, size)
        bits = torch.where(active, bits2, bits)
    if stats is not None:
        stats["table_ops"] = stats.get("table_ops", 0) + int(work.sum())
    return pack_words_plain(val, width)


def _own_states(xs, valid):
    """One segment's state a lane: xs [L, K] int64 bytes, valid [L, K] ->
    (own [K, 64]: its distinct bytes newest first, -1 past them; ocnt [K]
    = min(distinct, 64); mask [K, 256] bool, the bytes it codes)."""
    steps, k = xs.shape
    dev = xs.device
    t = torch.arange(steps, device=dev)[:, None].expand(steps, k)
    last = torch.full((k, 256), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(1, xs.T, torch.where(valid, t, -1).T, "amax")
    mask = last >= 0
    order = torch.argsort(last, dim=1, descending=True, stable=True)
    ocnt = torch.clamp(mask.sum(dim=1), max=TABLE_SIZE)
    slot = torch.arange(TABLE_SIZE, device=dev)[None, :]
    own = torch.where(slot < ocnt[:, None], order[:, :TABLE_SIZE], -1)
    return own, ocnt, mask


def _compose(table, size, own, ocnt, mask):
    """The LRU composition kernel S's pass 2 runs a step: the state (table
    [K, 64] newest first, `size` entries) after a segment of own state
    (own, ocnt, mask) is its bytes newest first, then the state's entries
    that it does not code, cut at 64."""
    k = table.shape[0]
    dev = table.device
    slot = torch.arange(TABLE_SIZE, device=dev)[None, :]
    keep = (slot < size[:, None]) & ~mask.gather(1, table.clamp(min=0))
    pos = ocnt[:, None] + torch.cumsum(keep, dim=1) - keep.to(torch.int64)
    new = torch.cat([torch.where(slot < ocnt[:, None], own, -1),
                     torch.full((k, 1), -1, dtype=torch.int64, device=dev)],
                    dim=1)
    drop = torch.full_like(pos, TABLE_SIZE)
    new.scatter_(1, torch.where(keep & (pos < TABLE_SIZE), pos, drop),
                 torch.where(keep, table, -1))
    size = torch.clamp(ocnt + keep.sum(dim=1), max=TABLE_SIZE)
    return new[:, :TABLE_SIZE], size


def segment_states_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                         seg: int):
    """Plain version of kernel S's passes 1 and 2 at `seg` steps a
    segment: x2d [stride, K] uint8 -> (tables [nseg, K, 64] int64: each
    segment's start table in the JAX package's order, entry 0 the least
    recent, zero past its size; sizes [nseg, K]; bits [nseg, K], ENTROPY
    of the size). Each segment's own state (its distinct bytes newest
    first, at most 64, and their set) is composed over the lane's
    segments in order."""
    stride, k = x2d.shape
    dev = x2d.device
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    nseg = -(-stride // seg)
    slot = torch.arange(TABLE_SIZE, device=dev)[None, :]
    table = torch.full((k, TABLE_SIZE), -1, dtype=torch.int64, device=dev)
    size = torch.zeros(k, dtype=torch.int64, device=dev)
    tables, sizes = [], []
    for s in range(nseg):
        lo, hi = s * seg, min((s + 1) * seg, stride)
        # newest first -> the JAX package's order: entry size-1-p is p
        idx = torch.clamp(size[:, None] - 1 - slot, min=0)
        tables.append(torch.where(slot < size[:, None],
                                  table.gather(1, idx), 0))
        sizes.append(size)
        t = torch.arange(lo, hi, device=dev)[:, None]
        table, size = _compose(table, size, *_own_states(xs[lo:hi],
                                                         t < lens[None, :]))
    entropy = torch.from_numpy(ENTROPY).to(dev)
    sizes = torch.stack(sizes) if nseg else torch.zeros((0, k), dtype=torch.int64)
    tables = torch.stack(tables) if nseg else torch.zeros((0, k, TABLE_SIZE),
                                                          dtype=torch.int64)
    return tables, sizes, entropy[sizes]


def stack_distance_plain(x2d: torch.Tensor, lane_len: torch.Tensor):
    """Each step's code from the input alone: x2d [stride, K] uint8 ->
    (val, width) int64 [stride, K], 0 where the lane is inactive. For lane
    i at step t, with p its last step that coded the same byte (or -1), D
    the distinct bytes it coded at steps p+1..t-1 and N those at steps
    0..t-1: a hit iff p >= 0 and D < 64, (D << 1) | 1 in ENTROPY[min(N,
    64)] + 1 bits; else sym << 1 in 9 bits."""
    stride, k = x2d.shape
    dev = x2d.device
    entropy = torch.from_numpy(ENTROPY).to(dev)
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    lane = torch.arange(k, device=dev)
    last = torch.full((k, 256), -1, dtype=torch.int64, device=dev)
    val = torch.zeros((stride, k), dtype=torch.int64, device=dev)
    width = torch.zeros_like(val)
    for t in range(stride):
        sym = xs[t]
        p = last[lane, sym]
        d = (last > p[:, None]).sum(dim=1)
        n = (last >= 0).sum(dim=1)
        hit = (p >= 0) & (d < TABLE_SIZE)
        active = t < lens
        val[t] = torch.where(active, torch.where(hit, (d << 1) | 1, sym << 1),
                             0)
        width[t] = torch.where(active, torch.where(
            hit, entropy[torch.clamp(n, max=TABLE_SIZE)] + 1, LITERAL_BITS), 0)
        last[lane, sym] = torch.where(active, t, p)
    return val, width


def pack_words_plain(val: torch.Tensor, width: torch.Tensor):
    """Codes (val, width) [stride, K], width 0 where a lane is inactive ->
    encode_words_plain's (payload, bits): each lane's codes LSB-first into
    u16 words, its partial last word flushed, lane after lane."""
    stride, k = val.shape
    dev = val.device
    z = torch.zeros(k, dtype=torch.int64, device=dev)
    acc, nb = z, z
    events = torch.zeros((stride + 1, k), dtype=torch.int64, device=dev)
    for j in range(stride):
        acc = acc | (val[j] << nb)
        nb = nb + width[j]
        emit = nb >= 16
        events[j] = torch.where(emit, rans_ops.EMIT, 0) | (acc & 0xFFFF)
        acc = torch.where(emit, acc >> 16, acc)
        nb = torch.where(emit, nb - 16, nb)
    events[stride] = torch.where(nb > 0, rans_ops.EMIT, 0) | (acc & 0xFFFF)
    words, _ = rans_ops.lane_words(events)
    payload = torch.zeros(k * words_cap(stride), dtype=torch.int64,
                          device=dev)
    payload[:words.numel()] = words
    payload = torch.where(payload >= 1 << 15, payload - (1 << 16), payload)
    return payload.to(torch.int16), width.sum(dim=0).to(torch.int32)


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
