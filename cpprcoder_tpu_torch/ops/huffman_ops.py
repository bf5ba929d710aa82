"""CT-HUF1 container path in PyTorch (counterpart of
cpprcoder_tpu/ops/huffman_ops.py and of the wrapper code of
huffman_pallas.huffman_encode_pallas / huffman_decode_pallas).

Format: reference/huffman_ref.py. Lane i codes x[j*K + i] at step j with
one static canonical code of at most 15 bits a symbol, LSB-first into a
per-lane bit accumulator that emits a u16 word per 16 bits. The histogram
is `torch.bincount` on the device; its 256 counts go to the host for
package-merge (models/huffman.py), and the 256-entry (length, code) table
goes back to the device (one synchronisation per encode, as for rANS).

`encode_stream_plain` and `decode_symbols_plain` are the plain versions of
kernels H and I (ops/huffman_kernels.py). The encode one is the step loop
`encode_events_plain` over int64 lane vectors, whose events have kernel
F's layout (bit 16 emit, bits 15:0 the word), then the compaction
`lane_stream` (`rans_ops.lane_words`, each lane's flush word appended as
one more step), its words packed into the payload buffer kernel H writes.
Decode reads rANS's word rows. `huffman_encode`/`huffman_decode` build
containers around the kernel wrappers, so the same code runs the kernels
on a CUDA device and the plain versions on the CPU.

A window that no code matches (only an incomplete code, i.e. a
single-symbol table, or a corrupt container, can give one) decodes as
length 16 and rank 0: symbol perm[0], 16 bits consumed. Kernel I does the
same, so the two agree on any word rows.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.config import HUF_MAX_BITS, MASK32, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.huffman import (
    build_canonical_decode_tables,
    build_encoder_table,
)
from cpprcoder_tpu_torch.ops import layout, rans_ops
from cpprcoder_tpu_torch.ops.rc_common import i32_to_u32, u32_to_i32
from cpprcoder_tpu_torch.reference.huffman_ref import (
    _lane_desc,
    pack_nibbles,
    unpack_nibbles,
)

EMIT = rans_ops.EMIT
NO_CODE = HUF_MAX_BITS + 1    # the length of a window no code matches


def encoder_table(x: torch.Tensor):
    """x [n] uint8 on its device -> (code lengths u8 [256] numpy, the
    kernels' table int32 [2, 256] on x's device: row 0 the lengths, row 1
    the LSB-first codes)."""
    counts = torch.bincount(x, minlength=256).cpu().numpy()
    lengths, codes = build_encoder_table(counts)
    tab = np.stack([lengths, codes]).astype(np.int32)
    return lengths, torch.from_numpy(tab).to(x.device)


def decoder_tables(lengths: np.ndarray, device):
    """Code lengths [256] -> the canonical decode tables (limits [16],
    bases [16], perm [256]), int32 holding u32 bits, on `device`."""
    return tuple(torch.from_numpy(t.astype(np.uint32).view(np.int32).copy())
                 .to(device)
                 for t in build_canonical_decode_tables(lengths, HUF_MAX_BITS))


# ------------------------------------------------------------------ encode

def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                        tab: torch.Tensor):
    """Plain version of kernel H: x2d [stride, K] uint8 -> (events
    [stride, K] int32, flush [K] int32, bit counts [K] int32). An active
    step ORs its code into the accumulator at bit nb; when nb reaches 16
    its event is EMIT | the low word, which leaves the accumulator.
    Inactive steps are 0; flush is EMIT | the last partial word, or 0."""
    stride, k = x2d.shape
    dev = x2d.device
    lens_t, codes_t = tab.to(torch.int64)
    xs = x2d.to(torch.int64)
    steps = lane_len.to(torch.int64)
    acc = torch.zeros(k, dtype=torch.int64, device=dev)
    nb = torch.zeros_like(acc)
    bits = torch.zeros_like(acc)
    events = torch.zeros((stride, k), dtype=torch.int64, device=dev)
    for j in range(stride):
        active = j < steps
        l = torch.where(active, lens_t[xs[j]], 0)
        acc = acc | (torch.where(active, codes_t[xs[j]], 0) << nb)
        nb = nb + l
        bits = bits + l
        emit = nb >= 16
        events[j] = torch.where(active, torch.where(emit, EMIT, 0)
                                | (acc & 0xFFFF), 0)
        acc = torch.where(emit, acc >> 16, acc)
        nb = torch.where(emit, nb - 16, nb)
    flush = torch.where(nb > 0, EMIT | (acc & 0xFFFF), 0)
    return (events.to(torch.int32), flush.to(torch.int32),
            bits.to(torch.int32))


def lane_stream(ev: torch.Tensor, flush: torch.Tensor):
    """Kernel H's outputs -> (words [P] int32, counts [K]): each lane's
    emitted words in step order, then its flush word, lane after lane (the
    lane-major order of the container)."""
    return rans_ops.lane_words(torch.cat([ev, flush[None]]))


def payload_words(stride: int, k: int) -> int:
    """u32 words of the payload buffer for K lanes of `stride` steps: the
    u16 words of codes of at most 15 bits, ceil(15 * stride * K / 16) + K
    (a lane's last word may be partial), in pairs."""
    return -(-(-(-15 * stride * k // 16) + k) // 2)


def encode_stream_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                        tab: torch.Tensor):
    """Plain version of kernel H, the same outputs as
    huffman_kernels.encode_stream: (payload int32 [payload_words(stride,
    K)], counts [K] int32, bits [K] int32). A length is taken in 0..15 and
    a code to its length, as the kernel takes them (the tables that
    encoder_table builds are unchanged); then encode_events_plain, the
    compaction lane_stream, and the u16 words two to a u32 word."""
    stride, k = x2d.shape
    lens = tab[0].clamp(0, HUF_MAX_BITS)
    codes = tab[1] & ((torch.ones_like(lens) << lens) - 1)
    ev, flush, bits = encode_events_plain(x2d, lane_len,
                                          torch.stack([lens, codes]))
    words, counts = lane_stream(ev, flush)
    return pack_words(words, payload_words(stride, k)), counts.to(
        torch.int32), bits


def pack_words(words: torch.Tensor, n_words: int) -> torch.Tensor:
    """u16 words [P] int32 -> the payload buffer, int32 [n_words]: word 2m
    in bits 15:0 of u32 m, word 2m + 1 in bits 31:16, zero past P."""
    w16 = torch.zeros(2 * n_words, dtype=torch.int64, device=words.device)
    w16[:words.numel()] = words
    return u32_to_i32(w16[0::2] | w16[1::2] << 16)


def stream_words(payload: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Kernel H's payload and word counts -> the u16 words [P] int32, lane
    after lane (what lane_stream gives)."""
    p = int(counts.to(torch.int64).sum())
    return payload.view(torch.int16)[:p].to(torch.int32) & 0xFFFF


def assemble(n: int, k: int, lengths: np.ndarray, bits: np.ndarray,
             payload: np.ndarray) -> bytes:
    """CT-HUF1 container: u32 n, lane_desc, the 128-byte nibble-packed code
    lengths, K u32 bit counts, then the payload bytes (each lane's u16
    words, lane after lane)."""
    w = ByteWriter().u32(n).u8(_lane_desc(k))
    w.raw(pack_nibbles(lengths).tobytes())
    w.u32s(bits)
    w.raw(payload.tobytes())
    return w.getvalue()


def huffman_encode(data, lanes: int | None = None, *, device) -> bytes:
    """CT-HUF1 container of `data`, coded on `device` (kernels on CUDA,
    plain versions on the CPU). Same parameters as
    huffman_ref.huffman_encode. The bit counts come to the host (the
    header needs them; they give the payload's size), then the payload's
    bytes, once."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    if n == 0:
        return ByteWriter().u32(0).u8(_lane_desc(k)).getvalue()
    from cpprcoder_tpu_torch.ops import huffman_kernels

    stride = -(-n // k)
    xt = torch.from_numpy(x.copy()).to(device)
    lengths, tab = encoder_table(xt)
    payload, _, bits = huffman_kernels.encode_stream(
        layout.pad2d_interleaved(xt, k, stride),
        layout.lane_lengths_interleaved(n, k, stride, xt.device), tab)
    bits = bits.cpu().numpy()
    p = int(((bits.astype(np.int64) + 15) // 16).sum())
    return assemble(n, k, lengths, bits,
                    payload.view(torch.uint8)[:2 * p].cpu().numpy())


# ------------------------------------------------------------------ decode

def reverse15(v: torch.Tensor) -> torch.Tensor:
    """The low 15 bits of v, bit-reversed (the LSB-first window read as an
    MSB-first code)."""
    r = v & 0x7FFF
    r = ((r & 0x5555) << 1) | ((r >> 1) & 0x5555)
    r = ((r & 0x3333) << 2) | ((r >> 2) & 0x3333)
    r = ((r & 0x0F0F) << 4) | ((r >> 4) & 0x0F0F)
    return (((r & 0x00FF) << 8) | (r >> 8)) >> 1


def decode_symbols_plain(rows: torch.Tensor, lane_len: torch.Tensor,
                         limits: torch.Tensor, bases: torch.Tensor,
                         perm: torch.Tensor, n: int,
                         stride: int) -> torch.Tensor:
    """Plain version of kernel I: word rows [l2, K] int32 (u16 words,
    word-major, zero past each lane's count) -> uint8 [n]. Per step, every
    lane with at most 16 bits queued takes the next word (0 past l2); the
    code length is the first l in 1..15 with r < limits[l] (limits do not
    decrease, so that is 16 minus their count), NO_CODE if none; the
    symbol is perm[clamp((r >> (15 - l)) - bases[l], 0, 255)], or perm[0]
    for NO_CODE; active lanes consume l bits."""
    l2, k = rows.shape
    dev = rows.device
    w = rows.to(torch.int64)
    lim = i32_to_u32(limits)[1:]
    bas = i32_to_u32(bases)
    pm = perm.to(torch.int64)
    lanes = torch.arange(k, device=dev)
    steps = lane_len.to(torch.int64)
    win = torch.zeros(k, dtype=torch.int64, device=dev)
    nb = torch.zeros_like(win)
    wcur = torch.zeros_like(win)
    out = torch.zeros((stride, k), dtype=torch.uint8, device=dev)
    for j in range(stride):
        need = nb <= 16
        word = w[torch.clamp(wcur, max=max(l2 - 1, 0)), lanes] if l2 else 0
        word = torch.where(need & (wcur < l2), word, 0)
        win = win | (word << nb)
        nb = torch.where(need, nb + 16, nb)
        wcur = wcur + need.to(torch.int64)
        r = reverse15(win)
        l = NO_CODE - (r[:, None] < lim[None, :]).sum(dim=1)
        lc = torch.clamp(l, max=HUF_MAX_BITS)
        rank = ((r >> (HUF_MAX_BITS - lc)) - bas[lc]) & MASK32
        rank = torch.where(rank >= 1 << 31, rank - (1 << 32), rank)
        rank = torch.where(l == NO_CODE, 0, torch.clamp(rank, 0, 255))
        consumed = torch.where(j < steps, l, 0)
        win = win >> consumed
        nb = nb - consumed
        out[j] = pm[rank].to(torch.uint8)
    return out.reshape(-1)[:n]


def read_container(blob):
    """-> (n, k, lengths, bit counts, word counts, words) as numpy arrays,
    or None for n = 0. A truncated container raises
    CorruptContainerError."""
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    if n == 0:
        return None
    lengths = unpack_nibbles(r.raw(128))
    bits = r.u32s(k).astype(np.int64)
    counts = (bits + 15) // 16
    words = r.u16s(int(counts.sum()))
    return n, k, lengths, bits, counts, words


def huffman_decode(blob, *, device) -> bytes:
    parts = read_container(blob)
    if parts is None:
        return b""
    n, k, lengths, _, counts, words = parts
    from cpprcoder_tpu_torch.ops import huffman_kernels

    stride = -(-n // k)
    dev = torch.device(device)
    out = huffman_kernels.decode_symbols(
        rans_ops.word_rows(torch.from_numpy(words.astype(np.int32)).to(dev),
                           torch.from_numpy(counts).to(dev)),
        layout.lane_lengths_interleaved(n, k, stride, dev),
        *decoder_tables(lengths, dev), n, stride)
    return out.cpu().numpy().tobytes()
