"""CT-ANS1 v2 container path in PyTorch (counterpart of
cpprcoder_tpu/ops/rans_ops.py, of the wrapper code of
rans_pallas.rans_encode_pallas / rans_decode_pallas and of
huffman_pallas._rows16_fn).

Format: reference/rans_ref.py. Lane i codes x[j*K + i] at
step j against one static table of 2^14 (freq, exclusive cum), the
counterpart of models/table_jax.py: the histogram is `torch.bincount` on
the device, and its 256 counts go to the host for the oracle's own
`normalize_freqs` / `exclusive_cumsum` (one synchronisation per call).

`encode_events_plain` and `decode_symbols_plain` are the plain versions of
kernels F and G (ops/rans_kernels.py): step loops over int64 lane vectors.
`rans_encode`/`rans_decode` build containers around the kernel wrappers,
so the same code runs the kernels on a CUDA device and the plain versions
on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.config import ANS_LOW, ANS_PROB_BITS, ANS_TOTAL, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models import freq_header
from cpprcoder_tpu_torch.models.static_table import exclusive_cumsum, normalize_freqs
from cpprcoder_tpu_torch.ops import layout
from cpprcoder_tpu_torch.ops.rc_common import i32_to_u32, u32_to_i32
from cpprcoder_tpu_torch.reference.rans_ref import _lane_desc, _parse_lane_desc

MASK = ANS_TOTAL - 1
EMIT = 1 << 16        # event bit: the step emitted its low word


def static_freqs(x: torch.Tensor) -> np.ndarray:
    """Histogram of x [n] uint8 on its device -> freqs uint32 [256] numpy,
    normalized to 2^14 on the host."""
    counts = torch.bincount(x, minlength=256).cpu().numpy()
    return normalize_freqs(counts, ANS_PROB_BITS)


def tables(freqs: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """freqs [256] -> the kernels' (freqs, exclusive cums), int32 [256] on
    `device`."""
    return tuple(torch.from_numpy(t.astype(np.int32)).to(device)
                 for t in (freqs, exclusive_cumsum(freqs)))


def lane_words(ev: torch.Tensor):
    """Encode events [stride, K] -> (words [P] int32, counts [K]): each
    lane's emitted u16 words in forward step order (its read order), lane
    after lane, and each lane's word count."""
    emit = (ev & EMIT) != 0
    return ev.T[emit.T] & 0xFFFF, emit.sum(dim=0)


def word_rows(words: torch.Tensor, counts: torch.Tensor,
              l2: int | None = None) -> torch.Tensor:
    """words [P] int32 lane after lane + counts [K] -> kernel G's word rows
    [l2, K] int32, word-major, zero past each lane's count (l2 defaults to
    the largest count + 1)."""
    if l2 is None:
        l2 = int(counts.max()) + 1
    return layout.lane_rows(words, counts, l2).T.contiguous()


# ------------------------------------------------------------------ encode

def encode_events_plain(x2d: torch.Tensor, lane_len: torch.Tensor,
                        freqs: torch.Tensor, cums: torch.Tensor):
    """Plain version of kernel F: x2d [stride, K] uint8 -> (events
    [stride, K] int32, final states [K] int32), walking j = stride-1 .. 0."""
    stride, k = x2d.shape
    f_t = freqs.to(torch.int64)
    c_t = cums.to(torch.int64)
    xs = x2d.to(torch.int64)
    lens = lane_len.to(torch.int64)
    st = torch.full((k,), ANS_LOW, dtype=torch.int64, device=x2d.device)
    events = torch.zeros((stride, k), dtype=torch.int64, device=x2d.device)
    for j in range(stride - 1, -1, -1):
        active = j < lens
        f = torch.where(active, f_t[xs[j]], 1)
        c = c_t[xs[j]]
        emit = active & ((st >> 18) >= f)     # wrap-free st >= f << 18
        events[j] = torch.where(active, torch.where(emit, EMIT, 0)
                                | (st & 0xFFFF), 0)
        st2 = torch.where(emit, st >> 16, st)
        q = st2 // f
        st = torch.where(active, (q << ANS_PROB_BITS) | (st2 - q * f + c), st)
    return u32_to_i32(events), u32_to_i32(st)


def assemble(n: int, k: int, freqs: np.ndarray, states: np.ndarray,
             counts: np.ndarray, words: np.ndarray) -> bytes:
    """CT-ANS1 v2 container: u32 n, lane_desc (bit 7 set when a lane's
    word count exceeds 0xFFFF), the packed freq table, K u32 final states,
    K word counts (u16, or u32 when wide), then each lane's u16 words in
    its read order, lane after lane."""
    wide = bool(counts.max() > 0xFFFF)
    w = ByteWriter().u32(n).u8(_lane_desc(k, wide))
    w.raw(freq_header.pack_freqs(freqs))
    w.u32s(states)
    w.u32s(counts) if wide else w.u16s(counts)
    w.u16s(words)
    return w.getvalue()


def rans_encode(data, lanes: int | None = None, *, device) -> bytes:
    """CT-ANS1 v2 container of `data`, coded on `device` (kernels on CUDA,
    plain versions on the CPU). Same parameters as rans_ref.rans_encode."""
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    if n == 0:
        return ByteWriter().u32(0).u8(_lane_desc(k)).getvalue()
    from cpprcoder_tpu_torch.ops import rans_kernels

    stride = -(-n // k)
    xt = torch.from_numpy(x.copy()).to(device)
    freqs = static_freqs(xt)
    ev, states = rans_kernels.encode_events(
        layout.pad2d_interleaved(xt, k, stride),
        layout.lane_lengths_interleaved(n, k, stride, xt.device),
        *tables(freqs, xt.device))
    words, counts = lane_words(ev)
    return assemble(n, k, freqs, i32_to_u32(states).cpu().numpy(),
                    counts.cpu().numpy(), words.cpu().numpy())


# ------------------------------------------------------------------ decode

def decode_symbols_plain(states: torch.Tensor, rows: torch.Tensor,
                         lane_len: torch.Tensor, freqs: torch.Tensor,
                         cums: torch.Tensor, n: int,
                         stride: int) -> torch.Tensor:
    """Plain version of kernel G: final states [K] int32 and word rows
    [l2, K] int32 (word-major, zero past each lane's count) -> uint8 [n]."""
    l2, k = rows.shape
    dev = rows.device
    f_t = freqs.to(torch.int64)
    c_t = cums.to(torch.int64)
    cum2sym = torch.repeat_interleave(torch.arange(256, device=dev), f_t)
    w = rows.to(torch.int64)
    lanes = torch.arange(k, device=dev)
    lens = lane_len.to(torch.int64)
    st = i32_to_u32(states)
    widx = torch.zeros(k, dtype=torch.int64, device=dev)
    out = torch.zeros((stride, k), dtype=torch.uint8, device=dev)
    for j in range(stride):
        active = j < lens
        slot = st & MASK
        s = cum2sym[slot]
        st2 = f_t[s] * (st >> ANS_PROB_BITS) + slot - c_t[s]
        need = active & (st2 < ANS_LOW)
        word = w[torch.clamp(widx, max=max(l2 - 1, 0)), lanes] if l2 else 0
        word = torch.where(widx < l2, word, 0)
        st = torch.where(active, torch.where(need, (st2 << 16) | word, st2),
                         st)
        widx = widx + need.to(torch.int64)
        out[j] = s.to(torch.uint8)
    return out.reshape(-1)[:n]


def read_container(blob):
    """Inverse of `assemble`: -> (n, k, freqs, states, counts, words) as
    numpy arrays, or None for n = 0. A truncated container raises
    CorruptContainerError; a freq table that does not sum to 2^14 raises
    ValueError."""
    r = ByteReader(blob)
    n = r.u32()
    k, wide = _parse_lane_desc(r.u8())
    if n == 0:
        return None
    freqs = freq_header.read_freqs(r, ANS_TOTAL)
    states = r.u32s(k)
    counts = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    words = r.u16s(int(counts.sum()))
    return n, k, freqs, states, counts, words


def rans_decode(blob, *, device) -> bytes:
    parts = read_container(blob)
    if parts is None:
        return b""
    n, k, freqs, states, counts, words = parts
    from cpprcoder_tpu_torch.ops import rans_kernels

    stride = -(-n // k)
    dev = torch.device(device)
    out = rans_kernels.decode_symbols(
        u32_to_i32(torch.from_numpy(states.astype(np.int64))).to(dev),
        word_rows(torch.from_numpy(words.astype(np.int32)).to(dev),
                  torch.from_numpy(counts).to(dev)),
        layout.lane_lengths_interleaved(n, k, stride, dev),
        *tables(freqs, dev), n, stride)
    return out.cpu().numpy().tobytes()
