"""Kernel W, X and Y wrappers: CT-ANS2 (the adaptive interleaved rANS) on
the card.

The JAX package has no Pallas kernel here: it runs the encode as three
passes in one jit (cpprcoder_tpu/ops/ans2_ops.py:86 `_encode_fn`: pass A
the model windows, `:99-137`, a scan at `:126`; pass B each position's
(f, c) by one-hot products, `:139-151`; pass C the coder's scan,
`:153-177`) and the decode as scans over windows and steps (`:183`
`_decode_fn`, scans `:220`, `:236`).

W (`csrc/ans2_encode.cu`; second round) is pass A in three launches
chained by programmatic dependent launch: each (window, tile)'s histogram
row over the card (no memset, no global atomic), the rescale walk over
the windows in one CTA (the rows staged by bulk copies, nothing on its
chain from global memory), then a warp a window for the normalize
(`csrc/ans2_model.cuh`, exact to models/static_table.normalize_freqs by a
sort of packed keys), which writes the tables as the entries X reads:
(reciprocal, f | c << 16), the table's (f, c) exactly. X (the same file;
second round) is pass C with pass B folded in: kernel F's coder, a thread
a lane in CTAs of 128, walking the steps backwards. Lanes move in step, so
each CTA stages the current window's entries (reciprocal, f | c << 16) in
shared memory, the next window's loaded during the current one (one
barrier a window); a step's entry is one shared read at its run's start.
The first 16 steps (every step at refresh_log2 < 4, where windows are
shorter than a run of 16) read their entries from global memory a run
ahead, one 8-byte load each. Y (`csrc/ans2_decode.cu`, second round)
is one CTA a stream: at each window start every thread joins for the
histogram, warp 0 for the rescale and the shared normalize, every thread
again for a 2^14-byte cum2sym in shared memory;
the steps run on one warp up to 32 lanes (no CTA barrier), else a thread a
lane up to 1,024 (then 1,024 threads), their states in registers up to 8
lanes a thread; each step a prefix count of the refilling lanes over the
stepping threads (a thread owns a contiguous run of lanes, so lane order
is thread order), the refill words read from a ring in shared memory that
one thread fills ahead by bulk copies, and shared atomics for the model's
update.

Their plain versions are `ans2_ops.window_tables_plain`,
`ans2_ops.encode_events_plain` and `ans2_ops.decode_symbols_plain`
(`normalize_tables` is the normalize alone, for tests). On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises. Every power of two up to 65,536 lanes.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import ans2_ops, layout

model_launches = 0    # kernel W
encode_launches = 0   # kernel X
decode_launches = 0   # kernel Y

MAX_LANES = 1 << 16
# W's histogram rows: a CTA a tile of TILE positions, a window's tiles in at
# most MAX_ROWS rows (csrc/ans2_encode.cu TILE, MAX_ROWS)
TILE = 4096
MAX_ROWS = 32
# Y keeps its lanes' states in registers or shared memory up to this many
# lanes, in global scratch above (csrc/ans2_decode.cu SHARED_STATE_LANES)
SHARED_STATE_LANES = 1 << 14


def _check_k(k: int):
    if k < 1 or k & (k - 1) or k > MAX_LANES:
        raise ValueError(f"kernels W, X and Y take a power of two up to "
                         f"{MAX_LANES} lanes, got {k}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def model_scratch(n: int, k: int, steps: int, r: int, n_snap: int):
    """-> (rows, bytes): W's histogram rows a window (the longest window's
    tiles, at most MAX_ROWS) and its scratch bytes (the counts, u64
    [n_snap, 256], then the rows, u32 [n_snap, rows, 256])."""
    longest = min(steps, 1 << r) * k
    rows = max(1, min(MAX_ROWS, -(-longest // TILE)))
    return rows, n_snap * 256 * 8 + n_snap * rows * 256 * 4


def normalize_tables(counts: torch.Tensor) -> torch.Tensor:
    """counts [B, 256] int64 (each >= 0) -> the entries int64 [B, 256]
    (`ans2_ops.table_entries`) of each row's normalize_freqs(row, 14), by
    the device function W and Y share (a warp a row)."""
    if counts.dtype != torch.int64 or counts.dim() != 2 \
            or counts.shape[1] != 256 or not counts.is_contiguous():
        raise ValueError(f"counts must be contiguous int64 [B, 256], got "
                         f"{counts.dtype} {tuple(counts.shape)}")
    if counts.device.type == "cpu":
        return ans2_ops.normalize_tables_plain(counts)
    dev = counts.device
    lib = build.load()
    with torch.cuda.device(dev):
        entries = torch.empty(counts.shape, dtype=torch.int64, device=dev)
        if counts.shape[0]:
            rc = lib.ct_ans2_normalize(counts.data_ptr(), entries.data_ptr(),
                                       counts.shape[0], _stream(dev))
            build.check(rc, "ct_ans2_normalize")
    return entries


def model_launch(x2d: torch.Tensor, n: int, inc: int, limit_log2: int,
                 r: int, n_snap: int, lib) -> torch.Tensor:
    """Kernel W's launch through `lib` (build.load(), or another build of
    the sources), r the effective refresh_log2: -> entries int64 [n_snap,
    256]."""
    steps, k = x2d.shape
    dev = x2d.device
    rows, nbytes = model_scratch(n, k, steps, r, n_snap)
    with torch.cuda.device(dev):
        entries = torch.empty((n_snap, 256), dtype=torch.int64, device=dev)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        rc = lib.ct_ans2_model(
            x2d.data_ptr(), scratch.data_ptr(), entries.data_ptr(), n, k,
            steps, inc, min(limit_log2, ans2_ops.LIMIT_LOG2_NEVER), r, n_snap,
            rows, _stream(dev))
        build.check(rc, "ct_ans2_model")
    return entries


def window_tables(x2d: torch.Tensor, n: int, inc: int, limit_log2: int,
                  refresh_log2: int) -> torch.Tensor:
    """x2d [steps, K] uint8 (interleaved, zero past n) -> the entries int64
    [n_snap, 256] (`ans2_ops.table_entries`: what X reads;
    `ans2_ops.entry_tables` gives back (f, c)), window w's table in row
    w."""
    global model_launches
    steps, k = x2d.shape
    if x2d.dtype != torch.uint8 or x2d.dim() != 2 \
            or not x2d.is_contiguous():
        raise ValueError(f"x2d must be a contiguous 2-D uint8 tensor, got "
                         f"{x2d.dtype} {tuple(x2d.shape)}")
    if not (k * (steps - 1) < n <= k * steps):
        raise ValueError(f"n={n} is not {steps} steps of {k} lanes")
    ans2_ops.check_params(inc, limit_log2, refresh_log2)
    if x2d.device.type == "cpu":
        return ans2_ops.window_tables_plain(x2d, n, inc, limit_log2,
                                            refresh_log2)
    _check_k(k)
    r = ans2_ops.refresh_eff(refresh_log2, steps)
    entries = model_launch(x2d, n, inc, limit_log2, r,
                           ans2_ops.n_snapshots(steps, r), build.load())
    model_launches += 1
    return entries


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor,
                  entries: torch.Tensor, refresh_log2: int):
    """x2d [steps, K] uint8 (interleaved) and W's entries int64 [n_snap,
    256] -> (events [steps, K] int32: bit 16 emit, bits 15:0 the state's
    low word, 0 where inactive; final states [K] int32 holding u32
    bits)."""
    global encode_launches
    layout.check_lanes("x2d", x2d, torch.uint8, lane_len, MAX_LANES)
    if entries.dtype != torch.int64 or entries.dim() != 2 \
            or entries.shape[1] != 256 or not entries.is_contiguous() \
            or entries.device != x2d.device:
        raise ValueError(f"entries must be contiguous int64 [n_snap, 256] on "
                         f"{x2d.device}, got {entries.dtype} "
                         f"{tuple(entries.shape)}")
    steps, k = x2d.shape
    r = ans2_ops.refresh_eff(refresh_log2, steps)
    if entries.shape[0] != (ans2_ops.n_snapshots(steps, r) if steps else 0):
        raise ValueError(f"{entries.shape[0]} tables for {steps} steps at "
                         f"refresh_log2 {refresh_log2}")
    if x2d.device.type == "cpu":
        return ans2_ops.encode_events_plain(x2d, lane_len, entries,
                                            refresh_log2)
    _check_k(k)
    dev = x2d.device
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((steps, k), dtype=torch.int32, device=dev)
        states = torch.empty(k, dtype=torch.int32, device=dev)
        rc = lib.ct_ans2_encode(
            x2d.data_ptr(), lane_len.data_ptr(), entries.data_ptr(),
            ev.data_ptr(), states.data_ptr(), k, steps, r, _stream(dev))
        build.check(rc, "ct_ans2_encode")
    encode_launches += 1
    return ev, states


def decode_symbols(words: torch.Tensor, states: torch.Tensor, n: int,
                   inc: int, limit_log2: int,
                   refresh_log2: int) -> torch.Tensor:
    """words [n_words] int16 (u16 bits, the decoder's read order), states
    [K] int32 (u32 bits) -> uint8 [n] (byte t*K + j is lane j's step t)."""
    global decode_launches
    if words.dtype != torch.int16 or words.dim() != 1 \
            or not words.is_contiguous():
        raise ValueError(f"words must be a contiguous int16 vector, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if states.dtype != torch.int32 or states.dim() != 1 \
            or not states.is_contiguous() or states.device != words.device:
        raise ValueError(f"states must be an int32 vector on "
                         f"{words.device}, got {states.dtype} "
                         f"{tuple(states.shape)}")
    k = states.numel()
    if k < 1 or not 0 < n < 1 << 32:
        raise ValueError(f"n={n} bytes over {k} lanes")
    ans2_ops.check_params(inc, limit_log2, refresh_log2)
    if words.device.type == "cpu":
        return ans2_ops.decode_symbols_plain(words, states, n, inc,
                                             limit_log2, refresh_log2)
    _check_k(k)
    steps = -(-n // k)
    dev = words.device
    lib = build.load()
    if words.data_ptr() % 16:
        words = words.clone()     # the kernel's bulk copies read 16 bytes aligned
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        scratch = (torch.empty(k, dtype=torch.int32, device=dev)
                   if k > SHARED_STATE_LANES else None)
        rc = lib.ct_ans2_decode(
            words.data_ptr(), words.numel(), states.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            n, k, steps, inc, min(limit_log2, ans2_ops.LIMIT_LOG2_NEVER),
            ans2_ops.refresh_eff(refresh_log2, steps), _stream(dev))
        build.check(rc, "ct_ans2_decode")
    decode_launches += 1
    return out
