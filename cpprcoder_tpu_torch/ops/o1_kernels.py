"""Kernel U and V wrappers: CT-RC3 (the order-1 blended range coder) encode
and decode on the card.

The JAX package has no Pallas kernel here: it runs each direction as one
compiled `lax.scan` (cpprcoder_tpu/ops/o1_ops.py:132 `_encode_fn`, scan
:156; :169 `_decode_fn`, scan :209), reading the model's rows by one-hot
matrix products on the TPU's matrix unit. On Hopper the rows are read by
direct index. Kernel U (`csrc/o1_encode.cu`) encodes, kernel V
(`csrc/o1_decode.cu`) decodes; both share `csrc/o1_model.cuh`.

All K lanes share the model and update it every step, so a stream runs in
one CTA (256 to 1,024 threads; lanes past 1,024 are taken in turn by each
thread, their coder state in global scratch). The model lives in shared
memory: t1 as u16 pairs (128 KiB) where its counts stay below 2^16
(`o1_ops.table_wide` false), else as u32 in global memory (L2-resident);
beside it, per row 16 block sums of 16 counts (u32) and the row total, and
t0 with its block sums and total. U's step is three phases between
barriers: the rescale (every row checked; a warp a row that has reached
its limit: halve, rebuild its block sums and total), the coding (a lane
reads its row's prefix as block sums then counts, about 30 reads, and
divides range by tot_eff), and the update (shared-memory atomics, whose
sum does not depend on the lanes' order). V (second round) runs the same
phases, its rows checked interleaved over the warps, its symbol found by
counts of compares (prefix trees, not a chain), each lane's next word
loaded a refill ahead; past 1,024 lanes its atomics are grouped a warp by
`__match_any_sync`.

Their plain versions are `o1_ops.encode_events_plain` and
`o1_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises. Both take
every power of two up to 65,536 lanes and raise ValueError outside C8's
bound (`o1_ops.check_params`).
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import layout, o1_ops

encode_launches = 0   # kernel U
decode_launches = 0   # kernel V

MAX_LANES = 1 << 16
CTA_LANES = 1024      # lanes a CTA codes one a thread; more take turns


def _check(name, t, dtype, lane_len, params):
    layout.check_lanes(name, t, dtype, lane_len, MAX_LANES)
    k = t.shape[1]
    if k & (k - 1) or k > MAX_LANES:
        raise ValueError(f"kernels U and V take a power of two up to "
                         f"{MAX_LANES} lanes, got {k}")
    o1_ops.check_params(k, *params)


def _scratch(k: int, wide: bool, state_words: int, dev):
    """-> (t1 in global memory, or None; the lanes' coder state past
    CTA_LANES, or None)."""
    t1 = torch.empty(256 * 256, dtype=torch.int32, device=dev) \
        if wide else None
    st = torch.empty(state_words * k, dtype=torch.int32, device=dev) \
        if k > CTA_LANES else None
    return t1, st


def _ptr(t):
    return None if t is None else t.data_ptr()


def encode_events(x2d: torch.Tensor, lane_len: torch.Tensor, inc: int,
                  limit1_log2: int, limit0_log2: int,
                  blend_log2: int) -> torch.Tensor:
    """x2d [L, K] uint8 (chunked lanes: x2d[j, i] = x[i*L + j]) -> events
    [3*L + 2, K] int32 (u32 bits, rc_common's format)."""
    global encode_launches
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    _check("x2d", x2d, torch.uint8, lane_len, params)
    if x2d.device.type == "cpu":
        return o1_ops.encode_events_plain(x2d, lane_len, *params)
    steps, k = x2d.shape
    dev = x2d.device
    wide = o1_ops.table_wide(k, inc, limit1_log2)
    lib = build.load()
    with torch.cuda.device(dev):
        ev = torch.empty((o1_ops.N_SLOTS * steps + 2, k), dtype=torch.int32,
                         device=dev)
        t1, st = _scratch(k, wide, 5, dev)
        rc = lib.ct_o1_encode(
            x2d.data_ptr(), lane_len.data_ptr(), ev.data_ptr(), _ptr(t1),
            _ptr(st), k, steps, *params, int(wide),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_o1_encode")
    encode_launches += 1
    return ev


def decode_symbols(words: torch.Tensor, lane_len: torch.Tensor, n: int,
                   steps: int, inc: int, limit1_log2: int, limit0_log2: int,
                   blend_log2: int) -> torch.Tensor:
    """words [l4, K] int32 big-endian u32 word rows (word-major, l4 >= 1)
    -> the n decoded bytes, uint8 [n] (byte i*L + j is lane i's step j,
    L = steps)."""
    global decode_launches
    params = (inc, limit1_log2, limit0_log2, blend_log2)
    _check("words", words, torch.int32, lane_len, params)
    l4, k = words.shape
    if l4 < 1 or not 0 <= n <= k * steps:
        raise ValueError(f"n={n} does not fit {k} lanes of {steps} steps, "
                         f"or no word rows ({l4})")
    if words.device.type == "cpu":
        return o1_ops.decode_symbols_plain(words, lane_len, n, steps, *params)
    dev = words.device
    wide = o1_ops.table_wide(k, inc, limit1_log2)
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        t1, st = _scratch(k, wide, 7, dev)
        rc = lib.ct_o1_decode(
            words.data_ptr(), lane_len.data_ptr(), out.data_ptr(), _ptr(t1),
            _ptr(st), k, l4, steps, *params, int(wide),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_o1_decode")
    decode_launches += 1
    return out
