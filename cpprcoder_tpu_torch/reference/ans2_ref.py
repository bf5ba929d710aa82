"""Oracle (host, exact) implementation of CT-ANS2 (FORMATS.md; the port's own
copy of cpprcoder_tpu/reference/ans2_ref.py).

Adaptive interleaved rANS — beyond the reference, which has only a static
rANS (cppans.h). Classic adaptive rANS is encode-hostile (the model runs
forward, rANS encodes backward); CT-ANS2 resolves it TPU-style with a
*deferred-summation* model: symbol counts accumulate every step, but the
coding table is a snapshot renormalized to total 2^14 only at window
boundaries (every 2^refresh_log2 steps). Consequences:

  - decode stays division-free (slot = x & 0x3FFF, like CT-ANS1);
  - encode is two passes: a forward pass derives the (input-only) snapshot
    sequence, then the usual backward interleaved coding pass uses them;
  - no frequency header at all — the decoder rebuilds every snapshot from
    already-decoded symbols, like the adaptive range coder (CT-RC2).

Model spec (encoder and decoder must match exactly):
  counts init all-1 (total 256). Snapshot boundaries: step 0, every
  power-of-two step below R = 2^refresh_log2 (doubling warmup — only step 0
  is ever coded with the uniform init table), then every multiple of R.
  At each boundary: if total ≥ 2^limit_log2: counts = (counts>>1)|1,
  total = sum; snapshot = normalize_freqs(counts, 14) (the CT
  largest-remainder spec). After coding step t's K symbols:
  counts[s] += inc each, total += inc·K_act.

Container:
  u32 raw_size, u8 lane_desc, u8 inc, u8 limit_log2, u8 refresh_log2,
  -- if raw_size == 0: end
  K × u32 states, u32 n_words, n_words × u16 (decoder read order)
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.config import ANS_LOW, ANS_PROB_BITS, pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.models.static_table import exclusive_cumsum, normalize_freqs

ANS2_INC_DEFAULT = 8
ANS2_LIMIT_LOG2_DEFAULT = 18


def default_refresh_log2(k: int, n: int) -> int:
    """~64 model windows per stream (scale-invariant warmup overhead: only
    window 0 is coded with the uniform init table), capped at ~2^16 symbols
    per window so huge streams still adapt locally."""
    steps = max(1, -(-n // k))
    r = max(0, (steps - 1).bit_length() - 6)
    cap = max(0, 16 - (k.bit_length() - 1))
    return min(r, cap)


def _lane_desc(k: int) -> int:
    return k.bit_length() - 1


def is_boundary(t: int, r_steps: int) -> bool:
    if t < r_steps:
        return t == 0 or (t & (t - 1)) == 0
    return t % r_steps == 0


def snapshot_index(t: int, r_steps: int) -> int:
    """Index of the snapshot governing step t (warmup + main windows)."""
    n_warm = r_steps.bit_length()  # log2(R) + 1 warmup snapshots
    if t < r_steps:
        return 0 if t == 0 else t.bit_length()  # t in [2^(i-1), 2^i) → i
    return n_warm + (t // r_steps - 1)


def _snapshots_and_counts(x2d: np.ndarray, n: int, k: int, inc: int,
                          limit: int, r_steps: int):
    """Forward model pass: per-window (freq, cum) snapshots."""
    steps = x2d.shape[0]
    counts = np.ones(256, dtype=np.int64)
    total = 256
    snaps = []
    for t in range(steps):
        if is_boundary(t, r_steps):
            if total >= limit:
                counts = (counts >> 1) | 1
                total = int(counts.sum())
            f = normalize_freqs(counts, ANS_PROB_BITS)
            snaps.append((f, exclusive_cumsum(f)))
        active = min(k, n - t * k)
        hist = np.bincount(x2d[t, :active], minlength=256)
        counts = counts + hist.astype(np.int64) * inc
        total += active * inc
    return snaps


def ans2_encode(data, lanes: int | None = None, inc: int = ANS2_INC_DEFAULT,
                limit_log2: int = ANS2_LIMIT_LOG2_DEFAULT,
                refresh_log2: int | None = None) -> bytes:
    x = as_u8(data)
    n = len(x)
    k = lanes or pick_lanes(n)
    r_log2 = (refresh_log2 if refresh_log2 is not None
              else default_refresh_log2(k, n))
    w = (ByteWriter().u32(n).u8(_lane_desc(k)).u8(inc).u8(limit_log2)
         .u8(r_log2))
    if n == 0:
        return w.getvalue()
    steps = (n + k - 1) // k
    x2d = np.zeros(steps * k, np.uint8)
    x2d[:n] = x
    x2d = x2d.reshape(steps, k)
    r_steps = 1 << r_log2
    snaps = _snapshots_and_counts(x2d, n, k, inc, 1 << limit_log2, r_steps)

    states = [ANS_LOW] * k
    emitted: list[int] = []  # encoder order (reverse of decoder read order)
    for t in range(steps - 1, -1, -1):
        freqs, cums = snaps[snapshot_index(t, r_steps)]
        active = min(k, n - t * k)
        for j in range(active - 1, -1, -1):
            s = int(x2d[t, j])
            f = int(freqs[s])
            c = int(cums[s])
            st = states[j]
            if st >= (f << 18):
                emitted.append(st & 0xFFFF)
                st >>= 16
            states[j] = ((st // f) << ANS_PROB_BITS) | ((st % f) + c)
    words = emitted[::-1]
    w.u32s(states)
    w.u32(len(words))
    w.u16s(words)
    return w.getvalue()


def ans2_decode(blob) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    k = 1 << r.u8()
    inc = r.u8()
    limit = 1 << r.u8()
    r_steps = 1 << r.u8()
    if n == 0:
        return b""
    states = [int(v) for v in r.u32s(k)]
    n_words = r.u32()
    words = r.u16s(n_words)
    steps = (n + k - 1) // k
    counts = np.ones(256, dtype=np.int64)
    total = 256
    out = np.zeros(steps * k, np.uint8)
    pos = 0
    mask = (1 << ANS_PROB_BITS) - 1
    freqs = cums = None
    for t in range(steps):
        if is_boundary(t, r_steps):
            if total >= limit:
                counts = (counts >> 1) | 1
                total = int(counts.sum())
            freqs = normalize_freqs(counts, ANS_PROB_BITS)
            cums = exclusive_cumsum(freqs)
            cum2sym = np.repeat(np.arange(256, dtype=np.uint8), freqs)
        active = min(k, n - t * k)
        for j in range(active):
            st = states[j]
            slot = st & mask
            s = int(cum2sym[slot])
            out[t * k + j] = s
            st = int(freqs[s]) * (st >> ANS_PROB_BITS) + slot - int(cums[s])
            if st < ANS_LOW:
                w16 = int(words[pos]) if pos < n_words else 0
                pos += 1
                st = (st << 16) | w16
            states[j] = st
        hist = np.bincount(out[t * k: t * k + active], minlength=256)
        counts = counts + hist.astype(np.int64) * inc
        total += active * inc
    return out[:n].tobytes()
