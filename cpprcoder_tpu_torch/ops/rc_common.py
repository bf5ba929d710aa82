"""K-lane range-coder primitives in plain PyTorch (counterpart of
cpprcoder_tpu/ops/rc_common.py).

All lane state lives in int64 tensors holding u32 values: CPU torch's
uint32 support is partial, and the carry test `new_low < low` needs 32-bit
wrap semantics, so every add, multiply and shift that can leave 32 bits is
masked with `& MASK32`. Each shift_low emits a packed u32 event:

    bit 31     emit flag
    bits 30:23 first emitted byte (cache + carry)
    bit 22     carry flag (run bytes are 0x00 if set, else 0xFF)
    bits 21:0  run length (cache_size - 1 trailing run bytes)
"""

from __future__ import annotations

import torch

from cpprcoder_tpu.config import MASK32, RC_TOP

EV_RUN_BITS = 22
EV_RUN_MASK = (1 << EV_RUN_BITS) - 1


def make_state(k: int, device=None):
    """(low, carry, range, cache, cache_size) int64 vectors for K lanes."""
    z = torch.zeros(k, dtype=torch.int64, device=device)
    return (z, z.clone(), torch.full_like(z, MASK32), z.clone(),
            torch.ones_like(z))


def _shift_low(st):
    """One vectorized shift_low; returns (state, packed event)."""
    low, carry, rng, cache, csize = st
    cond = (low < 0xFF000000) | (carry > 0)
    first = (cache + carry) & 0xFF
    ev = (1 << 31) | (first << 23) | ((carry & 1) << 22) \
        | ((csize - 1) & EV_RUN_MASK)
    ev = torch.where(cond, ev, 0)
    cache = torch.where(cond, low >> 24, cache)
    csize = torch.where(cond, 0, csize) + 1
    carry = torch.where(cond, 0, carry)
    low = (low << 8) & MASK32
    return (low, carry, rng, cache, csize), ev


def encode_symbol(st, t, cum, freq, is_top, active, n_slots: int):
    """Encode one symbol per lane; t/cum/freq int64 [K], is_top/active bool.

    Returns (state, events [n_slots, K] int64)."""
    low, carry, rng, cache, csize = st
    add = (t * cum) & MASK32
    new_low = (low + add) & MASK32
    carry2 = carry | (new_low < low).to(torch.int64)
    new_rng = torch.where(is_top, (rng - add) & MASK32, (t * freq) & MASK32)
    cur = (new_low, carry2, new_rng, cache, csize)
    evs = []
    for _ in range(n_slots):
        do = cur[2] < RC_TOP
        shifted, ev = _shift_low(cur)
        shifted = shifted[:2] + (((shifted[2] << 8) & MASK32),) + shifted[3:]
        cur = tuple(torch.where(do, s, c) for s, c in zip(shifted, cur))
        evs.append(torch.where(do, ev, 0))
    # inactive lanes keep their previous state and emit nothing
    out_st = tuple(torch.where(active, c, s) for c, s in zip(cur, st))
    events = torch.stack([torch.where(active, e, 0) for e in evs])
    return out_st, events


def flush(st):
    """Terminate all lanes: round low up to a multiple of 2^24 (valid since
    range >= 2^24) and shift_low twice. Returns events [2, K] int64."""
    low, carry, rng, cache, csize = st
    delta = (-low) & 0xFFFFFF
    new_low = (low + delta) & MASK32
    carry = carry | (new_low < low).to(torch.int64)
    st = (new_low, carry, rng, cache, csize)
    st, ev1 = _shift_low(st)
    st, ev2 = _shift_low(st)
    return torch.stack([ev1, ev2])


def u32_to_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 tensor of u32 values -> int32 tensor with the same 32 bits."""
    t = t & MASK32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def i32_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int32 tensor of u32 bit patterns -> int64 tensor of u32 values."""
    return t.to(torch.int64) & MASK32
