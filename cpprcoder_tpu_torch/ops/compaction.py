"""Event grid -> per-lane payload bytes, in plain PyTorch (counterpart of
cpprcoder_tpu/ops/compaction.py `event_fields`, `payload_layout_t`,
`materialize_rows_t`, `rows_to_be_words`).

Events are a time-major [E, K] int32 grid of packed u32 events
(ops/rc_common.py). Per lane, emitting events tile the lane's byte stream:
each writes its first byte, then run_len run bytes. The lane's first
emitted byte (the coder's dummy) is dropped where `may_drop` holds.

The plain version is a per-lane cumsum followed by direct indexed writes;
it is also the plain counterpart of expansion kernel B (ops/expand.py).
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.ops.rc_common import EV_RUN_MASK, i32_to_u32, u32_to_i32


def event_fields(events: torch.Tensor):
    """int32 events -> (emit bool, first, run_byte, run_len) int64."""
    ev = i32_to_u32(events)
    emit = (ev >> 31) > 0
    first = (ev >> 23) & 0xFF
    run_byte = torch.where(((ev >> 22) & 1) > 0, 0, 0xFF)
    run_len = ev & EV_RUN_MASK
    return emit, first, run_byte, run_len


def _drop_mask(may_drop, k: int, device) -> torch.Tensor:
    if isinstance(may_drop, bool):
        return torch.full((k,), may_drop, dtype=torch.bool, device=device)
    md = torch.as_tensor(may_drop, device=device).to(torch.bool)
    if md.shape != (k,):
        raise ValueError(f"may_drop must be a bool or a [{k}] mask, "
                         f"got shape {tuple(md.shape)}")
    return md


def payload_layout_t(events_t: torch.Tensor, may_drop=True):
    """events_t [E, K] -> (pcnt, pin, dropped [E, K], lane_sizes [K]).

    pcnt: payload bytes of each event; pin: each event's start offset
    within its lane's payload (per-lane exclusive cumsum of pcnt)."""
    emit, _, _, run_len = event_fields(events_t)
    cnt = torch.where(emit, 1 + run_len, 0)
    prior = torch.cumsum(cnt, dim=0) - cnt
    md = _drop_mask(may_drop, events_t.shape[1], events_t.device)
    dropped = emit & (prior == 0) & md[None, :]
    pcnt = cnt - dropped.to(torch.int64)
    pin = torch.cumsum(pcnt, dim=0) - pcnt
    return pcnt, pin, dropped, pcnt.sum(dim=0)


def row_width(max_size: int) -> int:
    """Smallest multiple of 4 (at least 4) holding max_size bytes."""
    return max(4, -(-max_size // 4) * 4)


def materialize_rows_t(events_t: torch.Tensor, l2: int | None = None,
                       may_drop=True):
    """Padded per-lane payload rows: (rows [K, l2] uint8, sizes [K] int32).

    Row i holds lane i's payload bytes 0..sizes[i] (zero beyond). l2=None
    picks row_width(largest lane); a given l2 must hold every lane."""
    _, first, run_byte, _ = event_fields(events_t)
    pcnt, pin, dropped, sizes = payload_layout_t(events_t, may_drop)
    k = events_t.shape[1]
    max_size = int(sizes.max()) if k else 0
    if l2 is None:
        l2 = row_width(max_size)
    elif max_size > l2:
        raise ValueError(f"l2={l2} < largest lane payload {max_size}")
    # lane-major event order, so the flat byte stream is lane after lane
    pcnt_f = pcnt.T.reshape(-1)
    owner = torch.repeat_interleave(
        torch.arange(pcnt_f.numel(), device=events_t.device), pcnt_f)
    start = torch.cumsum(pcnt_f, 0) - pcnt_f
    off = torch.arange(owner.numel(), device=events_t.device) - start[owner]
    is_first = (off == 0) & ~dropped.T.reshape(-1)[owner]
    byte = torch.where(is_first, first.T.reshape(-1)[owner],
                       run_byte.T.reshape(-1)[owner])
    lane = owner // events_t.shape[0]
    pos = pin.T.reshape(-1)[owner] + off
    rows = torch.zeros((k, l2), dtype=torch.uint8, device=events_t.device)
    rows[lane, pos] = byte.to(torch.uint8)
    return rows, sizes.to(torch.int32)


def rows_to_be_words(rows: torch.Tensor) -> torch.Tensor:
    """[K, L] uint8 byte rows (L % 4 == 0) -> [K, L/4] int32 big-endian
    u32 words (the decoder's input layout)."""
    r = rows.to(torch.int64)
    w = (r[:, 0::4] << 24) | (r[:, 1::4] << 16) | (r[:, 2::4] << 8) \
        | r[:, 3::4]
    return u32_to_i32(w)
