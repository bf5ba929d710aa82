"""Kernel B wrapper: event grid -> per-lane payload rows.

Replaces cpprcoder_tpu/ops/expand_pallas.py:55 `_kernel` (wrapper
`materialize_rows_pallas`, same contract). The kernel is `csrc/expand.cu`,
two launches a call: a first pass counts the lane sizes and the largest
of them (`count_sizes`), the host reads that one number back and picks the
row width, and a second pass writes the rows (`write_rows`): a block a
group of 16 lanes, a warp reading its lane's events in place, scanning 32
of them at a time and storing along the lane's row. It is bound by
memory traffic (the event grid read twice, the rows written once); unlike
the Pallas kernel it has no cap on E + l2. The plain version is
`compaction.materialize_rows_t`.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import compaction

launches = 0   # kernel B launches (its two passes count as one)


def materialize_rows(events_t: torch.Tensor, l2: int | None = None,
                     may_drop=True):
    """events_t [E, K] int32 -> (rows [K, l2] uint8, sizes [K] int32).

    l2=None picks compaction.row_width(largest lane); a given l2 must
    hold every lane. may_drop: True, False, or a [K] bool mask."""
    if events_t.dtype != torch.int32 or events_t.dim() != 2 \
            or not events_t.is_contiguous():
        raise ValueError(f"events must be a contiguous 2-D int32 tensor, "
                         f"got {events_t.dtype} {tuple(events_t.shape)}")
    if events_t.device.type == "cpu":
        return compaction.materialize_rows_t(events_t, l2, may_drop)
    if events_t.device.type != "cuda":
        raise ValueError(f"unsupported device {events_t.device}")
    return _launch(events_t, l2, may_drop)


def drop_mask(may_drop, k: int, device):
    """-> (mask uint8 [K] on device, or None for a bool; drop_all: the
    bool as 0/1), as the kernel's passes take may_drop."""
    if isinstance(may_drop, bool):
        return None, int(may_drop)
    return compaction._drop_mask(may_drop, k, device).to(
        torch.uint8).contiguous(), 0


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _stream(dev, stream):
    return torch.cuda.current_stream(dev).cuda_stream if stream is None else stream


def count_sizes(events_t: torch.Tensor, md: torch.Tensor | None,
                drop_all: int, lib=None, stream=None):
    """Pass 1 on the card: -> (sizes [K] int32, top [1] int64: the largest
    size), both left on the card. lib: the kernel library (default: the
    package's build); stream: the CUDA stream (default: the current one)."""
    e, k = events_t.shape
    dev = events_t.device
    sizes = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(1, dtype=torch.int64, device=dev)
    build.check((lib or build.load()).ct_expand_count(
        events_t.data_ptr(), _ptr(md), drop_all, sizes.data_ptr(),
        top.data_ptr(), e, k, _stream(dev, stream)), "ct_expand_count")
    return sizes, top


def write_rows(events_t: torch.Tensor, md: torch.Tensor | None,
               drop_all: int, l2: int, lib=None, stream=None) -> torch.Tensor:
    """Pass 2 on the card: -> rows [K, l2] uint8 (l2 at least every lane's
    size)."""
    e, k = events_t.shape
    dev = events_t.device
    rows = torch.empty((k, l2), dtype=torch.uint8, device=dev)
    build.check((lib or build.load()).ct_expand_write(
        events_t.data_ptr(), _ptr(md), drop_all, rows.data_ptr(), e, k, l2,
        _stream(dev, stream)), "ct_expand_write")
    return rows


def _launch(events_t: torch.Tensor, l2: int | None, may_drop, lib=None):
    global launches
    dev = events_t.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        md, drop_all = drop_mask(may_drop, events_t.shape[1], dev)
        sizes, top = count_sizes(events_t, md, drop_all, lib, stream)
        max_size = int(top)     # the host round trip that picks l2
        if l2 is None:
            l2 = compaction.row_width(max_size)
        elif l2 < max_size:
            raise ValueError(f"l2={l2} < largest lane payload {max_size}")
        rows = write_rows(events_t, md, drop_all, l2, lib, stream)
    launches += 1
    return rows, sizes
