"""Kernel B wrapper: event grid -> per-lane payload rows.

Replaces cpprcoder_tpu/ops/expand_pallas.py:55 `_kernel` (wrapper
`materialize_rows_pallas`, same contract). The kernel is
`csrc/expand.cu`: one thread per lane walks its events, a first pass
counts the lane sizes, the host picks the row width, and a second pass
stores the bytes directly. It is bound by memory traffic (the event grid
read twice, the rows written once); unlike the Pallas kernel it has no
cap on E + l2. The plain version is `compaction.materialize_rows_t`.

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


def _launch(events_t: torch.Tensor, l2: int | None, may_drop):
    global launches
    e, k = events_t.shape
    dev = events_t.device
    md = compaction._drop_mask(may_drop, k, dev).to(torch.uint8).contiguous()
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sizes = torch.empty(k, dtype=torch.int32, device=dev)
        build.check(lib.ct_expand_sizes(events_t.data_ptr(), md.data_ptr(),
                                        sizes.data_ptr(), e, k, stream),
                    "ct_expand_sizes")
        max_size = int(sizes.max())
        if l2 is None:
            l2 = compaction.row_width(max_size)
        elif l2 < max_size:
            raise ValueError(f"l2={l2} < largest lane payload {max_size}")
        rows = torch.empty((k, l2), dtype=torch.uint8, device=dev)
        build.check(lib.ct_expand_rows(events_t.data_ptr(), md.data_ptr(),
                                       rows.data_ptr(), e, k, l2, stream),
                    "ct_expand_rows")
    launches += 1
    return rows, sizes
