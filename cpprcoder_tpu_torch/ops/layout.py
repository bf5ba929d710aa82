"""Lane layouts, lane rows and the lane-payload container pieces that the
port's codecs share (CT-RCX, CT-RCQ, CT-ANS1 v2); `word_rows` is the
counterpart of cpprcoder_tpu/ops/rcq_ops.py `_rows_fn`.

A stream of n bytes is coded by K lanes over stride = ceil(n/K) steps, in
one of two layouts:
  * chunked (CT-RCX): lane i owns bytes x[i*stride:(i+1)*stride];
  * interleaved (CT-RCQ, rANS): lane i codes x[j*K + i] at step j.
Either way the coder kernels take x2d [stride, K] uint8 and the number of
steps each lane codes, lane_len [K] int32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
)
from cpprcoder_tpu_torch.ops import compaction
from cpprcoder_tpu_torch.reference.rc_ref import _write_sizes


def pad2d_chunked(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x [n] uint8 -> x2d [stride, k] with x2d[j, i] = x[i*stride + j]
    (zero past the end)."""
    buf = torch.zeros(k * stride, dtype=torch.uint8, device=x.device)
    buf[: x.numel()] = x
    return buf.view(k, stride).T.contiguous()


def lane_lengths(n: int, k: int, stride: int, device) -> torch.Tensor:
    """Bytes each lane codes: clip(n - i*stride, 0, stride), int32 [k]."""
    lanes = torch.arange(k, dtype=torch.int64, device=device)
    return torch.clamp(n - lanes * stride, 0, stride).to(torch.int32)


def pad2d_interleaved(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x [n] uint8 -> x2d [stride, k] with x2d[j, i] = x[j*k + i] (zero
    past the end): the zero-padded input viewed as rows, no transpose."""
    buf = torch.zeros(k * stride, dtype=torch.uint8, device=x.device)
    buf[: x.numel()] = x
    return buf.view(stride, k)


def lane_lengths_interleaved(n: int, k: int, stride: int,
                             device) -> torch.Tensor:
    """Steps each interleaved lane codes: clip(ceil((n - i) / k), 0,
    stride), int32 [k]; lane i is active at step j iff j*k + i < n."""
    lanes = torch.arange(k, dtype=torch.int64, device=device)
    return torch.clamp((n - lanes + k - 1) // k, 0, stride).to(torch.int32)


def check_lanes(name: str, t: torch.Tensor, dtype, lane_len: torch.Tensor,
                max_lanes: int) -> None:
    """Raise ValueError unless t is a contiguous 2-D `dtype` tensor [*, K]
    with lane_len int32 [K] beside it, on the CPU (plain versions) or on a
    CUDA device with 1..max_lanes lanes (kernels)."""
    if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    k = t.shape[1]
    if lane_len.dtype != torch.int32 or tuple(lane_len.shape) != (k,) \
            or not lane_len.is_contiguous():
        raise ValueError(f"lane_len must be int32 [{k}], got "
                         f"{lane_len.dtype} {tuple(lane_len.shape)}")
    if lane_len.device != t.device:
        raise ValueError(f"lane_len and {name} must be on one device")
    if t.device.type == "cuda":
        if not 0 < k <= max_lanes:
            raise ValueError(f"the CUDA kernels take 1..{max_lanes} lanes, "
                             f"got {k}")
    elif t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")


def check_range(k: int, l0: int, ko: int) -> None:
    """Raise ValueError unless l0 .. l0 + ko - 1 are lanes of K (a rank's
    lanes, for the kernels' lane-range forms)."""
    if not (0 <= l0 and 1 <= ko and l0 + ko <= k):
        raise ValueError(f"lanes {l0} .. {l0 + ko - 1} are not lanes of {k}")


# ------------------------------------------------------------ lane rows

def lane_rows(flat: torch.Tensor, sizes: torch.Tensor,
              width: int) -> torch.Tensor:
    """Flat lane-ordered stream [P] + lane sizes [K] -> [K, width] rows of
    flat's dtype: row i holds lane i's elements, zero past its size."""
    sizes = sizes.to(torch.int64)
    col = torch.arange(width, device=flat.device)
    rows = torch.zeros((sizes.numel(), width), dtype=flat.dtype,
                       device=flat.device)
    if flat.numel():
        starts = torch.cumsum(sizes, 0) - sizes
        idx = torch.clamp(starts[:, None] + col[None, :],
                          max=flat.numel() - 1)
        rows = torch.where(col[None, :] < sizes[:, None], flat[idx], rows)
    return rows


def word_rows(payload: torch.Tensor, sizes: torch.Tensor,
              l4: int) -> torch.Tensor:
    """Flat lane-ordered payload [P] uint8 + lane sizes [K] -> [l4, K]
    int32 big-endian u32 word rows, word-major (word j of lane i = lane
    bytes 4j..4j+3, zero past its end): the range decoders' input."""
    rows = lane_rows(payload, sizes, 4 * l4)
    return compaction.rows_to_be_words(rows).T.contiguous()


def decode_words(rows: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Payload rows [K, L] uint8 + sizes [K] (what kernel B writes) -> the
    range decoders' word rows [l4, K], through the flat payload (the first
    sizes[i] bytes of each row i) that a container holds."""
    keep = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        < sizes[:, None].to(torch.int64)
    return word_rows(rows[keep], sizes, -(-int(sizes.max()) // 4) + 1)


# ----------------------------------------------- lane-payload containers

def assemble(head: Callable[[bool], ByteWriter], rows: np.ndarray,
             sizes: np.ndarray) -> bytes:
    """Container of payload rows (CT-RCX, CT-RCQ): head(wide), the size
    table (u32 "wide" when a lane payload reaches 64 KiB, else u16), then
    the first sizes[i] bytes of each row i."""
    sizes = sizes.astype(np.int64)
    return assemble_payload(
        head, rows[np.arange(rows.shape[1])[None, :] < sizes[:, None]], sizes)


def assemble_payload(head: Callable[[bool], ByteWriter], payload: np.ndarray,
                     sizes: np.ndarray) -> bytes:
    """assemble's container from the lane-major payload (lane after lane,
    sizes[i] bytes each) instead of rows."""
    wide = bool(sizes.max() >= 1 << 16)
    w = head(wide)
    _write_sizes(w, sizes.tolist(), wide)
    w.raw(payload.tobytes())
    return w.getvalue()


def payload_bytes(r: ByteReader, k: int, wide: bool) -> int:
    """The payload bytes after the size table that r is at (none if the
    container is shorter than the table)."""
    return max(0, len(r.buf) - r.pos - (4 if wide else 2) * k)


def payload_words(r: ByteReader, k: int, wide: bool, device) -> torch.Tensor:
    """Read the size table and the lane payloads that follow it; -> the
    decode word rows [l4, K] on `device`. Raises CorruptContainerError when
    the table claims more payload than the container has."""
    sizes = (r.u32s(k) if wide else r.u16s(k)).astype(np.int64)
    payload = r.rest()
    if int(sizes.sum()) > len(payload):
        raise CorruptContainerError(
            f"size table claims {int(sizes.sum())} payload bytes, "
            f"container has {len(payload)}")
    l4 = -(-int(sizes.max()) // 4) + 1
    return word_rows(torch.from_numpy(payload.copy()).to(device),
                     torch.from_numpy(sizes).to(device), l4)
