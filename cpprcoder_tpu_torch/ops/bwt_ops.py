"""CT-BWT1 Burrows-Wheeler transform in PyTorch (counterpart of
cpprcoder_tpu/ops/bwt_ops.py).

Format: reference/bwt_ref.py (cyclic rotations of independent blocks; the
tail binary-decomposed into power-of-two sub-blocks down to 256 bytes, the
rest raw). The JAX package's transform is data-parallel and stays tensor
code here, batched over the blocks of one size (`_size_groups`):

  forward: prefix-doubling rank sort. Round j sorts the rotations by
  (rank, rank h = 2^j places on) with one stable `torch.sort` of the two
  packed into one int64 key (index order breaks ties, as the JAX package's
  `lax.sort(..., is_stable=True)` over (rank, key2, idx) does), then ranks
  them again by a cumsum over the key changes. The oracle stops once every
  rank of a block is distinct, the JAX package after ceil(log2 B) rounds;
  once distinct, the ranks no longer change, so stopping early (one host
  read a round) writes the same bytes. Rotations that tie to the end (a
  period dividing the block) keep index order either way.
  inverse: the LF walk p <- t[p] (t the stable argsort of the last column)
  by permutation doubling with `torch.gather`: positions 0..m-1 of the
  walk give positions m..2m-1 through t^m.
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
    as_u8,
)
from cpprcoder_tpu_torch.reference import bwt_ref


def _size_groups(sizes: list[int]):
    """Consecutive equal-size runs: [(size, count), ...] in stream order
    (the CT-BWT1 layout is [bs]*nb + strictly-decreasing tail powers)."""
    groups = []
    for bs in sizes:
        if groups and groups[-1][0] == bs:
            groups[-1][1] += 1
        else:
            groups.append([bs, 1])
    return groups


def forward_blocks(blocks: torch.Tensor):
    """blocks [nb, B] uint8 -> (last column [nb, B] uint8, row index of the
    original rotation [nb] int64)."""
    nb, b = blocks.shape
    rank = blocks.to(torch.int64)
    span = max(b, 256)   # every rank and byte is below it
    for j in range(max(1, (b - 1).bit_length())):
        key2 = torch.roll(rank, -(1 << j), dims=1)
        perm = torch.sort(rank * span + key2, dim=1, stable=True).indices
        r1, r2 = rank.gather(1, perm), key2.gather(1, perm)
        diff = torch.zeros_like(r1)
        diff[:, 1:] = ((r1[:, 1:] != r1[:, :-1])
                       | (r2[:, 1:] != r2[:, :-1])).to(torch.int64)
        rank = torch.empty_like(rank).scatter_(1, perm, torch.cumsum(diff, 1))
        if bool((rank.amax(1) == b - 1).all()):
            break
    order = torch.sort(rank, dim=1, stable=True).indices
    last = blocks.gather(1, (order - 1) % b)
    return last, torch.argmax((order == 0).to(torch.int8), 1)


def inverse_blocks(last: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """last [nb, B] uint8, rows [nb] int64 -> the blocks [nb, B] uint8."""
    nb, b = last.shape
    t = torch.sort(last.to(torch.int64), dim=1, stable=True).indices
    pos = torch.empty_like(t)
    pos[:, :1] = t.gather(1, rows.to(torch.int64)[:, None])
    p, filled = t, 1
    while filled < b:
        m = min(filled, b - filled)
        pos[:, filled:filled + m] = p.gather(1, pos[:, :m])
        filled *= 2
        if filled < b:
            p = p.gather(1, p)
    return last.gather(1, pos)


def bwt_encode(data, block_log2: int = 15, *, device) -> bytes:
    """CT-BWT1 container of `data`, sorted on `device`. Same bytes as
    bwt_ref.bwt_encode."""
    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n).u8(block_log2)
    sizes, rem = bwt_ref.block_layout(n, block_log2)
    xt = torch.from_numpy(x.copy()).to(device)
    off = 0
    for bs, cnt in _size_groups(sizes):
        last, rows = forward_blocks(xt[off:off + cnt * bs].view(cnt, bs))
        last, rows = last.cpu().numpy(), rows.cpu().tolist()
        for i in range(cnt):
            w.raw(last[i].tobytes()).u32(rows[i])
        off += cnt * bs
    w.raw(x[n - rem:].tobytes())
    return w.getvalue()


def bwt_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    sizes, rem = bwt_ref.block_layout(n, r.u8())
    out = bytearray()
    for bs, cnt in _size_groups(sizes):
        lasts = np.empty((cnt, bs), np.uint8)
        rows = []
        for i in range(cnt):
            lasts[i] = r.raw(bs)
            rows.append(r.u32())
        if max(rows) >= bs:
            raise CorruptContainerError(f"CT-BWT1 row index {max(rows)} past "
                                        f"a {bs}-byte block")
        orig = inverse_blocks(torch.from_numpy(lasts).to(device),
                              torch.tensor(rows, device=device))
        out += orig.cpu().numpy().tobytes()
    out += r.raw(rem).tobytes()
    return bytes(out)
