"""CT-MTF1 move-to-front transform in PyTorch (counterpart of
cpprcoder_tpu/ops/mtf_ops.py): plain MTF and the reference's MTF-1.

Format: reference/mtf_ref.py. Blocks of 2^15 bytes (MTF_BLOCK) are
independent, each starting from the identity list with prev = 1. The
container functions pad the input to whole blocks and hand them to kernel M
(encode) or N (decode) through ops/mtf_kernels.py; the step loop below is
their plain version: the blocks side by side as rows, one step a column.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8
from cpprcoder_tpu_torch.reference.mtf_ref import MTF_BLOCK


def pad_blocks(x: torch.Tensor) -> torch.Tensor:
    """x [n] uint8 -> [ceil(n / MTF_BLOCK), MTF_BLOCK], zero past n."""
    nb = -(-x.numel() // MTF_BLOCK)
    buf = torch.zeros(nb * MTF_BLOCK, dtype=torch.uint8, device=x.device)
    buf[: x.numel()] = x
    return buf.view(nb, MTF_BLOCK)


def transform_plain(blocks: torch.Tensor, n: int, mtf1: bool,
                    decode: bool) -> torch.Tensor:
    """Plain version of kernels M (decode=False: bytes -> ranks) and N
    (decode=True: ranks -> bytes): blocks [nb, MTF_BLOCK] uint8 holding the
    n input bytes -> the n output bytes, uint8 [n]. Each block's list is
    kept as the position of every symbol, so a move adds one to the
    positions in [dst, r) and sets the moved symbol's to dst."""
    nb, b = blocks.shape
    dev = blocks.device
    pos = torch.arange(256, device=dev).repeat(nb, 1)   # symbol -> position
    prev = torch.ones((nb, 1), dtype=torch.int64, device=dev)
    xs = blocks.to(torch.int64)
    out = torch.zeros((nb, b), dtype=torch.int64, device=dev)
    for i in range(min(b, n)):   # every block but the last is full
        v = xs[:, i:i + 1]
        if decode:
            r, sym = v, torch.argmax((pos == v).to(torch.int8), 1,
                                     keepdim=True)
        else:
            sym, r = v, pos.gather(1, v)
        # MTF: to the front; MTF-1: r > 1 to 1, r == 1 to 0 after a
        # nonzero rank, else in place
        dst = torch.clamp(r, max=1) - ((r == 1) & (prev != 0)).to(torch.int64) \
            if mtf1 else torch.zeros_like(r)
        pos += (pos >= dst) & (pos < r)
        pos.scatter_(1, sym, dst)
        out[:, i:i + 1] = sym if decode else r
        prev = r
    return out.to(torch.uint8).reshape(-1)[:n]


def mtf_encode(data, mtf1: bool = False, *, device) -> bytes:
    """CT-MTF1 container of `data`, transformed on `device` (kernel M on
    CUDA, its plain version on the CPU). Same bytes as mtf_ref.mtf_encode."""
    from cpprcoder_tpu_torch.ops import mtf_kernels

    x = as_u8(data)
    n = len(x)
    w = ByteWriter().u32(n).u8(1 if mtf1 else 0)
    if n:
        blocks = pad_blocks(torch.from_numpy(x.copy()).to(device))
        w.raw(mtf_kernels.encode_ranks(blocks, n, mtf1).cpu().numpy()
              .tobytes())
    return w.getvalue()


def mtf_decode(blob, *, device) -> bytes:
    from cpprcoder_tpu_torch.ops import mtf_kernels

    r = ByteReader(blob)
    n = r.u32()
    mtf1 = bool(r.u8())
    if n == 0:
        return b""
    blocks = pad_blocks(torch.from_numpy(r.raw(n).copy()).to(device))
    return mtf_kernels.decode_bytes(blocks, n, mtf1).cpu().numpy().tobytes()
