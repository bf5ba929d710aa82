"""CT-RLE0 zero-run-length transform in PyTorch (counterpart of
cpprcoder_tpu/ops/rle0_ops.py; format in reference/rle0_ref.py).

Both directions are data-parallel tensor code, as in the JAX package:

encode: a zero run's digit count and digits depend only on its length,
(next nonzero index - position) at its start: a reverse cumulative minimum
(`torch.flip` and `torch.cummin`). Each position's output offset is an
exclusive cumsum of its token count; the tokens are written by masked
`index_put_`s into a buffer of the 2n bound plus one spare slot, where the
masked-out writes land (a torch scatter does not drop out-of-range indices
as JAX's `mode="drop"` does).

decode: every output byte is a literal or a zero. The output starts zeroed,
so only the literals are written, each at the offset that an exclusive
cumsum gives (a run group contributes sum_j (1 + d_j) << j, with j the
digit's index in its group, from a cummax over the group starts).
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.core.bytesutil import ByteReader, ByteWriter, as_u8

_MAXBITS = 30  # run lengths < 2^30 (1 GiB of zeros per run)


def _shift_right(t: torch.Tensor, fill) -> torch.Tensor:
    """t[i - 1] at i, `fill` at 0."""
    return torch.cat([torch.full((1,), fill, dtype=t.dtype, device=t.device),
                      t[:-1]])


def encode_tokens(x: torch.Tensor) -> torch.Tensor:
    """x [n] uint8 (n >= 1) -> the CT-RLE0 token bytes, uint8."""
    n = x.numel()
    x = x.to(torch.int64)
    idx = torch.arange(n, device=x.device)
    z = x == 0
    start = z & ~_shift_right(z, False)
    next_nz = torch.flip(torch.cummin(torch.flip(torch.where(z, n, idx), [0]),
                                      0).values, [0])
    lp1 = next_nz - idx + 1            # run length + 1, valid at run starts
    top = (n + 1).bit_length()         # no run is longer than n
    m = sum((lp1 >= (1 << j)).to(torch.int64) for j in range(1, top))
    contrib = torch.where(z, torch.where(start, m, 0),
                          torch.where(x <= 253, 1, 2))
    off = torch.cumsum(contrib, 0) - contrib
    spare = 2 * n                      # the 2n bound, then the spare slot
    out = torch.zeros(spare + 1, dtype=torch.uint8, device=x.device)

    def put(mask, at, val):
        out.index_put_((torch.where(mask, at, spare),), val.to(torch.uint8))

    lit = ~z & (x <= 253)
    esc = ~z & (x >= 254)
    put(lit, off, x + 1)
    put(esc, off, torch.full_like(x, 255))
    put(esc, off + 1, x - 254)
    for j in range(top - 1):
        put(start & (m > j), off + j, (lp1 >> j) & 1)
    return out[:int(off[-1] + contrib[-1])]


def decode_tokens(y: torch.Tensor, n: int) -> torch.Tensor:
    """y [t] uint8 tokens -> the n bytes, uint8 [n]; raises ValueError when
    they do not decode to exactly n bytes."""
    dev = y.device
    if y.numel() == 0:
        if n:
            raise ValueError(f"CT-RLE0: decoded 0 bytes, expected {n}")
        return torch.zeros(0, dtype=torch.uint8, device=dev)
    y = y.to(torch.int64)
    idx = torch.arange(y.numel(), device=dev)
    esc = y == 255
    consumed = _shift_right(esc, False)
    digit = (y <= 1) & ~consumed
    grp_start = digit & ~_shift_right(digit, False)
    last_start = torch.cummax(torch.where(grp_start, idx, -1), 0).values
    j = torch.clamp(idx - last_start, max=_MAXBITS)
    contrib = torch.where(digit, (1 + y) << j, torch.where(consumed, 0, 1))
    off = torch.cumsum(contrib, 0) - contrib
    total = int(off[-1] + contrib[-1])
    if total != n:
        raise ValueError(f"CT-RLE0: decoded {total} bytes, expected {n}")
    out = torch.zeros(n + 1, dtype=torch.uint8, device=dev)  # n: the spare
    lit = ~digit & ~consumed & ~esc
    nxt = torch.cat([y[1:], torch.zeros(1, dtype=y.dtype, device=dev)])
    out.index_put_((torch.where(lit, off, n),), (y - 1).to(torch.uint8))
    out.index_put_((torch.where(esc, off, n),), (254 + nxt).to(torch.uint8))
    return out[:n]


def rle0_encode(data, *, device) -> bytes:
    """CT-RLE0 container of `data`, transformed on `device`. Same bytes as
    rle0_ref.rle0_encode."""
    x = as_u8(data)
    w = ByteWriter().u32(len(x))
    if len(x):
        x_t = torch.from_numpy(x.copy()).to(device)
        w.raw(encode_tokens(x_t).cpu().numpy().tobytes())
    return w.getvalue()


def rle0_decode(blob, *, device) -> bytes:
    r = ByteReader(blob)
    n = r.u32()
    y = torch.from_numpy(r.rest().copy()).to(device)
    if n == 0:
        return b""
    return decode_tokens(y, n).cpu().numpy().tobytes()
