"""Kernel M and N wrappers: CT-MTF1 encode and decode on the card.

The JAX package has no Pallas kernel here: it runs MTF as one compiled
`lax.scan` of 2^15 steps a block on the device
(cpprcoder_tpu/ops/mtf_ops.py:45-81). A PyTorch step loop on the card
would launch about ten kernels a step, so the scan is a kernel
(`csrc/mtf.cu`): one CTA a 2^15-byte block, cut into 32 segments that run
side by side, a warp each, each from the exact list it starts with (N
decodes against placeholders and composes the segments' permutations; M
builds each start list from the last touch of every byte before it, and
under MTF-1 walks the head machine over the segments). Within a segment
the steps are sequential: latency- and issue-bound. One launch a call.

Their plain version is `mtf_ops.transform_plain`. On a CPU tensor a wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import mtf_ops
from cpprcoder_tpu_torch.reference.mtf_ref import MTF_BLOCK

encode_launches = 0   # kernel M
decode_launches = 0   # kernel N


def _check(blocks: torch.Tensor, n: int) -> None:
    if blocks.dtype != torch.uint8 or blocks.dim() != 2 \
            or blocks.shape[1] != MTF_BLOCK or not blocks.is_contiguous():
        raise ValueError(f"blocks must be contiguous uint8 [nb, {MTF_BLOCK}]"
                         f", got {blocks.dtype} {tuple(blocks.shape)}")
    if not 0 < n or -(-n // MTF_BLOCK) != blocks.shape[0]:
        raise ValueError(f"n={n} does not fill {blocks.shape[0]} blocks")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blocks.device}")


def _launch(entry: str, blocks: torch.Tensor, n: int, mtf1: bool):
    dev = blocks.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty_like(blocks)
        rc = getattr(lib, entry)(blocks.data_ptr(), out.data_ptr(), n,
                                 blocks.shape[0], int(mtf1),
                                 torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, entry)
    return out.reshape(-1)[:n]


def encode_ranks(blocks: torch.Tensor, n: int, mtf1: bool) -> torch.Tensor:
    """blocks [nb, MTF_BLOCK] uint8 holding n bytes (zero past them) -> the
    n ranks, uint8 [n]."""
    global encode_launches
    _check(blocks, n)
    if blocks.device.type == "cpu":
        return mtf_ops.transform_plain(blocks, n, mtf1, decode=False)
    out = _launch("ct_mtf_encode", blocks, n, mtf1)
    encode_launches += 1
    return out


def decode_bytes(blocks: torch.Tensor, n: int, mtf1: bool) -> torch.Tensor:
    """blocks [nb, MTF_BLOCK] uint8 holding n ranks (zero past them) -> the
    n bytes, uint8 [n]."""
    global decode_launches
    _check(blocks, n)
    if blocks.device.type == "cpu":
        return mtf_ops.transform_plain(blocks, n, mtf1, decode=True)
    out = _launch("ct_mtf_decode", blocks, n, mtf1)
    decode_launches += 1
    return out
