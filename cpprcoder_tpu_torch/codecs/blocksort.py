"""CT-BWT1 blocksort (BWT) transform codec of the port (counterpart of
cpprcoder_tpu/codecs/blocksort.py; reference parity: BlkSort,
blksort.h:76-108,401-661).

Format: reference/bwt_ref.py. Backends (codecs/base.py): "cuda" (the
prefix-doubling sort and the doubling inverse as tensor code on the card),
"torch" (the same on the CPU) and "ref" (the numpy oracle).
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import resolve
from cpprcoder_tpu_torch.ops import bwt_ops
from cpprcoder_tpu_torch.reference import bwt_ref


def encode(data, backend: str | None = None, device=None,
           block_log2: int = 15) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return bwt_ref.bwt_encode(data, block_log2=block_log2)
    return bwt_ops.bwt_encode(data, block_log2=block_log2, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return bwt_ref.bwt_decode(blob)
    return bwt_ops.bwt_decode(blob, device=dev)


CODEC = register("blocksort", 4, encode, decode)
