"""CT-RLE0 zero-run-length codec stage of the port (counterpart of
cpprcoder_tpu/codecs/rle0.py; bzip2-style ZRLE, meant between mtf1 and an
entropy coder in Config-4 pipelines).

Format: reference/rle0_ref.py. Backends (codecs/base.py): "cuda" (tensor
code on the card), "torch" (the same on the CPU) and "ref" (the numpy
oracle).
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import resolve
from cpprcoder_tpu_torch.ops import rle0_ops
from cpprcoder_tpu_torch.reference import rle0_ref


def encode(data, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rle0_ref.rle0_encode(data)
    return rle0_ops.rle0_encode(data, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rle0_ref.rle0_decode(blob)
    return rle0_ops.rle0_decode(blob, device=dev)


CODEC = register("rle0", 12, encode, decode)
