"""CT-MTF1 move-to-front codecs of the port, plain MTF (`mtf`) and the
reference's MTF-1 variant (`mtf1`), blksort.h:663-793 (counterpart of
cpprcoder_tpu/codecs/mtf.py).

Format: reference/mtf_ref.py. Backends (codecs/base.py): "cuda" (kernels M
and N on the card), "torch" (their plain version on the CPU) and "ref"
(the numpy oracle). Both names decode either container: the header says
which variant wrote it.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import resolve
from cpprcoder_tpu_torch.ops import mtf_ops
from cpprcoder_tpu_torch.reference import mtf_ref


def _encode(mtf1: bool):
    def encode(data, backend: str | None = None, device=None) -> bytes:
        backend, dev = resolve(backend, device)
        if backend == "ref":
            return mtf_ref.mtf_encode(data, mtf1)
        return mtf_ops.mtf_encode(data, mtf1, device=dev)
    return encode


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return mtf_ref.mtf_decode(blob)
    return mtf_ops.mtf_decode(blob, device=dev)


CODEC = register("mtf", 5, _encode(False), decode)
CODEC1 = register("mtf1", 8, _encode(True), decode)
