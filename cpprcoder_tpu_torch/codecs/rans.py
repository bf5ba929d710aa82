"""CT-ANS1 v2 interleaved rANS codec of the port (counterpart of
cpprcoder_tpu/codecs/rans.py), the default codec of compress().

Format: reference/rans_ref.py. Backends (codecs/base.py):
"cuda" (kernels F and G on the card), "torch" (plain versions on the CPU)
and "ref" (the numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import rans_ops
from cpprcoder_tpu_torch.reference import rans_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None) -> bytes:
    # 0 picks the default lane count, as the oracle's
    # `lanes or pick_lanes(n)` does
    lanes = lanes or None
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rans_ref.rans_encode(data, lanes=lanes)
    return rans_ops.rans_encode(data, lanes=lanes, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rans_ref.rans_decode(blob)
    return rans_ops.rans_decode(blob, device=dev)


CODEC = register("rans", 2, encode, decode)
