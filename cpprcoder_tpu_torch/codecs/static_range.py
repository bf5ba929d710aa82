"""CT-RC1 static range coder codec of the port (counterpart of
cpprcoder_tpu/codecs/static_range.py; reference parity: RangeEncoder,
cpprcoder.h:321-619).

Format: reference/rc_ref.py. Backends (codecs/base.py): "cuda" (kernels J,
B and L on the card), "torch" (plain versions on the CPU) and "ref" (the
numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import range_ops
from cpprcoder_tpu_torch.reference import rc_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None) -> bytes:
    # 0 picks the default lane count, as the oracle's
    # `lanes or pick_lanes(n)` does
    lanes = lanes or None
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rc_ref.static_encode(data, lanes=lanes)
    return range_ops.static_encode(data, lanes=lanes, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rc_ref.static_decode(blob)
    return range_ops.static_decode(blob, device=dev)


CODEC = register("static_range", 0, encode, decode)
