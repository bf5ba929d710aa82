"""CT-RC2 adaptive range coder codec of the port (counterpart of
cpprcoder_tpu/codecs/adaptive_range.py; reference parity:
AdaptiveRangeEncoder/Decoder + AdaptiveFrequencyTable, cpprcoder.h:256-940).

K lanes share one adaptive model updated with a batched per-step histogram.
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
           lanes: int | None = None, inc: int | None = None,
           limit_log2: int | None = None) -> bytes:
    lanes = lanes or None   # 0: the default lane count, as in the oracle
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    opts = dict(lanes=lanes, inc=inc, limit_log2=limit_log2)
    if backend == "ref":
        return rc_ref.adaptive_encode(data, **opts)
    return range_ops.adaptive_encode(data, device=dev, **opts)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rc_ref.adaptive_decode(blob)
    return range_ops.adaptive_decode(blob, device=dev)


CODEC = register("adaptive_range", 1, encode, decode)
