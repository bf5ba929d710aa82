"""CT-RCQ codec of the port (counterpart of cpprcoder_tpu/codecs/rcq.py).

Format: reference/rcq_ref.py. Backends (codecs/base.py):
"cuda" (kernels D, B, E on the card), "torch" (plain versions on the CPU)
and "ref" (the numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import rcq_ops
from cpprcoder_tpu_torch.reference import rcq_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None, inc: int | None = None,
           climit_log2: int | None = None) -> bytes:
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    opts = dict(lanes=lanes, inc=inc, climit_log2=climit_log2)
    if backend == "ref":
        return rcq_ref.rcq_encode(data, **opts)
    return rcq_ops.rcq_encode(data, device=dev, **opts)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rcq_ref.rcq_decode(blob)
    return rcq_ops.rcq_decode(blob, device=dev)


CODEC = register("rcq", 14, encode, decode)
