"""CT-RC3 order-1 blended adaptive range coder codec of the port
(counterpart of cpprcoder_tpu/codecs/adaptive_o1.py): chunked lanes, each
lane's context its own previous byte, one shared order-1 and order-0 model
blended with exact integer weights.

Format: reference/o1_ref.py; options `inc` (default pick_inc(K)),
`limit1_log2`, `limit0_log2` and `blend_log2` (defaults LIMIT1_LOG2,
LIMIT0_LOG2, BLEND_LOG2), as there. A step whose range / tot_eff is 0,
where the oracle never ends (ops/o1_ops.py), raises ValueError on encode
and CorruptContainerError on decode. On the card, at a limit_log2 of 32
or more, a stream whose counts could reach 2^32 raises
ops.o1_ops.CardCountsError (fault P7); the CPU backends take it. Backends
(codecs/base.py): "cuda" (kernels U, B and V on the card), "torch" (plain
versions on the CPU) and "ref" (the numpy oracle); all write
byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import o1_ops
from cpprcoder_tpu_torch.reference import o1_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None, **opts) -> bytes:
    lanes = lanes or None   # 0: the default lane count, as in the oracle
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return o1_ref.o1_encode(data, lanes=lanes, **opts)
    return o1_ops.o1_encode(data, lanes=lanes, device=dev, **opts)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return o1_ref.o1_decode(blob)
    return o1_ops.o1_decode(blob, device=dev)


CODEC = register("adaptive_o1", 11, encode, decode)
