"""CT-LZ4 codec of the port (reference parity: SLZ4, test/slz4.h:116-592 —
LZ4 block format with exact parallel match-finding instead of a
single-probe hash; counterpart of cpprcoder_tpu/codecs/slz4.py).

Backends, as in the JAX codec:
  "cuda" (default) and "torch": the v2 parse (ops/lz_ops.py; kernels K,
      the match table, P and Q on the card, their plain versions on the
      CPU), the counterparts of the JAX codec's "jax" backend;
  "ref": the numpy oracle's default, the v1 parse
      (slz4_ref.slz4_encode(parse="v1")), as the JAX codec's "ref" writes;
  "native": the host library built from the repository's native/ctrc.cpp
      (native/ctrc.py), which also writes the v1 parse.
The parse stays an ops-level argument, as in the JAX package: the v1
parse on a device is lz_ops.slz4_encode(..., parse="v1", device=...)
(kernel Z, the exact v1 match table, then P and Q on the card; their
plain versions on the CPU), the oracle's bytes. The parses differ, the
block format does not: every decoder reads every container (decode:
kernel R on the card, its plain version on the CPU).
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import resolve
from cpprcoder_tpu_torch.ops import lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref


def encode(data, backend: str | None = None, seg_log2: int = 17,
           lazy: bool = True, device=None) -> bytes:
    if backend == "native":
        from cpprcoder_tpu_torch.native import ctrc
        return ctrc.slz4_encode(data, seg_log2=seg_log2, lazy=lazy)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return slz4_ref.slz4_encode(data, seg_log2=seg_log2, lazy=lazy)
    return lz_ops.slz4_encode(data, seg_log2=seg_log2, lazy=lazy, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    if backend == "native":
        from cpprcoder_tpu_torch.native import ctrc
        return ctrc.slz4_decode(blob)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return slz4_ref.slz4_decode(blob)
    return lz_ops.slz4_decode(blob, device=dev)


CODEC = register("slz4", 6, encode, decode)
