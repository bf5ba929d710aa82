"""CT-ASE1 adaptive symbol encoder codec of the port (counterpart of
cpprcoder_tpu/codecs/ase.py; reference parity: ASE, cppase.h:71-324: a
64-entry recency list, 9-bit literals, LSB-first bits).

Format: reference/ase_ref.py. Backends (codecs/base.py): "cuda" (kernels S
and T on the card), "torch" (plain versions on the CPU) and "ref" (the
numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import ase_ops
from cpprcoder_tpu_torch.reference import ase_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None) -> bytes:
    lanes = lanes or None   # 0: the default lane count, as in the oracle
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return ase_ref.ase_encode(data, lanes=lanes)
    return ase_ops.ase_encode(data, lanes=lanes, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return ase_ref.ase_decode(blob)
    return ase_ops.ase_decode(blob, device=dev)


CODEC = register("ase", 7, encode, decode)
