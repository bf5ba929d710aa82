"""CT-HUF1 canonical Huffman codec of the port (counterpart of
cpprcoder_tpu/codecs/huffman.py).

Format: reference/huffman_ref.py. Backends (codecs/base.py): "cuda"
(kernels H and I on the card), "torch" (plain versions on the CPU) and
"ref" (the numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import huffman_ops
from cpprcoder_tpu_torch.reference import huffman_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None) -> bytes:
    # 0 picks the default lane count, as the oracle's
    # `lanes or pick_lanes(n)` does
    lanes = lanes or None
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return huffman_ref.huffman_encode(data, lanes=lanes)
    return huffman_ops.huffman_encode(data, lanes=lanes, device=dev)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return huffman_ref.huffman_decode(blob)
    return huffman_ops.huffman_decode(blob, device=dev)


CODEC = register("huffman", 3, encode, decode)
