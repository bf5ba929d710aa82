"""CT-ANS2 adaptive interleaved rANS codec of the port (counterpart of
cpprcoder_tpu/codecs/adaptive_rans.py): an adaptive model with a table a
window, a division-free decode and no frequency header.

Format: reference/ans2_ref.py; options `inc`, `limit_log2` and
`refresh_log2` (defaults ANS2_INC_DEFAULT, ANS2_LIMIT_LOG2_DEFAULT and
default_refresh_log2(K, n)), as there. Backends (codecs/base.py): "cuda"
(kernels W, X and Y on the card), "torch" (plain versions on the CPU) and
"ref" (the numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import check_lane_count, resolve
from cpprcoder_tpu_torch.ops import ans2_ops
from cpprcoder_tpu_torch.reference import ans2_ref


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None, inc: int | None = None,
           limit_log2: int | None = None,
           refresh_log2: int | None = None) -> bytes:
    lanes = lanes or None   # 0: the default lane count, as in the oracle
    check_lane_count(lanes)
    backend, dev = resolve(backend, device)
    kw = dict(lanes=lanes, refresh_log2=refresh_log2)
    if inc is not None:
        kw["inc"] = inc
    if limit_log2 is not None:
        kw["limit_log2"] = limit_log2
    if backend == "ref":
        return ans2_ref.ans2_encode(data, **kw)
    return ans2_ops.ans2_encode(data, device=dev, **kw)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return ans2_ref.ans2_decode(blob)
    return ans2_ops.ans2_decode(blob, device=dev)


CODEC = register("adaptive_rans", 13, encode, decode)
