"""CT-RCX codec of the port (counterpart of cpprcoder_tpu/codecs/rcx.py).

Format: cpprcoder_tpu/reference/rcx_ref.py. Backends (codecs/base.py):
"cuda" (kernels A, B, C on the card), "torch" (plain versions on the CPU)
and "ref" (the numpy oracle); all write byte-identical containers.
"""

from __future__ import annotations

from cpprcoder_tpu.reference import rcx_ref
from cpprcoder_tpu_torch.codecs import register
from cpprcoder_tpu_torch.codecs.base import resolve
from cpprcoder_tpu_torch.models.cxmodel import rcx_params
from cpprcoder_tpu_torch.ops import rcx_ops

MODES = ("balanced", "ratio")


def encode(data, backend: str | None = None, device=None,
           lanes: int | None = None, inc: int | None = None,
           climit_log2: int | None = None, cbits: int | None = None,
           mode: str = "balanced", wlog: int | None = None) -> bytes:
    """mode "ratio": half the lanes, cbits=6 and wlog=0 (rcx_params)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "ratio" and lanes is None and cbits is None:
        lanes, _, _, cbits = rcx_params(len(data), mode=mode)
        if wlog is None:
            wlog = 0
    backend, dev = resolve(backend, device)
    opts = dict(lanes=lanes, inc=inc, climit_log2=climit_log2, cbits=cbits,
                wlog=wlog)
    if backend == "ref":
        return rcx_ref.rcx_encode(data, **opts)
    return rcx_ops.rcx_encode(data, device=dev, **opts)


def decode(blob, backend: str | None = None, device=None) -> bytes:
    backend, dev = resolve(backend, device)
    if backend == "ref":
        return rcx_ref.rcx_decode(blob)
    return rcx_ops.rcx_decode(blob, device=dev)


CODEC = register("rcx", 15, encode, decode)
