"""Shadow decoding of the port: encode-side divergence detection
(counterpart of cpprcoder_tpu/debug.py, with the same surface).

In shadow mode every `Codec.encode` decodes its own container again with
a backend independent of the one that encoded it and compares the bytes
with the input, reporting the first mismatch. A "cuda" or "torch" encode
(or one whose backend the device picked) is decoded by the numpy oracle
("ref"); a "ref" or "native" encode is decoded by the port's own path on
the device the caller gave, the card by default: it never falls back to
the CPU quietly.

Enable with CT_SHADOW=1 (env) or `set_shadow(True)`. Cost: one more decode
an encode; a debug mode, not a production path.
"""

from __future__ import annotations

import inspect
import os

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import as_u8

_SHADOW = os.environ.get("CT_SHADOW", "") not in ("", "0")


class DivergenceError(AssertionError):
    """An encoder and decoder divergence caught by the shadow decode."""

    def __init__(self, codec: str, index: int, total: int, detail: str = ""):
        self.codec, self.index, self.total = codec, index, total
        super().__init__(
            f"shadow decode divergence in codec {codec!r}: first mismatch "
            f"at byte {index} of {total}{(' (' + detail + ')') if detail else ''}")


def set_shadow(on: bool) -> None:
    global _SHADOW
    _SHADOW = bool(on)


def shadow_enabled() -> bool:
    return _SHADOW


def shadow_options(encode_opts: dict) -> dict:
    """The decode options of the shadow decode: the oracle where the port's
    path encoded, else the port's path on the caller's device (None: the
    card)."""
    if encode_opts.get("backend") in ("ref", "native"):
        return {"backend": None, "device": encode_opts.get("device")}
    return {"backend": "ref"}


def check_roundtrip(codec, data, blob, encode_opts: dict) -> None:
    """Decode `blob` with a backend independent of the one that encoded it
    and compare with `data`. Raises DivergenceError on a mismatch."""
    want = np.asarray(as_u8(data))
    # the decode's signature says whether it takes a backend (a TypeError
    # raised inside a decode must propagate, not quietly give up the
    # independent backend)
    try:
        params = inspect.signature(codec._decode).parameters
    except (TypeError, ValueError):
        params = {}
    if "backend" in params:
        opts = shadow_options(encode_opts)
        backend = opts["backend"] or "the port's path"
        got_b = codec._decode(blob, **opts)
    else:
        backend = "default"
        got_b = codec._decode(blob)
    got = np.frombuffer(got_b, dtype=np.uint8)
    if got.shape == want.shape and (want.size == 0 or bool(np.all(got == want))):
        return
    if got.shape != want.shape:
        raise DivergenceError(codec.name, min(got.size, want.size), want.size,
                              f"length {got.size} != {want.size}, "
                              f"shadow backend {backend}")
    idx = int(np.argmax(got != want))
    raise DivergenceError(codec.name, idx, want.size,
                          f"shadow backend {backend}")
