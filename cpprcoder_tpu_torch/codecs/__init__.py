"""Codec registry and top-level compress/decompress of the port
(counterpart of cpprcoder_tpu/codecs/__init__.py; same names and ids).

Every codec of the JAX package is ported: `static_range` (id 0, CT-RC1),
`adaptive_range` (1, CT-RC2), `rans` (2, CT-ANS1 v2, the default codec, as
in the JAX package), `huffman` (3, CT-HUF1), `blocksort` (4, CT-BWT1),
`mtf` (5) and `mtf1` (8) (CT-MTF1), `slz4` (6, CT-LZ4: the v2 parse on the
card and the CPU, the v1 parse under `backend="ref"` and `"native"`), `ase`
(7, CT-ASE1), `pipeline` (9, CT-PIPE), `stream` (10, CT-SB: superblocks of
any codec; codecs/stream.py, with `SuperblockEncoder` and
`stream_decode_range`), `adaptive_o1` (11, CT-RC3), `rle0` (12, CT-RLE0),
`adaptive_rans` (13, CT-ANS2), `rcq` (14, CT-RCQ; its resumable encoder is
codecs/resume.py) and `rcx` (15, CT-RCX). An unknown name or id (a
pipeline stage or a CT-SB header) raises KeyError. In shadow mode
(debug.py) every encode is decoded again by an independent backend.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, "Codec"] = {}
_BY_ID: dict[int, "Codec"] = {}


class Codec:
    def __init__(self, name: str, codec_id: int,
                 encode: Callable, decode: Callable):
        self.name = name
        self.codec_id = codec_id
        self._encode = encode
        self._decode = decode

    def encode(self, data, **opts) -> bytes:
        blob = self._encode(data, **opts)
        from cpprcoder_tpu_torch import debug

        if debug.shadow_enabled():
            debug.check_roundtrip(self, data, blob, opts)
        return blob

    def decode(self, blob, **opts) -> bytes:
        return self._decode(blob, **opts)


def register(name: str, codec_id: int, encode: Callable,
             decode: Callable) -> Codec:
    c = Codec(name, codec_id, encode, decode)
    _REGISTRY[name] = c
    _BY_ID[codec_id] = c
    return c


def get_codec(name: str) -> Codec:
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown codec {name!r}; available: {sorted(_REGISTRY)}")


def get_codec_by_id(codec_id: int) -> Codec:
    _ensure_loaded()
    if codec_id in _BY_ID:
        return _BY_ID[codec_id]
    raise KeyError(f"unknown codec id {codec_id}")


def list_codecs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def compress(data, codec: str = "rans", **opts) -> bytes:
    return get_codec(codec).encode(data, **opts)


def decompress(blob, codec: str = "rans", **opts) -> bytes:
    return get_codec(codec).decode(blob, **opts)


def _ensure_loaded():
    from cpprcoder_tpu_torch.codecs import (  # noqa: F401
        adaptive_o1,
        adaptive_range,
        adaptive_rans,
        ase,
        blocksort,
        huffman,
        mtf,
        pipeline,
        rans,
        rcq,
        rcx,
        rle0,
        slz4,
        static_range,
        stream,
    )
