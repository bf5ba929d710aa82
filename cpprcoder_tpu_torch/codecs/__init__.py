"""Codec registry and top-level compress/decompress of the port
(counterpart of cpprcoder_tpu/codecs/__init__.py; same names and ids).

Only `rcx` (id 15, CT-RCX) is ported so far. Asking for another codec of
the JAX package raises KeyError naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, "Codec"] = {}

# codecs of the JAX package still to port -> ROADMAP.md queue A item
NOT_YET_PORTED = {
    "rcq": "A5", "static_range": "A6", "adaptive_range": "A6",
    "stream": "A7", "rans": "A8", "huffman": "A9", "blocksort": "A10",
    "mtf": "A10", "mtf1": "A10", "rle0": "A10", "pipeline": "A10",
    "slz4": "A11", "adaptive_o1": "A12", "adaptive_rans": "A12",
    "ase": "A12",
}


class Codec:
    def __init__(self, name: str, codec_id: int,
                 encode: Callable, decode: Callable):
        self.name = name
        self.codec_id = codec_id
        self._encode = encode
        self._decode = decode

    def encode(self, data, **opts) -> bytes:
        return self._encode(data, **opts)

    def decode(self, blob, **opts) -> bytes:
        return self._decode(blob, **opts)


def register(name: str, codec_id: int, encode: Callable,
             decode: Callable) -> Codec:
    c = Codec(name, codec_id, encode, decode)
    _REGISTRY[name] = c
    return c


def get_codec(name: str) -> Codec:
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_YET_PORTED:
        raise KeyError(f"codec {name!r} is not ported to PyTorch yet "
                       f"(ROADMAP.md item {NOT_YET_PORTED[name]}); "
                       f"available: {sorted(_REGISTRY)}")
    raise KeyError(f"unknown codec {name!r}; available: {sorted(_REGISTRY)}")


def list_codecs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def compress(data, codec: str = "rcx", **opts) -> bytes:
    return get_codec(codec).encode(data, **opts)


def decompress(blob, codec: str = "rcx", **opts) -> bytes:
    return get_codec(codec).decode(blob, **opts)


def _ensure_loaded():
    from cpprcoder_tpu_torch.codecs import rcx  # noqa: F401  (registers)
