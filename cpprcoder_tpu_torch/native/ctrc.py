"""ctypes binding of the native host codec (the repository's
native/ctrc.cpp), for the port's `backend="native"` of `slz4`.

The port's own copy of the JAX package's host loader
(cpprcoder_tpu/native/__init__.py: its `slz4_encode` and `slz4_decode`),
which builds the same source. This copy builds it with g++ at first use
into `build/host/<source hash>/libctrc.so` under the repository root (the
hash covers the source and the flags), never next to the source. Its
containers are the v1 parse's, byte-identical to
reference/slz4_ref.slz4_encode(parse="v1").
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "ctrc.cpp"
BUILD_ROOT = ROOT / "build" / "host"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libctrc.so"


def build() -> Path:
    """g++ native/ctrc.cpp into lib_path() unless it is there."""
    out = lib_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"libctrc.so.{os.getpid()}."
                            f"{threading.get_ident()}.tmp")
        subprocess.check_call(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)])
        os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, args in [
        ("ct_slz4_encode", [u8p, ctypes.c_int64, ctypes.c_uint32,
                            ctypes.c_uint32, u8p, ctypes.c_int64]),
        ("ct_slz4_decode", [u8p, ctypes.c_int64, u8p, ctypes.c_int64]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def slz4_encode(data, seg_log2: int = 17, lazy: bool = True) -> bytes:
    lib = load()
    x = np.frombuffer(bytes(data), np.uint8) \
        if not isinstance(data, np.ndarray) else data
    n = len(x)
    if n > 0xFFFFFFFF:
        raise ValueError(
            f"slz4 container rawSize is u32; input is {n} bytes")
    s = 1 << seg_log2
    n_segs = -(-n // s) if n else 0
    cap = n + n // 128 + 16 * max(n_segs, 1) + 4096
    out = np.empty(cap, np.uint8)
    sz = lib.ct_slz4_encode(_ptr(x), n, seg_log2, int(lazy), _ptr(out), cap)
    if sz < 0:
        raise RuntimeError("ct_slz4_encode failed")
    return out[:sz].tobytes()


def slz4_decode(blob) -> bytes:
    lib = load()
    b = np.frombuffer(bytes(blob), np.uint8)
    if len(b) < 4:
        raise CorruptContainerError("slz4 container shorter than header")
    n = int.from_bytes(bytes(blob[:4]), "little")
    out = np.empty(max(n, 1), np.uint8)
    sz = lib.ct_slz4_decode(_ptr(b), len(b), _ptr(out), n)
    if sz < 0:
        raise CorruptContainerError("native slz4 decode rejected container")
    return out[:sz].tobytes()
