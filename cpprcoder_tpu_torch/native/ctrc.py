"""ctypes binding of the native host codec (the repository's
native/ctrc.cpp): the port's `backend="native"` of `slz4`, and the host
library's other entry points.

The port's own copy of the JAX package's host loader
(cpprcoder_tpu/native/__init__.py), which builds the same source: CT-RC1
(`static_encode`/`static_decode`), CT-RC2 (`adaptive_*`), CT-RCQ
(`rcq_*`), CT-RCX (`rcx_*`) and CT-LZ4 (`slz4_*`), each writing the
numpy oracle's containers byte for byte (slz4 the v1 parse's,
reference/slz4_ref.slz4_encode(parse="v1")), and `available()`. Only
`slz4` is a codec backend, as in the JAX package; the others serve
host-speed checks of large inputs. This copy builds the library with g++
at first use into `build/host/<source hash>/libctrc.so` under the
repository root (the hash covers the source and the flags), never next to
the source.
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
from cpprcoder_tpu_torch.models.cxmodel import WLOG_DEFAULT

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


def available() -> bool:
    """Whether the library builds (g++ is there) and loads."""
    try:
        load()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64, u32 = ctypes.c_int64, ctypes.c_uint32
    decode = [u8p, i64, u8p, i64]
    for name, args in [
        ("ct_static_encode", [u8p, i64, u32, u8p, i64]),
        ("ct_static_decode", decode),
        ("ct_adaptive_encode", [u8p, i64, u32, u32, u32, u8p, i64]),
        ("ct_adaptive_decode", decode),
        ("ct_rcq_encode", [u8p, i64, u32, u32, u32, u8p, i64]),
        ("ct_rcq_decode", decode),
        ("ct_rcx_encode", [u8p, i64, u32, u32, u32, u32, u32, u8p, i64]),
        ("ct_rcx_decode", decode),
        ("ct_slz4_encode", [u8p, i64, u32, u32, u8p, i64]),
        ("ct_slz4_decode", decode),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int64
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u8(data) -> np.ndarray:
    return data if isinstance(data, np.ndarray) \
        else np.frombuffer(bytes(data), np.uint8)


def _encode(name: str, data, cap_of, *args) -> bytes:
    """Call the library's encoder `name` on data with its parameters args,
    into a buffer of cap_of(n) bytes."""
    x = _u8(data)
    cap = cap_of(len(x))
    out = np.empty(cap, np.uint8)
    sz = getattr(load(), name)(_ptr(x), len(x), *args, _ptr(out), cap)
    if sz < 0:
        raise RuntimeError(f"{name} failed")
    return out[:sz].tobytes()


def _decode(name: str, blob) -> bytes:
    """Call the library's decoder `name` on a container whose header
    starts with its u32 byte count."""
    b = np.frombuffer(bytes(blob), np.uint8)
    if len(b) < 4:
        raise CorruptContainerError(f"{name}: container shorter than its "
                                    f"header")
    n = int.from_bytes(bytes(blob[:4]), "little")
    out = np.empty(max(n, 1), np.uint8)
    sz = getattr(load(), name)(_ptr(b), len(b), _ptr(out), n)
    if sz < 0:
        raise CorruptContainerError(f"{name} rejected the container")
    return out[:sz].tobytes()


def static_encode(data, lanes: int) -> bytes:
    """CT-RC1 at `lanes` lanes, rc_ref.static_encode's container."""
    return _encode("ct_static_encode", data,
                   lambda n: n + (n >> 3) + 16 * lanes + 4096, lanes)


def static_decode(blob) -> bytes:
    return _decode("ct_static_decode", blob)


def adaptive_encode(data, lanes: int, inc: int, limit_log2: int) -> bytes:
    """CT-RC2, rc_ref.adaptive_encode's container."""
    return _encode("ct_adaptive_encode", data,
                   lambda n: n + (n >> 3) + 16 * lanes + 4096, lanes, inc,
                   limit_log2)


def adaptive_decode(blob) -> bytes:
    return _decode("ct_adaptive_decode", blob)


def rcq_encode(data, lanes: int, inc: int, climit_log2: int) -> bytes:
    """CT-RCQ, rcq_ref.rcq_encode's container."""
    return _encode("ct_rcq_encode", data,
                   lambda n: 2 * n + 16 * lanes + 4096, lanes, inc,
                   climit_log2)


def rcq_decode(blob) -> bytes:
    return _decode("ct_rcq_decode", blob)


def rcx_encode(data, lanes: int, inc: int, climit_log2: int, cbits: int,
               wlog: int | None = None) -> bytes:
    """CT-RCX, rcx_ref.rcx_encode's container (wlog WLOG_DEFAULT unless
    given)."""
    return _encode("ct_rcx_encode", data,
                   lambda n: 2 * n + 16 * lanes + 4096, lanes, inc,
                   climit_log2, cbits, WLOG_DEFAULT if wlog is None else wlog)


def rcx_decode(blob) -> bytes:
    return _decode("ct_rcx_decode", blob)


def slz4_encode(data, seg_log2: int = 17, lazy: bool = True) -> bytes:
    """CT-LZ4's v1 parse, slz4_ref.slz4_encode(parse="v1")'s container."""
    n = len(_u8(data))
    if n > 0xFFFFFFFF:
        raise ValueError(
            f"slz4 container rawSize is u32; input is {n} bytes")
    n_segs = -(-n // (1 << seg_log2)) if n else 0
    return _encode("ct_slz4_encode", data,
                   lambda n: n + n // 128 + 16 * max(n_segs, 1) + 4096,
                   seg_log2, int(lazy))


def slz4_decode(blob) -> bytes:
    return _decode("ct_slz4_decode", blob)
