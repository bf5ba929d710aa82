"""Build and load the Hopper kernels of `cpprcoder_tpu_torch/csrc/`.

The CUDA sources are compiled with nvcc for sm_90a into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into `build/cuda/<source hash>/libcttorch.so` under the
repository root. The hash covers the sources and the flags, so an edited
kernel is rebuilt and an unchanged one is loaded as built. The library is
bound with ctypes; every entry point returns `cudaGetLastError()` after its
launch and `check` raises on a non-zero code.

Nothing here runs at import: the package imports on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cuda"
LIB_NAME = "libcttorch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x, lane_len, events, model scratch, streams, K, stride, inc,
    # climit, cbits, wlog, stream
    "ct_rcx_encode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # events, may_drop, sizes, E, K, stream
    "ct_expand_sizes": [_P, _P, _P, _I, _I, _P],
    # events, may_drop, rows, E, K, l2, stream
    "ct_expand_rows": [_P, _P, _P, _I, _I, _I, _P],
    # words, lane_len, out, model scratch, streams, K, l4, stride, inc,
    # climit, cbits, wlog, stream
    "ct_rcx_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    return None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    nvcc's output (with `-Xptxas -v` register and shared-memory counts)
    is kept in nvcc.log beside the library."""
    out = lib_path()
    if out.exists():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.ct_error_string.argtypes = [ctypes.c_int]
    lib.ct_error_string.restype = ctypes.c_char_p
    return lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = load().ct_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
