"""Build and load the Hopper kernels of `cpprcoder_tpu_torch/csrc/`.

The CUDA sources are compiled with nvcc for sm_90a into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
at first use, into `build/cuda/<source hash>/libcttorch.so` under the
repository root: one nvcc process per source, all started together, then
one link. The hash covers the sources and the flags, so an edited
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
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "cuda"
LIB_NAME = "libcttorch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32      # climit: a u32 up to 2^32 - 1
_L = ctypes.c_longlong    # a byte count past 2^31
SIGNATURES = {
    # x, lane_len, events, model scratch, streams, K, stride, inc,
    # climit, cbits, wlog, stream
    "ct_rcx_encode": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _P],
    # K, cbits -> model scratch bytes a stream (0: none)
    "ct_rcx_encode_scratch": [_I, _I],
    # the lane-range form: ct_rcx_encode's arguments, then l0, ko, stream
    "ct_rcx_encode_range": [_P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _I, _I,
                            _P],
    # events, may_drop mask (or null: drop_all for every lane), drop_all,
    # sizes, largest size (u64), E, K, stream
    "ct_expand_count": [_P, _P, _I, _P, _P, _I, _I, _P],
    # events, may_drop mask (or null), drop_all, rows, E, K, l2, stream
    "ct_expand_write": [_P, _P, _I, _P, _I, _I, _I, _P],
    # words, lane_len, out, model scratch, streams, K, l4, stride, inc,
    # climit, cbits, wlog, stream
    "ct_rcx_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _U, _I, _I, _P],
    # K, cbits -> model scratch bytes a stream (0: none)
    "ct_rcx_decode_scratch": [_I, _I],
    # the stepped lane-range form: words, lane_len, state, C, prev, xs, out,
    # streams, K, l4, l0, ko, t0, steps, np, inc, climit, cbits, wlog, stream
    "ct_rcx_decode_steps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _U, _I, _I, _P],
    # x, lane_len, events, K, stride, inc, climit, stream
    "ct_rcq_encode": [_P, _P, _P, _I, _I, _I, _U, _P],
    # the lane-range form: x, lane_len, events, K, stride, inc, climit, l0,
    # ko, stream
    "ct_rcq_encode_range": [_P, _P, _P, _I, _I, _I, _U, _I, _I, _P],
    # x, lane_len, events, state in, state out, C in, C out, K, steps, t0,
    # flush, inc, climit, stream
    "ct_rcq_encode_chunk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _U, _P],
    # words, lane_len, out, K, l4, stride, inc, climit, stream
    "ct_rcq_decode": [_P, _P, _P, _I, _I, _I, _I, _U, _P],
    # the stepped lane-range form: ct_rcx_decode_steps's arguments without
    # cbits and wlog
    "ct_rcq_decode_steps": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _U, _P],
    # x, lane_len, freq, cum, events, states, K, stride, stream
    "ct_rans_encode": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    # states, rows, lane_len, freq, cum, out, K, l2, stride, stream
    "ct_rans_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, lane_len, table, scratch, payload, counts, bits, K, stride, and the
    # geometry: lanes a block, steps a tile, chunks a lane, tiles, scan
    # lanes a block, scan blocks, payload words; stream
    "ct_huffman_encode_stream": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _P],
    # rows, lane_len, limits, bases, perm, out, K, l2, stride, stream
    "ct_huffman_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # x, lane_len, static freqs (or null: CT-RC2), events, K, stride, inc,
    # limit_log2, slots, stream
    "ct_rc_exact_encode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # the lane-range form: ct_rc_exact_encode's arguments, then l0, ko,
    # stream
    "ct_rc_exact_encode_range": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _P],
    # words, lane_len, static freqs (or null), out, K, l4, stride, inc,
    # limit_log2, slots, stream
    "ct_rc_exact_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # in, out, n, blocks, mtf1, stream
    "ct_mtf_encode": [_P, _P, _L, _I, _I, _P],
    "ct_mtf_decode": [_P, _P, _L, _I, _I, _P],
    # lz_encode.cu, kernel P (two launches): lcp, cand, lens, the scratch
    # rows and entries, mpos, mlen, moff, count, n, w, lb, lazy, tcap, stream
    "ct_lz_walk": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # kernel Q (two launches): rows, lens, mpos, mlen, moff, count, clamped
    # and tstart scratch, sizes, payload, n, w, tcap, stream
    "ct_lz_serialize": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # lz_decode.cu, kernel R: comp, bases, sizes, the next starts, exits,
    # token table, token count, byte source and round flag scratch, out,
    # err, n_segs, n, s, tcap, rounds, hops a round, stream
    "ct_lz_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _L, _L, _I,
                     _I, _I, _P],
    # ase.cu, kernel S (five launches): x, lane_len, scratch, bits,
    # payload, K, stride, steps a segment, stream
    "ct_ase_encode": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # kernel T: words, P, bases, counts, lane_len, out, K, stride, stream
    "ct_ase_decode": [_P, _L, _P, _P, _P, _P, _I, _I, _P],
    # o1_encode.cu, kernel U: x, lane_len, events, t1 (or null), the coder
    # state, the triples, the model between chunks (or null), the flag of a
    # step with t = 0, K, L, chunk, inc, limit1_log2, limit0_log2,
    # blend_log2, the model's form (o1_kernels.model_form), stream; its
    # model pass alone: x, lane_len, triples, t1, model (or null), K, L, j0,
    # j1, inc, limit1_log2, limit0_log2, blend_log2, form, stream; its coder pass alone: triples, events, state
    # (or null), flag, K, L, j0, j1, stream
    "ct_o1_encode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    "ct_o1_model": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "ct_o1_coder": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # o1_decode.cu, kernel V: words, lane_len, out, t1 and state scratch (or
    # null), flag, K, l4, L, inc, limit1_log2, limit0_log2, blend_log2, form,
    # stream
    "ct_o1_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # ans2_encode.cu, kernel W (three launches): x, scratch, entries, n, K,
    # steps, inc, limit_log2, r, n_snap, rows, stream
    "ct_ans2_model": [_P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P],
    # W's and Y's normalize alone: counts, entries, B, stream
    "ct_ans2_normalize": [_P, _P, _I, _P],
    # kernel X: x, lane_len, entries, events, states, K, stride, r, stream
    "ct_ans2_encode": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # ans2_decode.cu, kernel Y: words, n_words, states, state scratch (or
    # null), out, n, K, steps, inc, limit_log2, r, stream
    "ct_ans2_decode": [_P, _L, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
}


def nvcc_path() -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    return None


def sources(csrc: Path | None = None) -> list[Path]:
    csrc = csrc or CSRC
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def source_hash(csrc: Path | None = None) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources(csrc):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path(csrc: Path | None = None, root: Path | None = None) -> Path:
    return (root or BUILD_ROOT) / source_hash(csrc) / LIB_NAME


def build(csrc: Path | None = None, root: Path | None = None) -> Path:
    """Compile csrc/*.cu (default: the package's) into root/<source hash>/
    (default: BUILD_ROOT) unless the library for these sources exists: one
    nvcc per source in parallel, then one link. nvcc's output (with
    `-Xptxas -v` register and shared-memory counts) is kept in nvcc.log
    beside the library."""
    out = lib_path(csrc, root)
    if out.exists():
        return out
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    cus = sorted((csrc or CSRC).glob("*.cu"))
    # nvcc picks a file's role by its suffix, so the objects end in .o
    objs = [out.parent / f"{p.stem}.{tag}.o" for p in cus]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for p, o in zip(cus, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    (out.parent / "nvcc.log").write_text("".join(logs))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(p.name, pr.returncode, log) for p, pr, log
              in zip(cus, procs, logs) if pr.returncode != 0]
    if link is not None and link.returncode != 0:
        failed.append(("link", link.returncode, logs[-1]))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(
            f"{name} ({rc}):\n{log[-4000:]}" for name, rc, log in failed))
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
