#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's CT-RCX main path once on one GPU.

    python3 chip_smoke.py

Phases, one line each (a failed phase exits non-zero):
  1. env      the card, torch, nvcc and `nvidia-smi` name/power limit;
  2. build    nvcc builds the kernels of cpprcoder_tpu_torch/csrc/;
  3. kernels  each kernel (A encode, B expand, C decode) against its plain
              PyTorch version on the card, on seeded inputs at the main
              path's shapes, exact equality; then both timed with CUDA
              events at kennedy.xls's shape;
  4. main     compress/decompress(codec="rcx", device="cuda") over the 11
              Canterbury files: byte-identical to the numpy oracle, the
              known container sizes, a round trip; the ratio preset on
              three files; every kernel's launch count must move.
Then a {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.models.cxmodel import rcx_params
from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import compaction, expand, rcx_kernels, rcx_ops

ROOT = os.path.dirname(os.path.abspath(__file__))
MASK32 = 0xFFFFFFFF

# CT-RCX container bytes with the balanced preset (numpy oracle); a
# container's bytes do not depend on the device
EXPECTED_SIZES = {
    "alice29.txt": 80192, "asyoulik.txt": 65110, "cp.html": 14001,
    "fields.c": 5623, "grammar.lsp": 2015, "kennedy.xls": 449071,
    "lcet10.txt": 232081, "plrabn12.txt": 249999, "ptt5": 70628,
    "sum": 20359, "xargs.1": 2534,
}
RATIO_FILES = ["alice29.txt", "kennedy.xls", "ptt5"]


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def corpus(name: str) -> bytes:
    with open(os.path.join(ROOT, "data", name), "rb") as f:
        return f.read()


def textish(n: int, seed: int) -> bytes:
    """Half lowercase letters, half random bytes (seeded)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


def rand_events(e: int, k: int, seed: int, run_max: int = 5) -> np.ndarray:
    """Random packed u32 event grid [e, k] as int32 bits."""
    rng = np.random.default_rng(seed)
    emit = rng.random((e, k)) < 0.5
    first = rng.integers(0, 256, (e, k), dtype=np.uint32)
    carry = rng.integers(0, 2, (e, k), dtype=np.uint32)
    run = rng.integers(0, run_max + 1, (e, k), dtype=np.uint32)
    ev = (np.uint32(1) << 31) | (first << 23) | (carry << 22) | run
    return np.where(emit, ev, 0).astype(np.uint32).view(np.int32)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| of two integer tensors, int32 read as u32."""
    a, b = a.to(torch.int64), b.to(torch.int64)
    if a.numel() == 0:
        return 0
    return int(((a & MASK32) - (b & MASK32)).abs().max())


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_env():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    name = torch.cuda.get_device_name(0)
    nvcc = build.nvcc_path()
    nvcc_ver = "missing"
    if nvcc:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True).stdout.strip().splitlines()
        nvcc_ver = out[-1] if out else "?"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[env] ok device={name!r} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"nvcc={nvcc_ver!r} smi={smi_line!r}", flush=True)
    return name, smi_line


def phase_build():
    t0 = time.perf_counter()
    path = build.build()
    build.load()
    dt = time.perf_counter() - t0
    log = (path.parent / "nvcc.log").read_text()
    usage = [ln.split("ptxas info    :")[-1].strip() for ln in log.splitlines()
             if "Used" in ln or "Compiling entry" in ln]
    print(f"[build] ok {os.path.relpath(path, ROOT)} in {dt:.2f} s; "
          f"ptxas: {' | '.join(usage)}", flush=True)


def word_rows_of(rows: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Decode word rows of expanded payload rows, through the flat lane
    payload a container holds."""
    keep = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        < sizes[:, None].to(torch.int64)
    return rcx_ops.word_rows(rows[keep], sizes, -(-int(sizes.max()) // 4) + 1)


def phase_kernels(dev):
    err = {"rcx_encode": 0, "expand": 0, "rcx_decode": 0}

    def coder_inputs(data, k):
        n = len(data)
        stride = -(-n // k)
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
        return (n, stride, rcx_ops.pad2d_chunked(x, k, stride),
                rcx_ops.lane_lengths(n, k, stride, dev))

    # A and C: K in {32, 1024, 2048}, cbits in {4, 5, 6, 8}, wlog in {0, 2}
    cases = [(32, 6, 2, 3000), (32, 8, 0, 2500), (1024, 5, 0, 150_000),
             (1024, 8, 2, 60_000), (2048, 4, 2, 1_029_744),
             (2048, 6, 0, 200_000), (2048, 8, 2, 300_000)]
    for i, (k, cbits, wlog, n) in enumerate(cases):
        data = textish(n, seed=100 + i)
        _, inc, cl, _ = rcx_params(n, lanes=k, cbits=cbits)
        n, stride, x2d, lens = coder_inputs(data, k)
        args = (inc, 1 << cl, cbits, wlog)
        ev_k = rcx_kernels.encode_events(x2d, lens, *args)
        ev_p = rcx_ops.encode_events_plain(x2d, lens, *args)
        torch.cuda.synchronize()
        err["rcx_encode"] = max(err["rcx_encode"], max_err(ev_k, ev_p))
        if not torch.equal(ev_k, ev_p):
            fail(f"kernel A != plain at K={k} cbits={cbits} wlog={wlog}")
        words = word_rows_of(*compaction.materialize_rows_t(ev_p))
        sym_k = rcx_kernels.decode_symbols(words, lens, n, stride, *args)
        sym_p = rcx_ops.decode_symbols_plain(words, lens, n, stride, *args)
        torch.cuda.synchronize()
        err["rcx_decode"] = max(err["rcx_decode"], max_err(sym_k, sym_p))
        if not torch.equal(sym_k, sym_p):
            fail(f"kernel C != plain at K={k} cbits={cbits} wlog={wlog}")
        if sym_k.cpu().numpy().tobytes() != data:
            fail(f"kernel C did not invert kernel A at K={k} cbits={cbits}")

    # B: random grids (non-aligned E/K, a may_drop mask, an empty lane)
    # and the real event grid of the last coder case
    grids = [(rand_events(18, 8, 0), True), (rand_events(257, 200, 1), True),
             (rand_events(1008, 2048, 2, run_max=40), True)]
    masked = rand_events(130, 96, 3)
    masked[:, 5] = 0
    md = np.zeros(96, bool)
    md[::3] = True
    grids += [(masked, md), (ev_p.cpu().numpy(), True)]
    for ev_np, may_drop in grids:
        ev = torch.from_numpy(np.ascontiguousarray(ev_np)).to(dev)
        md_t = may_drop if isinstance(may_drop, bool) else \
            torch.from_numpy(may_drop).to(dev)
        rows_k, sizes_k = expand.materialize_rows(ev, may_drop=md_t)
        rows_p, sizes_p = compaction.materialize_rows_t(ev, rows_k.shape[1],
                                                        md_t)
        torch.cuda.synchronize()
        err["expand"] = max(err["expand"], max_err(rows_k, rows_p),
                            max_err(sizes_k, sizes_p))
        if not (torch.equal(rows_k, rows_p) and torch.equal(sizes_k, sizes_p)):
            fail(f"kernel B != plain on a {tuple(ev.shape)} grid")

    # times at kennedy.xls's shape (balanced preset), kernel vs plain
    data = corpus("kennedy.xls")
    k, inc, cl, cbits = rcx_params(len(data))
    n, stride, x2d, lens = coder_inputs(data, k)
    args = (inc, 1 << cl, cbits, 2)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    rows, sizes = expand.materialize_rows(ev)
    words = word_rows_of(rows, sizes)
    l2 = rows.shape[1]
    ms = {
        "rcx_encode": (
            cuda_ms(lambda: rcx_kernels.encode_events(x2d, lens, *args), 5),
            cuda_ms(lambda: rcx_ops.encode_events_plain(x2d, lens, *args), 2)),
        "expand": (
            cuda_ms(lambda: expand.materialize_rows(ev), 5),
            cuda_ms(lambda: compaction.materialize_rows_t(ev, l2), 2)),
        "rcx_decode": (
            cuda_ms(lambda: rcx_kernels.decode_symbols(
                words, lens, n, stride, *args), 5),
            cuda_ms(lambda: rcx_ops.decode_symbols_plain(
                words, lens, n, stride, *args), 2)),
    }
    print(f"[kernels] ok {len(cases)} coder cases (A, C) and {len(grids)} "
          f"event grids (B) equal their plain versions; at kennedy.xls "
          f"(K={k}, stride={stride}, cbits={cbits}, wlog=2) ms kernel/plain: "
          + ", ".join(f"{nm} {a:.3f}/{b:.3f}" for nm, (a, b) in ms.items()),
          flush=True)
    return err, ms


def phase_main():
    rcx_kernels.encode_launches = 0
    rcx_kernels.decode_launches = 0
    expand.launches = 0
    total = raw = 0
    enc_s = dec_s = 0.0
    for name, want in EXPECTED_SIZES.items():
        data = corpus(name)
        t0 = time.perf_counter()
        blob = ctt.compress(data, codec="rcx", device="cuda")
        t1 = time.perf_counter()
        back = ctt.decompress(blob, codec="rcx", device="cuda")
        t2 = time.perf_counter()
        ref = ctt.compress(data, codec="rcx", backend="ref")
        if blob != ref:
            fail(f"{name}: container differs from the numpy oracle")
        if len(blob) != want:
            fail(f"{name}: {len(blob)} container bytes, expected {want}")
        if back != data:
            fail(f"{name}: decode did not return the input")
        total += len(blob)
        raw += len(data)
        enc_s += t1 - t0
        dec_s += t2 - t1
        print(f"[main] {name} n={len(data)} bytes={len(blob)} "
              f"ratio={len(blob) / len(data):.4f} enc_s={t1 - t0:.4f} "
              f"dec_s={t2 - t1:.4f}", flush=True)
    for name in RATIO_FILES:
        data = corpus(name)
        k = rcx_params(len(data), mode="ratio")[0]
        t0 = time.perf_counter()
        blob = ctt.compress(data, codec="rcx", device="cuda", mode="ratio")
        t1 = time.perf_counter()
        back = ctt.decompress(blob, codec="rcx", device="cuda")
        t2 = time.perf_counter()
        ref = ctt.compress(data, codec="rcx", backend="ref", lanes=k,
                           cbits=6, wlog=0)
        if blob != ref:
            fail(f"{name} (ratio): container differs from the numpy oracle")
        if back != data:
            fail(f"{name} (ratio): decode did not return the input")
        print(f"[main] {name} mode=ratio K={k} bytes={len(blob)} "
              f"ratio={len(blob) / len(data):.4f} enc_s={t1 - t0:.4f} "
              f"dec_s={t2 - t1:.4f}", flush=True)
    launches = {"rcx_encode": rcx_kernels.encode_launches,
                "expand": expand.launches,
                "rcx_decode": rcx_kernels.decode_launches}
    if total != sum(EXPECTED_SIZES.values()):
        fail(f"corpus total {total} != {sum(EXPECTED_SIZES.values())}")
    idle = [nm for nm, c in launches.items() if c == 0]
    if idle:
        fail(f"kernels never launched on the main path: {idle}")
    print(f"[main] ok 11 files byte-identical, total {total} bytes "
          f"(ratio {total / raw:.4f}), enc_s={enc_s:.4f} dec_s={dec_s:.4f}; "
          f"{len(RATIO_FILES)} ratio-preset files; launches {launches}",
          flush=True)
    return launches


KERNELS = [
    ("rcx_encode", "cpprcoder_tpu_torch/csrc/rcx_encode.cu",
     "cpprcoder_tpu/ops/rcx_pallas.py:163"),
    ("expand", "cpprcoder_tpu_torch/csrc/expand.cu",
     "cpprcoder_tpu/ops/expand_pallas.py:55"),
    ("rcx_decode", "cpprcoder_tpu_torch/csrc/rcx_decode.cu",
     "cpprcoder_tpu/ops/rcx_pallas.py:374"),
]


def main():
    name, smi_line = phase_env()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    err, ms = phase_kernels(dev)
    launches = phase_main()
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[nm], "max_abs_err": err[nm],
         "ms": ms[nm][0], "plain_ms": ms[nm][1]}
        for nm, src, rep in KERNELS]}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
