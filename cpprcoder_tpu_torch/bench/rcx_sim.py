"""Exact ratio simulator for CT-RCX (context-conditioned quantized model).

The port's numpy copy of cpprcoder_tpu/bench/rcx_sim.py (its models from
the port's models/qmodel), held equal to it by
tests/test_torch_host_copies.py.

CT-RCX extends CT-RCQ (bench/rcq_sim.py) with an order-1 style context:
each lane codes symbol s against the quantized table of context
ctx = prev_symbol >> (8 - CBITS), where prev_symbol is the SAME lane's
previous symbol (time-major layout: available to encoder and decoder
alike, one window step earlier). Counts C[2^CBITS, 256] update per
K-symbol window; each context row rescales independently at climit.

This computes the exact information content (bits = -log2(q/QTOTAL) at
coding time) so context-width/inc/climit sweeps predict real container
sizes. Capability target: beat the reference adaptive coder's per-file
ratios (BASELINE.md, from its README) — the reference has no order-1
model at all; this is the TPU-native design going past it.

Run:  python -m cpprcoder_tpu_torch.bench.rcx_sim [files...]
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.models.qmodel import QRESERVE, QTOTAL


def simulate_bits_ctx(x: np.ndarray, k: int, inc: int, climit: int,
                      cbits: int) -> float:
    """Exact CT-RCX payload bits for one parameter point."""
    n = len(x)
    c = -(-n // k)
    cols = np.full(k * c, 256, np.int32)
    cols[:n] = x.astype(np.int32)
    cols = cols.reshape(k, c).T                  # [c, k] time-major
    nctx = 1 << cbits
    C = np.ones((nctx, 256), np.int64)
    bits = 0.0
    lg = np.log2(float(QTOTAL))
    prev = np.zeros(k, np.int32)                 # first-step context = 0
    for j in range(c):
        tot = C.sum(axis=1)
        hot = tot >= climit
        if hot.any():
            C[hot] = (C[hot] >> 1) | 1
        w = cols[j]
        valid = w < 256
        ctx = (prev >> (8 - cbits)) if cbits else np.zeros(k, np.int32)
        # quantize every context row at once (the kernel does the same)
        t = C.sum(axis=1, keepdims=True)
        q = np.maximum((C * (QTOTAL - QRESERVE)) // t, 1)
        am = np.argmax(q, axis=1)
        q[np.arange(nctx), am] += QTOTAL - q.sum(axis=1)
        s = w[valid]
        cs = ctx[valid]
        bits += len(s) * lg - np.log2(q[cs, s].astype(np.float64)).sum()
        np.add.at(C, (cs, s), inc)
        prev = np.where(valid, w, prev)
    return bits


def simulate_ratio_ctx(x, k, inc, climit, cbits,
                       per_lane: float = 4.0, header: float = 8.0) -> float:
    bits = simulate_bits_ctx(x, k, inc, climit, cbits)
    return (bits / 8 + k * per_lane + header + 2 * k) / len(x)


def main():
    import json
    import os
    import sys

    from cpprcoder_tpu_torch.models.qmodel import rcq_params

    data_dir = os.path.join(os.path.dirname(__file__), "..", "..", "data")
    ref = {"alice29.txt": 0.573000, "asyoulik.txt": 0.603400,
           "cp.html": 0.662480, "fields.c": 0.642511,
           "grammar.lsp": 0.619457, "kennedy.xls": 0.447426,
           "lcet10.txt": 0.584625, "plrabn12.txt": 0.567367,
           "ptt5": 0.152158, "sum": 0.670450, "xargs.1": 0.648924}
    names = sys.argv[1:] or list(ref)
    for name in names:
        x = np.frombuffer(open(os.path.join(data_dir, name), "rb").read(),
                          np.uint8)
        k, inc0, cl0 = rcq_params(len(x))
        best = {}
        for cbits in (3, 4, 5, 6, 8):
            rows = []
            for inc in (16, 32):
                if k * inc > 49152:
                    continue
                rows.append((round(simulate_ratio_ctx(
                    x, k, inc, 1 << 16, cbits), 5), inc))
            rows.sort()
            best[f"c{cbits}"] = rows[0]
        print(json.dumps(
            {"file": name, "ref": ref[name], "k": k} | best), flush=True)


if __name__ == "__main__":
    main()
