"""Exact ratio simulator for CT-RCQ (quantized windowed adaptive model).

The port's numpy copy of cpprcoder_tpu/bench/rcq_sim.py (its models from
the port's models/qmodel), held equal to it by
tests/test_torch_host_copies.py.

Unlike ratio_sim.py (ideal non-quantized CT-RC2 bits), this computes the
EXACT information content the RCQ coder emits: symbols are coded against
the quantized table Q = quantize(C) (Sum Q = 2^QBITS), so
bits = sum -log2(q[s] / QTOTAL), evaluated with the model state at coding
time, plus per-lane container overhead. Model evolution reuses
models.qmodel numpy twins, so parameter sweeps here predict real container
sizes to < 0.1% (range-coder excess only).

Run:  python -m cpprcoder_tpu_torch.bench.rcq_sim
"""

from __future__ import annotations

import numpy as np

from cpprcoder_tpu_torch.models.qmodel import QTOTAL, QRESERVE


def quantize_counts(C: np.ndarray) -> np.ndarray:
    C = C.astype(np.uint64)
    tot = C.sum()
    q = np.maximum((C * (QTOTAL - QRESERVE)) // tot, 1).astype(np.int64)
    q[int(np.argmax(q))] += QTOTAL - int(q.sum())
    return q


def simulate_bits(x: np.ndarray, k: int, inc: int, climit: int) -> float:
    """Exact RCQ payload bits: shared model, window = k symbols."""
    n = len(x)
    c = -(-n // k)
    cols = np.full(k * c, 256, np.int32)
    cols[:n] = x.astype(np.int32)
    cols = cols.reshape(k, c).T                 # [c, k]
    C = np.ones(256, np.int64)
    bits = 0.0
    lg = np.log2(float(QTOTAL))
    for j in range(c):
        if C.sum() >= climit:
            C = (C >> 1) | 1
        q = quantize_counts(C)
        w = cols[j]
        w = w[w < 256]
        if len(w) == 0:
            continue
        bits += len(w) * lg - np.log2(q[w].astype(np.float64)).sum()
        C = C + np.bincount(w, minlength=256).astype(np.int64) * inc
    return bits


def simulate_ratio(x: np.ndarray, k: int, inc: int, climit: int,
                   per_lane: float = 4.0, header: float = 8.0) -> float:
    bits = simulate_bits(x, k, inc, climit)
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
        rows = []
        for inc in (8, 16, 24, 32, 48, 64, 96):
            if k * inc > 49152 * 4:
                continue
            for cl in (15, 16, 17, 18):
                rows.append((simulate_ratio(x, k, inc, 1 << cl),
                             k, inc, cl))
        rows.sort()
        cur = simulate_ratio(x, k, inc0, 1 << cl0)
        print(json.dumps({
            "file": name, "ref": ref[name], "current": round(cur, 5),
            "cur_params": [k, inc0, cl0],
            "best": [round(rows[0][0], 5)] + list(rows[0][1:]),
            "top5": [[round(q[0], 5), q[2], q[3]] for q in rows[:5]],
        }), flush=True)


if __name__ == "__main__":
    main()
