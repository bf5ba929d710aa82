"""Offline ratio simulator for the shared-model K-lane adaptive coder.

The port's numpy copy of cpprcoder_tpu/bench/ratio_sim.py, held equal to
it by tests/test_torch_host_copies.py.

Computes the EXACT information content a CT-RC2-style coder would emit for
a given (K, update-window, inc, limit) without running the coder: the model
evolution (batched histogram adds + rescale) is deterministic, so
bits = sum over symbols of -log2(freq[s]/total) evaluated with the model
state at coding time, plus per-lane container overhead. Range-coding excess
over the entropy of the model is < 1e-4 and ignored.

Used to pick the lane policy: per-lane overhead (~4 bytes: flush tail +
size-table entry) trades against VPU occupancy; model-update deferral (the
window W = uf*K symbols coded against a frozen table) trades ratio against
per-step cost. Run:  python -m cpprcoder_tpu_torch.bench.ratio_sim
"""

from __future__ import annotations

import numpy as np

PER_LANE_BYTES = 4.0   # flush tail (~2) + size-table entry (~2)
HEADER_BYTES = 10.0


def simulate_bits(x: np.ndarray, k: int, uf: int, inc: int,
                  limit: int) -> float:
    """Ideal payload bits for chunked-lane layout, shared adaptive model
    updated every `uf` columns (window = uf*k symbols)."""
    n = len(x)
    c = -(-n // k)
    cols = np.full(k * c, 256, np.int32)   # 256 = inactive sentinel
    cols[:n] = x.astype(np.int32)
    cols = cols.reshape(k, c).T            # [c, k], column j = substep j
    freqs = np.ones(256, np.float64)
    total = 256.0
    bits = 0.0
    for j0 in range(0, c, uf):
        if total >= limit:
            freqs = np.floor(freqs / 2)
            np.maximum(freqs, 1, out=freqs)
            freqs = np.floor(freqs) // 1
            freqs = (freqs.astype(np.int64) | 1).astype(np.float64)
            total = freqs.sum()
        w = cols[j0: j0 + uf].reshape(-1)
        w = w[w < 256]
        if len(w) == 0:
            continue
        bits += len(w) * np.log2(total) - np.log2(freqs[w]).sum()
        hist = np.bincount(w, minlength=256).astype(np.float64)
        freqs = freqs + hist * inc
        total += inc * len(w)
    return bits


def simulate_ratio(x: np.ndarray, k: int, uf: int, inc: int,
                   limit: int) -> float:
    bits = simulate_bits(x, k, uf, inc, limit)
    return (bits / 8 + k * PER_LANE_BYTES + HEADER_BYTES) / len(x)


def main():
    import json
    import os

    data_dir = os.path.join(os.path.dirname(__file__), "..", "..", "data")
    ref = {"alice29.txt": 0.573000, "kennedy.xls": 0.447426,
           "lcet10.txt": 0.584625, "plrabn12.txt": 0.567367,
           "ptt5": 0.152158, "asyoulik.txt": 0.603400}
    for name, r in ref.items():
        x = np.frombuffer(open(os.path.join(data_dir, name), "rb").read(),
                          np.uint8)
        rows = []
        for k in (256, 512, 1024, 2048, 4096):
            for uf in (1, 4, 8):
                for inc, limit in ((24, 1 << 17), (32, 1 << 18),
                                   (48, 1 << 19), (16, 1 << 16)):
                    rows.append((simulate_ratio(x, k, uf, inc, limit),
                                 k, uf, inc, limit))
        rows.sort()
        best = rows[0]
        print(json.dumps({
            "file": name, "ref": r, "best_ratio": round(best[0], 5),
            "k": best[1], "uf": best[2], "inc": best[3],
            "limit_log2": best[4].bit_length() - 1,
            "top5": [(round(q[0], 5), q[1], q[2], q[3]) for q in rows[:5]],
            "k2048_best": min((q for q in rows if q[1] == 2048))[:4],
        }), flush=True)


if __name__ == "__main__":
    main()
