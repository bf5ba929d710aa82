"""Synthetic multi-block stream generator (BASELINE Config 5).

Deterministic, reproducible mix of regimes resembling a production stream:
text-like (skewed byte distribution), binary records (structured + noise),
long runs, and incompressible sections.

(The port's own copy of cpprcoder_tpu/bench/synth.py, whole.)
"""

from __future__ import annotations

import numpy as np


def synth_stream(total_bytes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    chunks = []
    made = 0
    text_probs = rng.dirichlet(np.ones(64) * 0.15)
    while made < total_bytes:
        kind = rng.integers(0, 4)
        size = int(min(rng.integers(1 << 14, 1 << 20), total_bytes - made))
        if kind == 0:  # text-like: 64-symbol skewed alphabet
            c = rng.choice(np.arange(32, 96, dtype=np.uint8), size,
                           p=text_probs)
        elif kind == 1:  # structured records with repeating template
            rec = rng.integers(0, 256, 64, dtype=np.uint8)
            reps = size // 64 + 1
            c = np.tile(rec, reps)[:size].copy()
            noise = rng.integers(0, size, size // 20)
            c[noise] = rng.integers(0, 256, len(noise), dtype=np.uint8)
        elif kind == 2:  # runs
            c = np.repeat(
                rng.integers(0, 256, max(size // 512, 1), dtype=np.uint8),
                512)[:size]
        else:  # incompressible
            c = rng.integers(0, 256, size, dtype=np.uint8)
        chunks.append(c.astype(np.uint8))
        made += size
    return np.concatenate(chunks)[:total_bytes]
