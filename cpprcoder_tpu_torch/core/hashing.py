"""XXH32 of a single u32 value (reference parity: the custom XXH32_u32
addition in test/xxhash.h:359,1970-1973, used as the SLZ4 dictionary hash at
test/slz4.h:196-201).

Implemented from the public XXH32 specification for the 4-byte small-input
path; host (numpy) and device (torch) twins. The CT-LZ4 match finder uses
exact substring ids instead of hashes, but the hash remains available for
hash-table style pipelines and is part of the component inventory.

(The port's own copy of cpprcoder_tpu/core/hashing.py: `xxh32_u32` and
`xxh32_u32_np` whole; `xxh32_u32_torch` takes the place of the jnp twin.)
"""

from __future__ import annotations

import numpy as np
import torch

P1 = 0x9E3779B1
P2 = 0x85EBCA77
P3 = 0xC2B2AE3D
P4 = 0x27D4EB2F
P5 = 0x165667B1
M = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M


def xxh32_u32(value: int, seed: int = 0) -> int:
    """Scalar python reference."""
    h = (seed + P5 + 4) & M
    h = (h + value * P3) & M
    h = (_rotl(h, 17) * P4) & M
    h ^= h >> 15
    h = (h * P2) & M
    h ^= h >> 13
    h = (h * P3) & M
    h ^= h >> 16
    return h


def xxh32_u32_np(values: np.ndarray, seed: int = 0) -> np.ndarray:
    v = values.astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(seed + P5 + 4) + v * np.uint32(P3)
        h = ((h << np.uint32(17)) | (h >> np.uint32(15))) * np.uint32(P4)
        h ^= h >> np.uint32(15)
        h *= np.uint32(P2)
        h ^= h >> np.uint32(13)
        h *= np.uint32(P3)
        h ^= h >> np.uint32(16)
    return h


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and a u32 constant `c`:
    c is split into 16-bit halves, so no product passes 2^48."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M


def xxh32_u32_torch(values: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """xxh32_u32 of every value (any integer dtype, taken mod 2^32), on the
    tensor's device -> int64 tensor of the hashes, each in [0, 2^32)."""
    v = values.to(torch.int64) & M
    h = ((seed + P5 + 4) & M) + mul_u32(v, P3) & M
    h = mul_u32(_rotl(h, 17), P4)
    h = mul_u32(h ^ (h >> 15), P2)
    h = mul_u32(h ^ (h >> 13), P3)
    return h ^ (h >> 16)
