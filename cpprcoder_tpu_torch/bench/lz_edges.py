"""Inputs at the edges of kernel K (CT-LZ4's v2 match table,
csrc/lz_match_v2.cu), made from seeds: the CPU model's cases, the card
tests' and chip_smoke.py's. K groups each row's positions by their first 4
bytes (w0) in a hash table and sorts tiles of CAP = 4,096 keys in a CTA;
these rows sit on that design's edges."""

from __future__ import annotations

import numpy as np

CAP = 4096   # K's tile: keys a sort CTA

# A tail position whose zero-padded w0 ("ab\0\0" at L - 2) repeats in its
# row sorts between two copies of "ab\0\0\0" and keeps them apart: left out,
# the later copy would take the earlier one as its candidate.
TAIL_BARRIER = (b"xyab" + bytes(16) + b"\x05" + b"qqqq"
                + b"ab\x00\x00\x00\x07rstuvw" + b"mmmm" + b"ab")

# name -> what the row is
EDGES = {
    "tail barrier": "a tail position between two copies (TAIL_BARRIER)",
    f"group of {CAP - 1}": "one group of CAP - 1 positions",
    f"group of {CAP}": "one group of CAP positions",
    f"group of {CAP + 1}": "one group of CAP + 1 positions (the least large one)",
    "singletons": "20,000 random bytes, no 4-byte key twice",
    "ties on 16": "a 40-byte block 250 times: every group tied on 16 bytes",
    "collisions": "8 keys of one home slot, 4 times each, in 4,096 bytes",
}


def home_slot(k, s):
    """K's home slot of 4-byte keys k in a table of s slots (murmur3's
    finalizer, scaled to s): csrc/lz_match_v2.cu `home_slot`."""
    k = np.array(k, np.uint64)
    m = np.uint64(0xFFFFFFFF)
    k ^= k >> np.uint64(16)
    k = (k * np.uint64(0x85EBCA6B)) & m
    k ^= k >> np.uint64(13)
    k = (k * np.uint64(0xC2B2AE35)) & m
    k ^= k >> np.uint64(16)
    return ((k * np.uint64(s)) >> np.uint64(32)).astype(np.int64)


def group_of(m: int, seed: int = 3) -> bytes:
    """m units of the 4-byte key 01 02 03 04 and 4 random bytes of 5..255:
    one group of exactly m positions (the key nowhere else)."""
    r = np.random.default_rng(seed).integers(5, 256, (m, 4), np.uint8)
    key = np.tile(np.arange(1, 5, dtype=np.uint8), (m, 1))
    return np.concatenate([key, r], 1).tobytes()


def colliding_keys(n: int, count: int = 8, seed: int = 9) -> list[int]:
    """`count` distinct 4-byte keys with one home slot in the table of a
    row of n positions (2n slots)."""
    keys = np.random.default_rng(seed).integers(1 << 24, 1 << 32, 1 << 21, np.uint64)
    home = home_slot(keys, 2 * n)
    return [int(k) for k in np.unique(keys[home == np.bincount(home).argmax()])[:count]]


def collisions(n: int = 4096) -> bytes:
    """n bytes: colliding_keys(n), each 4 times with 3 random bytes after
    it (groups that probe past each other), then random bytes."""
    rng = np.random.default_rng(10)
    out = b""
    for k in colliding_keys(n):
        for _ in range(4):
            out += k.to_bytes(4, "big") + rng.integers(0, 256, 3, np.uint8).tobytes()
    return out + rng.integers(0, 256, n - len(out), np.uint8).tobytes()


def edge(name: str) -> bytes:
    """The row of EDGES[name]."""
    if name == "tail barrier":
        return TAIL_BARRIER
    if name.startswith("group of "):
        return group_of(int(name[len("group of "):]))
    if name == "singletons":
        return np.random.default_rng(62).integers(0, 256, 20_000, np.uint8).tobytes()
    if name == "ties on 16":
        return np.random.default_rng(77).integers(0, 256, 40, np.uint8).tobytes() * 250
    if name == "collisions":
        return collisions()
    raise KeyError(name)
