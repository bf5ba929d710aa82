"""Kernel H and I wrappers: CT-HUF1 (canonical Huffman) on the card.

Kernel H (`csrc/huffman_encode.cu`) replaces
cpprcoder_tpu/ops/huffman_pallas.py:79 `_encode_kernel` and what its call
does around it (the lane layout and the compaction of the words): it
writes the container's payload bits directly. Each lane is cut into
chunks of CHUNK steps and every chunk is coded by its own thread: a
lengths pass sums each chunk's code lengths (and zeroes the payload
buffer), a scan turns them into bit offsets (in the lane, then across the
lanes' ceil(bits / 16) words), and a pack pass ORs the codes in at those
offsets. Kernel I
(`csrc/huffman_decode.cu`) replaces huffman_pallas.py:220 `_decode_kernel`:
one thread per lane, which keeps the lane's next words in flight
(cp.async into shared memory) and reads codes of up to 12 bits from a
table of (length, symbol) entries. Both take K up to 2^16.

Their plain versions are `huffman_ops.encode_stream_plain` (the step loop
`encode_events_plain`, then the compaction `lane_stream`) and
`huffman_ops.decode_symbols_plain`. On a CPU tensor a wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cpprcoder_tpu_torch.native import build
from cpprcoder_tpu_torch.ops import huffman_ops, layout

encode_launches = 0   # kernel H (its three passes count as one)
decode_launches = 0   # kernel I

MAX_LANES = 1 << 16   # the lane descriptor's largest log2 K that decodes

# kernel H's constants, as csrc/huffman_encode.cu has them (its entry point
# refuses a geometry that does not fit them)
CHUNK = 16            # steps of one lane a thread codes
TILE = 4096           # bytes of x a block stages in shared memory
SCAN_ROUND = 2048     # chunk sums a scan block takes at a time


class EncodeGeometry(NamedTuple):
    """Kernel H's launch: `tiles` x (K / lanes_a_block) blocks of
    TILE / CHUNK threads, a block taking steps_a_tile steps of
    lanes_a_block lanes; `chunks` chunks a lane; the scan in scan_blocks
    blocks of scan_lanes lanes; the payload in payload_words u32 words."""
    lanes_a_block: int
    steps_a_tile: int
    chunks: int
    tiles: int
    scan_lanes: int
    scan_blocks: int
    payload_words: int


def encode_geometry(stride: int, k: int, chunk: int = CHUNK,
                    tile: int = TILE) -> EncodeGeometry:
    """Kernel H's launch geometry for K lanes of `stride` steps (K a power
    of two, 1..MAX_LANES, as a container's lane descriptor needs; stride
    >= 1). Thread t of block (r, g) codes steps [r*T + (t // kb)*chunk,
    +chunk) of lane g*kb + t % kb, with kb = min(K, tile / chunk) lanes
    and T = tile / kb steps a tile."""
    _check_lane_count(k)
    if stride < 1:
        raise ValueError(f"kernel H needs stride >= 1, got {stride}")
    kb = min(k, tile // chunk)
    steps = tile // kb
    chunks = -(-stride // chunk)
    scan_lanes = min(k, max(1, SCAN_ROUND // chunks))
    return EncodeGeometry(kb, steps, chunks, -(-stride // steps), scan_lanes,
                          -(-k // scan_lanes),
                          huffman_ops.payload_words(stride, k))


def _check_lane_count(k: int):
    if not 1 <= k <= MAX_LANES or k & (k - 1):
        raise ValueError(f"kernel H takes a power of two of 1..{MAX_LANES} "
                         f"lanes, got {k}")


def _check_table(name: str, t: torch.Tensor, shape: tuple, like: torch.Tensor):
    if t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be int32 {list(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} must be on {like.device}, got {t.device}")


def encode_stream(x2d: torch.Tensor, lane_len: torch.Tensor,
                  tab: torch.Tensor):
    """x2d [stride, K] uint8 (interleaved: x2d[j, i] = x[j*K + i]; K a
    power of two) and the code table tab [2, 256] int32 (lengths, LSB-first
    codes) -> (payload int32 [huffman_ops.payload_words(stride, K)]: u32
    words of one LSB-first bit string, lane i's bits from bit 16 * (the
    word counts of the lanes before it), zero elsewhere, so its first
    2 * sum(counts) bytes are the container's payload; counts [K] int32,
    ceil(bits / 16); bits [K] int32). Nothing is read back to the host."""
    global encode_launches
    layout.check_lanes("x2d", x2d, torch.uint8, lane_len, MAX_LANES)
    _check_table("tab", tab, (2, 256), x2d)
    stride, k = x2d.shape
    _check_lane_count(k)
    if x2d.device.type == "cpu":
        return huffman_ops.encode_stream_plain(x2d, lane_len, tab)
    geo = encode_geometry(stride, k)
    if x2d.data_ptr() % 16:
        raise ValueError("kernel H reads x2d in 16-byte loads: it must start "
                         "16-byte aligned")
    out = encode_launch(x2d, lane_len, tab, geo, build.load())
    encode_launches += 1
    return out


def encode_launch(x2d, lane_len, tab, geo: EncodeGeometry, lib):
    """Kernel H's launch through `lib` (build.load(), or another build of
    the sources) at geometry `geo`: -> (payload, counts, bits), as
    encode_stream returns them."""
    stride, k = x2d.shape
    dev = x2d.device
    with torch.cuda.device(dev):
        scratch = torch.empty(k * geo.chunks + k, dtype=torch.int32,
                              device=dev)
        payload = torch.empty(geo.payload_words + 1, dtype=torch.int32,
                              device=dev)
        counts, bits = torch.empty((2, k), dtype=torch.int32, device=dev)
        rc = lib.ct_huffman_encode_stream(
            x2d.data_ptr(), lane_len.data_ptr(), tab.data_ptr(),
            scratch.data_ptr(), payload.data_ptr(), counts.data_ptr(),
            bits.data_ptr(), k, stride, *geo,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_huffman_encode_stream")
    return payload[:geo.payload_words], counts, bits


def decode_symbols(rows: torch.Tensor, lane_len: torch.Tensor,
                   limits: torch.Tensor, bases: torch.Tensor,
                   perm: torch.Tensor, n: int, stride: int) -> torch.Tensor:
    """rows [l2, K] int32 (u16 words, word-major, zero past each lane's
    count) and the canonical tables limits [16], bases [16], perm [256]
    (int32 holding u32 bits) -> uint8 [n] (byte j*K + i is lane i's step
    j)."""
    global decode_launches
    layout.check_lanes("rows", rows, torch.int32, lane_len, MAX_LANES)
    for name, t, shape in (("limits", limits, (16,)), ("bases", bases, (16,)),
                           ("perm", perm, (256,))):
        _check_table(name, t, shape, rows)
    l2, k = rows.shape
    if not 0 <= n <= k * stride:
        raise ValueError(f"n={n} does not fit {k} lanes of stride {stride}")
    if rows.device.type == "cpu":
        return huffman_ops.decode_symbols_plain(rows, lane_len, limits, bases,
                                                perm, n, stride)
    dev = rows.device
    lib = build.load()
    with torch.cuda.device(dev):
        out = torch.empty(k * stride, dtype=torch.uint8, device=dev)
        rc = lib.ct_huffman_decode(
            rows.data_ptr(), lane_len.data_ptr(), limits.data_ptr(),
            bases.data_ptr(), perm.data_ptr(), out.data_ptr(), k, l2, stride,
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "ct_huffman_decode")
    decode_launches += 1
    return out[:n]
