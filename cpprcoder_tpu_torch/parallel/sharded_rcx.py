"""Mesh-sharded CT-RCX: distributed encode and decode (counterpart of
cpprcoder_tpu/parallel/sharded_rcx.py).

Chunked lanes: lane i of a block owns bytes x[i*stride:(i+1)*stride] of
it, so a lane range is a contiguous slab of the block. Each block carries
its own stride, ceil(n_b / K) (a partial tail block too), so every block's
container is the single-device encoder's; the model is requantized every
step (wlog = 0), the JAX package's sharded schedule. Its psum of the
[2^cbits, 256] window update over 'lane' at every step (sharded_rcx.py:89,
:179) becomes, in the port, no collective in the encode (every rank holds
the whole input; kernel A's lane-range form reads every lane of it) and,
in the decode, kernel C's
stepped lane-range form a step a launch with the step's symbols gathered
between launches (sharded.py has the design). A data shard's blocks run
one after the other in the encode and as the streams of one launch in the
decode; all of them at the blocks' largest stride, the lanes of a shorter
block idle past their own (their events zero, as the JAX package's).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cpprcoder_tpu_torch.ops import layout, rc_common, rcx_kernels, rcx_ops
from cpprcoder_tpu_torch.parallel.mesh import Mesh
from cpprcoder_tpu_torch.parallel.sharded import (
    finish_shard,
    own_blocks,
    own_words,
    stepped_decode,
)

WLOG = 0   # the sharded schedule: a requant every step


def block_layout(n: int, blocks: int, k_global: int):
    """(n_vec, stride_vec, steps, per_block): per-block byte counts and
    chunk strides (stride_b = ceil(n_b / K), at least 1), steps = the
    largest stride."""
    per_block = -(-n // blocks)
    n_vec = np.minimum(per_block,
                       np.maximum(n - np.arange(blocks) * per_block, 0)
                       ).astype(np.uint32)
    stride_vec = -(-n_vec.astype(np.int64) // k_global)
    stride_vec = np.maximum(stride_vec, 1).astype(np.int32)
    return n_vec, stride_vec, int(stride_vec.max()), per_block


def chunked_blocks(x: np.ndarray, blocks: int, k_global: int):
    """-> (x3d uint8 [blocks, steps, K] with x3d[b, j, i] = byte i*stride_b
    + j of block b, n_vec, stride_vec, steps, per_block)."""
    n = len(x)
    n_vec, stride_vec, steps, per_block = block_layout(n, blocks, k_global)
    padded = np.zeros(blocks * per_block, np.uint8)
    padded[:n] = x
    xb = padded.reshape(blocks, per_block)
    x3d = np.zeros((blocks, steps, k_global), np.uint8)
    for b in range(blocks):
        st = int(stride_vec[b])
        buf = np.zeros(k_global * st, np.uint8)
        buf[:n_vec[b]] = xb[b, :n_vec[b]]
        x3d[b, :st] = buf.reshape(k_global, st).T
    return x3d, n_vec, stride_vec, steps, per_block


def _lane_lengths(n_vec, stride_vec, mine, k_global, device):
    return torch.stack([layout.lane_lengths(
        int(n_vec[b]), k_global, int(stride_vec[b]), device) for b in mine])


def sharded_rcx_encode(x: np.ndarray, mesh: Mesh, blocks: int | None = None,
                       k_global: int = 64, inc: int = 16,
                       climit_log2: int = 16, cbits: int = 4):
    """Distributed encode of `blocks` superblocks (a multiple of the mesh's
    'data' extent). -> (this rank's sharded.Shard, (blocks, n_vec,
    stride_vec, steps)); each block's events [2*steps+2, ko]."""
    blocks = blocks or mesh.data
    x3d, n_vec, stride_vec, steps, _ = chunked_blocks(x, blocks, k_global)
    t0 = time.perf_counter()
    full = own_blocks(x3d, mesh)
    l0, ko = mesh.lanes(k_global)
    mine = mesh.blocks(blocks)
    lens = _lane_lengths(n_vec, stride_vec, mine, k_global, full.device)
    climit = rc_common.climit_u32(climit_log2, int(n_vec.max()), inc)
    events = []
    for i in range(len(mine)):
        if mesh.lane == 1:
            events.append(rcx_kernels.encode_events(
                full[i], lens[i], inc, climit, cbits, WLOG))
        else:
            events.append(rcx_kernels.encode_events_range(
                full[i], lens[i], l0, ko, inc, climit, cbits, WLOG))
    shard = finish_shard(mesh, mine, k_global, events)
    mesh.stats.update(encode_s=time.perf_counter() - t0)
    return shard, (blocks, n_vec, stride_vec, steps)


def sharded_rcx_decode(rows3d: np.ndarray, n_vec: np.ndarray,
                       stride_vec: np.ndarray, mesh: Mesh, steps: int,
                       k_global: int = 64, inc: int = 16,
                       climit_log2: int = 16, cbits: int = 4) -> np.ndarray:
    """Distributed decode: rows3d uint32 [blocks, K, L4] (sharded.
    word_rows3d). -> this rank's part of the symbols, uint8 [blocks/data,
    steps, ko] (chunked: [b, j, i] is byte (l0 + i)*stride_b + j of block
    b; 0 past a lane's end, and past the block's stride)."""
    t0 = time.perf_counter()
    words = own_words(rows3d, mesh, k_global)
    mine = mesh.blocks(rows3d.shape[0])
    l0, ko = mesh.lanes(k_global)
    lens = _lane_lengths(n_vec, stride_vec, mine, k_global, words.device)
    climit = rc_common.climit_u32(climit_log2, int(np.max(n_vec)), inc)
    if mesh.lane == 1:
        out = np.zeros((len(mine), steps, k_global), np.uint8)
        for i, b in enumerate(mine):
            nb, st = int(n_vec[b]), int(stride_vec[b])
            flat = np.zeros(k_global * st, np.uint8)
            flat[:nb] = rcx_kernels.decode_symbols(
                words[i].contiguous(), lens[i], nb, st, inc, climit, cbits,
                WLOG).cpu().numpy()
            out[i, :st] = flat.reshape(k_global, st).T
        mesh.stats.update(exchanges=0)
    else:
        state = rcx_ops.decode_state(words, k_global, cbits)
        out = stepped_decode(
            mesh, words, lens, steps,
            lambda st, xs, t: rcx_kernels.decode_steps(
                words, lens, st, xs, l0, t, 1, inc, climit, cbits, WLOG),
            state)
    mesh.stats.update(decode_s=time.perf_counter() - t0)
    return out
