"""Mesh-sharded CT-RCQ: distributed encode and decode (counterpart of
cpprcoder_tpu/parallel/sharded_rcq.py).

One superblock a data shard; its K interleaved lanes (lane i codes byte
j*K + i at step j) split over the lane group. The JAX package keeps the
model's counts on every lane shard and psums the step's update over
'lane' at every step of the encode (sharded_rcq.py:87) and of the decode
(:185). The port's encode exchanges nothing (every rank holds the whole
input) and runs kernel D's lane-range form (every lane's update, the
rank's lanes' coder); its decode runs kernel E's stepped lane-range form a
step a launch and gathers the step's symbols between launches. With one
rank a lane group, kernels D and E run as on one device. Either way the
containers are the single-device ones, byte for byte
(sharded.py has the design).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cpprcoder_tpu_torch.ops import layout, rc_common, rcq_kernels, rcx_ops
from cpprcoder_tpu_torch.parallel.mesh import Mesh
from cpprcoder_tpu_torch.parallel.sharded import (
    finish_shard,
    interleaved_blocks,
    own_blocks,
    own_words,
    stepped_decode,
)


def sharded_rcq_encode(x: np.ndarray, mesh: Mesh, k_global: int = 16,
                       inc: int = 24, climit_log2: int = 16):
    """Distributed encode of mesh.shape['data'] superblocks. -> (this
    rank's sharded.Shard, (blocks, steps, per_block))."""
    blocks = mesh.data
    x3d, n_vec, steps, per_block = interleaved_blocks(x, blocks, k_global)
    t0 = time.perf_counter()
    full = own_blocks(x3d, mesh)
    l0, ko = mesh.lanes(k_global)
    mine = mesh.blocks(blocks)
    events = []
    for i, b in enumerate(mine):
        nb = int(n_vec[b])
        lens = layout.lane_lengths_interleaved(nb, k_global, steps,
                                               full.device)
        climit = rc_common.climit_u32(climit_log2, nb, inc)
        if mesh.lane == 1:
            events.append(rcq_kernels.encode_events(full[i], lens, inc,
                                                    climit))
        else:
            events.append(rcq_kernels.encode_events_range(
                full[i], lens, l0, ko, inc, climit))
    shard = finish_shard(mesh, mine, k_global, events)
    mesh.stats.update(encode_s=time.perf_counter() - t0)
    return shard, (blocks, steps, per_block)


def sharded_rcq_decode(rows3d: np.ndarray, n_vec: np.ndarray, mesh: Mesh,
                       steps: int, k_global: int = 16, inc: int = 24,
                       climit_log2: int = 16) -> np.ndarray:
    """Distributed decode: rows3d uint32 [blocks, K, L4], each lane's
    big-endian word rows (sharded.word_rows3d), n_vec the blocks' byte
    counts. -> this rank's part of the decoded symbols, uint8 [blocks/data,
    steps, ko] (the JAX package's [blocks, steps, K] at its P('data', None,
    'lane') shard; 0 past a lane's end)."""
    t0 = time.perf_counter()
    words = own_words(rows3d, mesh, k_global)
    mine = mesh.blocks(rows3d.shape[0])
    l0, ko = mesh.lanes(k_global)
    lens = torch.stack([layout.lane_lengths_interleaved(
        int(n_vec[b]), k_global, steps, words.device) for b in mine])
    climit = rc_common.climit_u32(climit_log2, int(max(n_vec)), inc)
    if mesh.lane == 1:
        out = np.zeros((len(mine), steps * k_global), np.uint8)
        for i, b in enumerate(mine):
            nb = int(n_vec[b])
            out[i, :nb] = rcq_kernels.decode_symbols(
                words[i].contiguous(), lens[i], nb, steps, inc,
                climit).cpu().numpy()
        out = out.reshape(len(mine), steps, k_global)
        mesh.stats.update(exchanges=0)
    else:
        state = rcx_ops.decode_state(words, k_global, 0)
        out = stepped_decode(
            mesh, words, lens, steps,
            lambda st, xs, t: rcq_kernels.decode_steps(
                words, lens, st, xs, l0, t, inc, climit), state)
    mesh.stats.update(decode_s=time.perf_counter() - t0)
    return out
