"""Mesh-sharded CT-RC2 encode and the sharded histogram (counterpart of
cpprcoder_tpu/parallel/sharded.py), and what the sharded coders share.

Distribution, as in the JAX package:
  - 'data' axis: independent superblocks, one model each: a data shard
    codes its own blocks with the single-device kernels and needs no
    collective but the size scan;
  - 'lane' axis: the K lanes of a superblock split into ranges, one a rank
    of the lane group;
  - assembly: the shards' payload sizes are gathered over the world and
    scanned, so that each shard knows its byte offset in the final
    container (the JAX package's size-scan).

Where the JAX package psums the shared model's update over 'lane' at every
step (sharded.py:66), the port's encode needs no collective on 'lane':
every symbol is known before it starts, and every rank is given the whole
input (as the JAX package's sharded functions are), so each rank runs the
lane-range form of the encode kernel on its blocks' whole rows: the model
from all K lanes, exactly as on one device, the coder and the events for
the rank's own lanes. The model never leaves the kernel, so
the containers are the single-device ones. A decode cannot do that: step
t + 1's model needs every lane's step-t symbol and a rank decodes only its
own, so the decoders (sharded_rcq.py, sharded_rcx.py) exchange the symbols
once a step, between launches of the stepped lane-range decode kernels.
Where the lane group has one rank (world 1, or lane = 1) no collective
runs and the one-shot kernels code.

Each rank gives back its own shard (`Shard`): its lanes' events and
payload rows for its blocks (the events time-major [E, ko], the JAX
package's [K, E] per block transposed), its lane sizes, its total and its
offset. `gather_blocks` and `word_rows3d` stitch the shards on every rank
where a caller needs whole blocks (containers, the decoders' rows3d).

Each call leaves its seconds and its decode's exchanges in mesh.stats.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from cpprcoder_tpu_torch.ops import expand, layout, range_kernels
from cpprcoder_tpu_torch.parallel.mesh import (
    Mesh,
    group_sum,
    lane_gather,
    world_gather,
    world_objects,
)

@dataclass
class Shard:
    """One rank's part of a sharded encode: blocks `blocks` (its data
    shard's), lanes l0 .. l0 + ko - 1 of each."""
    blocks: range
    l0: int
    ko: int
    events: list          # a block: int32 [E, ko] on the device
    rows: list            # a block: payload rows uint8 [ko, L] (kernel B)
    lane_sizes: np.ndarray  # int32 [blocks, ko]
    total: int            # this shard's payload bytes
    totals: np.ndarray    # every shard's, rank order
    offset: int           # exclusive scan of totals at this rank


def interleaved_blocks(x: np.ndarray, blocks: int, k_global: int):
    """The JAX package's interleaved split: -> (x3d uint8 [blocks, steps,
    K], n_vec uint32 [blocks], steps, per_block); block b is x[b*per_block:
    ...][t*K + lane] at [b, t, lane]."""
    n = len(x)
    per_block = -(-n // blocks)
    steps = -(-per_block // k_global)
    padded = np.zeros(blocks * per_block, np.uint8)
    padded[:n] = x
    x3d = np.zeros((blocks, steps * k_global), np.uint8)
    x3d[:, :per_block] = padded.reshape(blocks, per_block)
    n_vec = np.minimum(per_block,
                       np.maximum(n - np.arange(blocks) * per_block, 0)
                       ).astype(np.uint32)
    return x3d.reshape(blocks, steps, k_global), n_vec, steps, per_block


def own_blocks(x3d: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's blocks of x3d [blocks, steps, K], every lane of them, on
    its device: [blocks/data, steps, K] (the lane-range encode reads every
    lane's symbols; each rank holds the whole input, so nothing crosses)."""
    bl = mesh.blocks(x3d.shape[0])
    return torch.from_numpy(np.ascontiguousarray(
        x3d[bl.start:bl.stop])).to(mesh.device)


def finish_shard(mesh: Mesh, blocks: range, k_global: int,
                 events: list) -> Shard:
    """The payload rows of each block's events (kernel B), the lane sizes,
    and the size scan over the world."""
    l0, ko = mesh.lanes(k_global)
    rows, sizes = [], []
    for ev in events:
        r, s = expand.materialize_rows(ev)
        rows.append(r)
        sizes.append(s.cpu().numpy())
    lane_sizes = np.stack(sizes).astype(np.int32) if sizes else \
        np.zeros((0, ko), np.int32)
    total = int(lane_sizes.astype(np.int64).sum())
    totals = world_gather(total, mesh)
    offsets = np.cumsum(totals) - totals
    return Shard(blocks, l0, ko, events, rows, lane_sizes, total, totals,
                 int(offsets[mesh.rank]))


def sharded_adaptive_encode(x: np.ndarray, mesh: Mesh,
                            blocks: int | None = None, k_global: int = 16,
                            inc: int = 24, limit_log2: int = 16):
    """Distributed CT-RC2 encode of `blocks` superblocks (default: one a
    data shard), interleaved lanes (step t of lane l is byte t*K + l of its
    block), with range_ops.slots' n_slots for K lanes (the JAX package's
    P4 rule, 2 up to limit_log2 16, agrees wherever K*inc + 512 <= 2^16).
    -> (this rank's Shard, (blocks, steps, per_block))."""
    blocks = blocks or mesh.data
    x3d, n_vec, steps, per_block = interleaved_blocks(x, blocks, k_global)
    t0 = time.perf_counter()
    full = own_blocks(x3d, mesh)
    l0, ko = mesh.lanes(k_global)
    mine = mesh.blocks(blocks)
    events = []
    for i, b in enumerate(mine):
        x2d = full[i].clone()   # 16-byte aligned, as kernel J reads it
        lens = layout.lane_lengths_interleaved(int(n_vec[b]), k_global,
                                               steps, x2d.device)
        if mesh.lane == 1:
            events.append(range_kernels.encode_events(x2d, lens, None, inc,
                                                      limit_log2))
        else:
            events.append(range_kernels.encode_events_range(
                x2d, lens, l0, ko, None, inc, limit_log2))
    shard = finish_shard(mesh, mine, k_global, events)
    mesh.stats.update(encode_s=time.perf_counter() - t0)
    return shard, (blocks, steps, per_block)


def sharded_histogram(x: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Global 256-bin histogram: x split over the world's ranks (as the
    JAX package's P(('data', 'lane'))), each rank's bincount summed over
    'lane' and then 'data', the padding's zeros taken back out. -> int64
    [256] on every rank."""
    n_dev = mesh.world
    pad = -(-max(len(x), 1) // n_dev) * n_dev
    padded = np.zeros(pad, np.uint8)
    padded[:len(x)] = x
    per = pad // n_dev
    part = torch.from_numpy(padded[mesh.rank * per:(mesh.rank + 1) * per]
                            .copy()).to(mesh.device)
    h = torch.bincount(part.to(torch.int64), minlength=256)
    group_sum(group_sum(h, mesh.lane_group, mesh), mesh.data_group, mesh)
    h = h.cpu().numpy().copy()
    h[0] -= pad - len(x)
    return h


# ------------------------------------------------------ stitching shards

def gather_blocks(shard: Shard, mesh: Mesh, k_global: int):
    """Every block's lane sizes int64 [K] and lane-major payload bytes,
    from every rank's shard (on every rank): -> list over the blocks of
    (sizes, payload uint8)."""
    mine = [(b, shard.l0, shard.lane_sizes[i],
             layout_payload(shard.rows[i], shard.lane_sizes[i]))
            for i, b in enumerate(shard.blocks)]
    parts: dict = {}
    for got in world_objects(mine, mesh):
        for b, l0, sizes, payload in got:
            parts.setdefault(b, {})[l0] = (sizes, payload)
    out = []
    for b in sorted(parts):
        lanes = [parts[b][l0] for l0 in sorted(parts[b])]
        sizes = np.concatenate([s for s, _ in lanes]).astype(np.int64)
        if len(sizes) != k_global:
            raise ValueError(f"block {b}: {len(sizes)} lanes, not {k_global}")
        out.append((sizes, np.concatenate([p for _, p in lanes])))
    return out


def layout_payload(rows: torch.Tensor, sizes: np.ndarray) -> np.ndarray:
    """Payload rows [ko, L] + sizes -> the lanes' bytes, lane after lane."""
    r = rows.cpu().numpy()
    keep = np.arange(r.shape[1])[None, :] < sizes.astype(np.int64)[:, None]
    return r[keep]


def word_rows3d(parts) -> np.ndarray:
    """gather_blocks' blocks -> rows3d uint32 [blocks, K, l4]: each lane's
    big-endian u32 word rows, zero past its end (the JAX package's
    `_rows_fn` per block; l4 from the data: the longest lane's words and one
    more)."""
    l4 = max(-(-int(s.max()) // 4) for s, _ in parts) + 1
    out = []
    for sizes, payload in parts:
        words = layout.word_rows(torch.from_numpy(payload.copy()),
                                 torch.from_numpy(sizes), l4)
        out.append(words.numpy().view(np.uint32).T)
    return np.ascontiguousarray(np.stack(out))


def own_words(rows3d: np.ndarray, mesh: Mesh, k_global: int) -> torch.Tensor:
    """This rank's part of rows3d [blocks, K, l4] (its blocks, its lanes;
    the JAX package's P('data', 'lane', None)) -> words int32 [blocks/data,
    l4, ko] on its device, word-major as the decode kernels read them."""
    l0, ko = mesh.lanes(k_global)
    mine = mesh.blocks(rows3d.shape[0])
    part = rows3d[mine.start:mine.stop, l0:l0 + ko, :].transpose(0, 2, 1)
    return torch.from_numpy(np.ascontiguousarray(part).view(np.int32)).to(
        mesh.device)


def stepped_decode(mesh: Mesh, words: torch.Tensor, lane_len: torch.Tensor,
                   steps: int, launch, state) -> np.ndarray:
    """The lane-sharded decode loop: a launch a step of the stepped
    lane-range kernel `launch(state, xs, t0)` -> [S, 1, ko], then the
    step's symbols gathered within the lane group for the next launch.
    -> this rank's symbols uint8 [S, steps, ko]."""
    n_s, _, ko = words.shape
    out = torch.empty((n_s, steps, ko), dtype=torch.uint8,
                      device=words.device)
    xs = torch.empty((n_s, 0, lane_len.shape[1]), dtype=torch.uint8,
                     device=words.device)
    before = mesh.stats.get("lane_gathers", 0)
    for t in range(steps):
        step = launch(state, xs, t)
        out[:, t:t + 1] = step
        if t + 1 < steps:   # the last step's symbols feed no launch
            xs = lane_gather(step, mesh).contiguous()
    mesh.stats.update(exchanges=mesh.stats.get("lane_gathers", 0) - before)
    return out.cpu().numpy()
