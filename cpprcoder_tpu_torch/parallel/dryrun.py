"""`dryrun_multichip(n)`: the whole distributed path over a world of n ranks
on tiny shapes, every assertion of the JAX package's
`__graft_entry__.dryrun_multichip` (__graft_entry__.py:38-173), with the
rank entry functions the port's tools and tests start worlds with.

In each rank of a data x lane mesh (lane = 2 where n is even and larger
than 1):
  - CT-RCX: 64 lanes over 'lane', two superblocks a data shard, a partial
    tail block with its own stride, the model requantized every step
    (wlog = 0); each block's payload against rcx_ref's container at wlog =
    0 and the port's single-device container; block 0 re-assembled with a
    wide (u32) size table and decoded by the single-device path; the mesh
    decode of every block against the input;
  - the histogram summed over both axes;
  - CT-RCQ: 4 * lane lanes, the encode's payloads against rcq_ref's and the
    single-device containers, and the mesh decode;
  - and, beyond the JAX dryrun, CT-RC2's sharded encode (kernel J's path,
    tests/test_sharded.py's in the JAX package): two blocks a data shard,
    each container against rc_ref's and the single-device one.
The checks that need whole blocks run on rank 0, after every rank's shard
is gathered there (sharded.gather_blocks); a failed check raises in that
rank, which ends the world (spawn.run raises).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cpprcoder_tpu_torch.core.bytesutil import ByteWriter
from cpprcoder_tpu_torch.models.cxmodel import QBITS
from cpprcoder_tpu_torch.ops import (
    expand,
    range_kernels,
    range_ops,
    rcq_kernels,
    rcq_ops,
    rcx_kernels,
    rcx_ops,
)
from cpprcoder_tpu_torch.parallel import sharded, spawn
from cpprcoder_tpu_torch.parallel.mesh import (
    Mesh,
    lane_gather,
    make_mesh,
    world_objects,
)
from cpprcoder_tpu_torch.parallel.sharded_rcq import (
    sharded_rcq_decode,
    sharded_rcq_encode,
)
from cpprcoder_tpu_torch.parallel.sharded_rcx import (
    WLOG,
    sharded_rcx_decode,
    sharded_rcx_encode,
)
from cpprcoder_tpu_torch.reference import rc_ref, rcq_ref, rcx_ref
from cpprcoder_tpu_torch.reference.rc_ref import _lane_desc, _write_sizes

# the kernels of the sharded paths: name -> (wrapper module, its counter);
# a lane-range or stepped form counts apart from its one-shot kernel
COUNTERS = {
    "rcx_encode": (rcx_kernels, "encode_launches"),
    "rcx_encode_range": (rcx_kernels, "range_launches"),
    "expand": (expand, "launches"),
    "rcx_decode": (rcx_kernels, "decode_launches"),
    "rcx_decode_steps": (rcx_kernels, "steps_launches"),
    "rcq_encode": (rcq_kernels, "encode_launches"),
    "rcq_encode_range": (rcq_kernels, "range_launches"),
    "rcq_decode": (rcq_kernels, "decode_launches"),
    "rcq_decode_steps": (rcq_kernels, "steps_launches"),
    "rc_exact_encode": (range_kernels, "encode_launches"),
    "rc_exact_encode_range": (range_kernels, "range_launches"),
}
# each form's counter -> its kernel's
FORMS = {"rcx_encode_range": "rcx_encode", "rcx_decode_steps": "rcx_decode",
         "rcq_encode_range": "rcq_encode", "rcq_decode_steps": "rcq_decode",
         "rc_exact_encode_range": "rc_exact_encode"}
# this process's launches inside the sharded calls (`counted`), without
# those of the single-device checks beside them
SHARDED = dict.fromkeys(COUNTERS, 0)


def check(ok: bool, what: str) -> None:
    """A dryrun check: raise AssertionError with `what` unless ok (an
    explicit raise, which python -O keeps)."""
    if not ok:
        raise AssertionError(what)


def check_offset(shard: sharded.Shard, mesh: Mesh) -> None:
    check((np.cumsum(shard.totals) - shard.totals)[mesh.rank] == shard.offset,
          "offset != exclusive scan of the shard totals")


def launch_counts() -> dict:
    """This process's launches of the sharded paths' kernels."""
    return {nm: getattr(mod, attr) for nm, (mod, attr) in COUNTERS.items()}


def counted(fn, *args, **kwargs):
    """fn(*args, **kwargs), a sharded call, its kernels' launches added to
    SHARDED."""
    before = launch_counts()
    try:
        return fn(*args, **kwargs)
    finally:
        for nm, c in launch_counts().items():
            SHARDED[nm] += c - before[nm]


def stitch(parts: list, blocks: int, steps: int, k_global: int) -> np.ndarray:
    """Every rank's decode output [blocks/data, steps, ko], rank order ->
    [blocks, steps, K] (the JAX package's out_specs P('data', None,
    'lane'))."""
    out = np.zeros((blocks, steps, k_global), np.uint8)
    for (bl, l0), part in parts:
        out[bl.start:bl.stop, :, l0:l0 + part.shape[2]] = part
    return out


def decoded_parts(out: np.ndarray, mesh: Mesh, blocks: int, k_global: int):
    l0, _ = mesh.lanes(k_global)
    return world_objects(((mesh.blocks(blocks), l0), out), mesh)


def rcx_container(sizes, payload, n, k, inc, climit_log2, cbits,
                  wide: bool) -> bytes:
    """A CT-RCX container of the given lane payloads at wlog = 0."""
    w = (ByteWriter().u32(n).u8(_lane_desc(k, wide)).u8(inc)
         .u8(climit_log2).u8(QBITS).u8(cbits).u8(WLOG))
    _write_sizes(w, [int(s) for s in sizes], wide)
    w.raw(payload.tobytes())
    return w.getvalue()


def rcx_case(mesh: Mesh, x: np.ndarray, blocks: int, k: int, inc: int,
             climit_log2: int, cbits: int, wide_check: bool,
             oracles: list | None = None) -> dict:
    """Sharded CT-RCX encode and mesh decode of x, every check of the JAX
    dryrun's CT-RCX part (rank 0 checks the whole blocks, against
    `oracles`, the blocks' oracle containers, where the caller has them).
    -> timings."""
    gathers = mesh.stats.get("lane_gathers", 0)
    shard, (blocks, n_vec, stride_vec, steps) = counted(
        sharded_rcx_encode, x, mesh, blocks=blocks, k_global=k, inc=inc,
        climit_log2=climit_log2, cbits=cbits)
    enc_s = mesh.stats["encode_s"]
    enc_exchanges = mesh.stats.get("lane_gathers", 0) - gathers
    check_offset(shard, mesh)
    parts = sharded.gather_blocks(shard, mesh, k)
    per_block = -(-len(x) // blocks)
    if mesh.rank == 0:
        for b, (sizes, payload) in enumerate(parts):
            xb = x[b * per_block: b * per_block + int(n_vec[b])].tobytes()
            blob = oracles[b] if oracles else rcx_ref.rcx_encode(
                xb, lanes=k, inc=inc, climit_log2=climit_log2, cbits=cbits,
                wlog=WLOG)
            mine = rcx_container(sizes, payload, len(xb), k, inc,
                                 climit_log2, cbits,
                                 bool(sizes.max() >= 1 << 16))
            check(mine == blob,
                  f"distributed RCX container != oracle container (block {b})")
            check(mine == rcx_ops.rcx_encode(
                xb, lanes=k, inc=inc, climit_log2=climit_log2, cbits=cbits,
                wlog=WLOG, device=mesh.device),
                  f"distributed RCX container != single-device (block {b})")
            if b == 0 and wide_check:
                wide = rcx_container(sizes, payload, len(xb), k, inc,
                                     climit_log2, cbits, True)
                check(rcx_ops.rcx_decode(wide, device=mesh.device) == xb,
                      "wide-size-table RCX container decode failed")
    rows3d = sharded.word_rows3d(parts)
    out = counted(sharded_rcx_decode, rows3d, n_vec, stride_vec, mesh, steps,
                  k_global=k, inc=inc, climit_log2=climit_log2, cbits=cbits)
    got = stitch(decoded_parts(out, mesh, blocks, k), blocks, steps, k)
    pieces = [got[b, :int(stride_vec[b])].T.reshape(-1)[:int(n_vec[b])]
              .tobytes() for b in range(blocks)]
    check(b"".join(pieces) == x.tobytes(), "RCX mesh decode != input")
    return {"enc_s": enc_s, "dec_s": mesh.stats["decode_s"],
            "steps": steps, "exchanges": mesh.stats["exchanges"],
            "enc_exchanges": enc_exchanges,
            "bytes": len(x), "blocks": blocks, "lanes": k,
            "compressed": int(shard.totals.sum())}


def rcq_case(mesh: Mesh, x: np.ndarray, k: int, inc: int,
             climit_log2: int, oracles: list | None = None) -> dict:
    """Sharded CT-RCQ encode and mesh decode of x (a block a data shard),
    the JAX dryrun's CT-RCQ checks (oracles as rcx_case's). -> timings."""
    gathers = mesh.stats.get("lane_gathers", 0)
    shard, (blocks, steps, per_block) = counted(
        sharded_rcq_encode, x, mesh, k_global=k, inc=inc,
        climit_log2=climit_log2)
    enc_s = mesh.stats["encode_s"]
    enc_exchanges = mesh.stats.get("lane_gathers", 0) - gathers
    check_offset(shard, mesh)
    parts = sharded.gather_blocks(shard, mesh, k)
    n_vec = np.array([min(per_block, max(len(x) - b * per_block, 0))
                      for b in range(blocks)], np.uint32)
    if mesh.rank == 0:
        for b, (sizes, payload) in enumerate(parts):
            xb = x[b * per_block: b * per_block + int(n_vec[b])].tobytes()
            blob = oracles[b] if oracles else rcq_ref.rcq_encode(
                xb, lanes=k, inc=inc, climit_log2=climit_log2)
            check(blob[len(blob) - len(payload):] == payload.tobytes(),
                  "distributed RCQ payload != oracle container")
            single = rcq_ops.rcq_encode(xb, lanes=k, inc=inc,
                                        climit_log2=climit_log2,
                                        device=mesh.device)
            check(single == blob, "single-device RCQ != oracle container")
    rows3d = sharded.word_rows3d(parts)
    out = counted(sharded_rcq_decode, rows3d, n_vec, mesh, steps,
                  k_global=k, inc=inc, climit_log2=climit_log2)
    got = stitch(decoded_parts(out, mesh, blocks, k), blocks, steps, k)
    decoded = b"".join(got[b].reshape(-1)[:int(n_vec[b])].tobytes()
                       for b in range(blocks))
    check(decoded == x.tobytes(), "RCQ mesh decode != input")
    return {"enc_s": enc_s, "dec_s": mesh.stats["decode_s"],
            "steps": steps, "exchanges": mesh.stats["exchanges"],
            "enc_exchanges": enc_exchanges,
            "bytes": len(x), "blocks": blocks, "lanes": k,
            "compressed": int(shard.totals.sum())}


def rc2_case(mesh: Mesh, x: np.ndarray, blocks: int, k: int, inc: int,
             limit_log2: int, oracles: list | None = None) -> dict:
    """Sharded CT-RC2 encode of x (kernel J), each block's container
    (rank 0) against rc_ref's (or `oracles`) and the single-device one. ->
    timings."""
    gathers = mesh.stats.get("lane_gathers", 0)
    shard, (blocks, steps, per_block) = counted(
        sharded.sharded_adaptive_encode, x, mesh, blocks=blocks, k_global=k,
        inc=inc, limit_log2=limit_log2)
    enc_s = mesh.stats["encode_s"]
    enc_exchanges = mesh.stats.get("lane_gathers", 0) - gathers
    check_offset(shard, mesh)
    parts = sharded.gather_blocks(shard, mesh, k)
    if mesh.rank == 0:
        for b, (sizes, payload) in enumerate(parts):
            xb = x[b * per_block:(b + 1) * per_block].tobytes()
            w = range_ops.adaptive_header(len(xb), k, bool(sizes.max()
                                                           >= 1 << 16),
                                          inc, limit_log2)
            _write_sizes(w, [int(v) for v in sizes], bool(sizes.max()
                                                          >= 1 << 16))
            w.raw(payload.tobytes())
            blob = oracles[b] if oracles else rc_ref.adaptive_encode(
                xb, lanes=k, inc=inc, limit_log2=limit_log2)
            check(w.getvalue() == blob,
                  f"distributed CT-RC2 container != oracle container "
                  f"(block {b})")
            check(blob == range_ops.adaptive_encode(
                xb, lanes=k, inc=inc, limit_log2=limit_log2,
                device=mesh.device),
                  f"single-device CT-RC2 != oracle container (block {b})")
    return {"enc_s": enc_s, "enc_exchanges": enc_exchanges, "steps": steps,
            "bytes": len(x),
            "blocks": blocks, "lanes": k,
            "compressed": int(shard.totals.sum())}


def exchange_us(mesh: Mesh, shape: tuple, reps: int = 50) -> float | None:
    """Microseconds of one decode exchange (a lane group's gather of a
    step's symbols, uint8 `shape`), the mean of `reps` after a warm-up,
    the card synchronized around them; None where the lane group has one
    rank (no exchange)."""
    if mesh.lane == 1:
        return None
    t = torch.zeros(shape, dtype=torch.uint8, device=mesh.device)
    lane_gather(t, mesh)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        lane_gather(t, mesh)
    sync()
    return (time.perf_counter() - t0) / reps * 1e6


def rank_dryrun() -> dict:
    """One rank's part of dryrun_multichip (spawn.run's fn)."""
    import torch.distributed as dist

    n = dist.get_world_size()
    lane = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(data=n // lane, lane=lane)
    rng = np.random.default_rng(0)
    K, INC, CB = 64, 16, 4
    blocks = 2 * mesh.data
    n_bytes = blocks * 3 * K + K // 2 + 3        # partial tail block
    x = np.concatenate([
        rng.integers(97, 105, n_bytes // 2, dtype=np.uint8),
        rng.integers(0, 256, n_bytes - n_bytes // 2, dtype=np.uint8)])
    rcx = rcx_case(mesh, x, blocks, K, INC, 16, CB, wide_check=True)
    hist = sharded.sharded_histogram(x, mesh)
    check((hist == np.bincount(x, minlength=256)).all(),
          "sharded histogram != bincount")
    k = 4 * lane
    x = np.concatenate([
        rng.integers(97, 105, 2 * 96 * mesh.data, dtype=np.uint8),
        rng.integers(0, 256, 2 * 96 * mesh.data, dtype=np.uint8)])
    rcq = rcq_case(mesh, x, k, 24, 16)
    x = rng.integers(0, 200, 2 * mesh.data * 300 - 37, dtype=np.uint8)
    rc2 = rc2_case(mesh, x, 2 * mesh.data, 16, 24, 16)
    return {"world": n, "mesh": mesh.shape, "backend": mesh.backend,
            "device": str(mesh.device), "rcx": rcx, "rcq": rcq, "rc2": rc2,
            "exchange_us": exchange_us(mesh, (blocks // mesh.data, 1, K))}


def rank_main(tasks: list) -> list:
    """Run each (name, kwargs) of `tasks` in turn in this rank: "dryrun"
    (rank_dryrun), or "rcx", "rcq", "rc2" (rcx_case, rcq_case, rc2_case
    over kwargs["data"], bytes, on a mesh of kwargs.get("lane") lane ranks:
    default as make_mesh's). -> each task's dict."""
    cases = {"rcx": rcx_case, "rcq": rcq_case, "rc2": rc2_case}
    out = []
    for name, kw in tasks:
        if name == "dryrun":
            out.append(rank_dryrun())
            continue
        kw = dict(kw)
        mesh = make_mesh(lane=kw.pop("lane", None))
        x = np.frombuffer(kw.pop("data"), np.uint8)
        res = cases[name](mesh, x, **kw)
        if name != "rc2":
            # the exchange of a decode step: a step of the shard's blocks
            res["exchange_us"] = exchange_us(
                mesh, (res["blocks"] // mesh.data, 1, kw["k"]))
        res.update(mesh=mesh.shape, backend=mesh.backend)
        out.append(res)
    return out


def shard_arrays(shard: sharded.Shard) -> dict:
    """A Shard as numpy: events int32 [blocks/data, E, ko] (time-major),
    lane_sizes, total, totals, offset, its blocks and its lanes' l0."""
    return {"events": np.stack([e.cpu().numpy() for e in shard.events]),
            "lane_sizes": shard.lane_sizes, "total": shard.total,
            "totals": shard.totals, "offset": shard.offset,
            "blocks": (shard.blocks.start, shard.blocks.stop),
            "l0": shard.l0}


def rank_shards(tasks: list, data: int | None = None,
                lane: int | None = None) -> list:
    """Each (name, kwargs) of `tasks` on a data x lane mesh, this rank's
    raw results as numpy (what a test stitches and holds to the JAX
    package's functions): "histogram" (kwargs x) -> the histogram; "rc2"
    (sharded_adaptive_encode's kwargs) -> shard_arrays; "rcx" and "rcq"
    (the encode's kwargs, and rows3d: the decode's input) -> shard_arrays
    with "decoded", the rank's part of the decode of rows3d, and
    "containers": every block's payload bytes and lane sizes
    (gather_blocks)."""
    mesh = make_mesh(data, lane)
    out = []
    for name, kw in tasks:
        kw = dict(kw)
        x = kw.pop("x")
        if name == "histogram":
            out.append(sharded.sharded_histogram(x, mesh))
            continue
        rows3d = kw.pop("rows3d", None)
        k = kw["k_global"]
        if name == "rc2":
            shard, _ = counted(sharded.sharded_adaptive_encode, x, mesh,
                               **kw)
            res = shard_arrays(shard)
        elif name == "rcx":
            shard, (_, n_vec, stride_vec, steps) = counted(
                sharded_rcx_encode, x, mesh, **kw)
            res = shard_arrays(shard)
            kw.pop("blocks", None)
            res["decoded"] = counted(sharded_rcx_decode, rows3d, n_vec,
                                     stride_vec, mesh, steps, **kw)
        else:
            shard, (blocks, steps, per_block) = counted(
                sharded_rcq_encode, x, mesh, **kw)
            res = shard_arrays(shard)
            n_vec = np.minimum(per_block, np.maximum(
                len(x) - np.arange(blocks) * per_block, 0)).astype(np.uint32)
            res["decoded"] = counted(sharded_rcq_decode, rows3d, n_vec,
                                     mesh, steps, **kw)
        res["containers"] = sharded.gather_blocks(shard, mesh, k)
        out.append(res)
    return out


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device: str | None = None) -> list:
    """The distributed path end to end over a new world of n_devices ranks
    (spawn.run): raises if any check fails. -> each rank's
    spawn.RankResult (rank 0's value has the runs' timings)."""
    return spawn.run(n_devices, rank_main, [("dryrun", {})],
                     backend=backend, device=device)
