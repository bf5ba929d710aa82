"""The port's multi-GPU layer (cpprcoder_tpu_torch/parallel/) on the CPU:
gloo worlds of 2 and 4 ranks started by the port's spawn helper, each rank
running the plain versions, held bit for bit to the JAX package's sharded
functions on jax.devices()[:4] (in this process) at the inputs and meshes
of tests/test_sharded*.py, cut to 4 ranks: meshes (2, 2), (1, 4), (4, 1).

Every shard is stitched into the JAX functions' layout: events [blocks, K,
E] from the port's time-major [E, ko] a rank and block, lane sizes [blocks,
K], one total and one offset a rank in rank order (P(('data', 'lane'))),
and the decoders' symbols [blocks, steps, K]; the decoders are compared
where a lane is active (the JAX scan decodes on past a lane's end, where
the port writes 0). Each block's container is also held to the oracle's
and to the port's single-device container, and the mesh decode to the
input. A world costs a few seconds (4 processes importing torch) and a
gloo exchange a few milliseconds, so each test starts one world and
decodes a few hundred steps at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.ops import compaction
from cpprcoder_tpu.ops.rcq_ops import _rows_fn
from cpprcoder_tpu.parallel.mesh import make_mesh as jax_mesh
from cpprcoder_tpu.parallel.sharded import (
    sharded_adaptive_encode as jax_adaptive,
    sharded_histogram as jax_histogram,
)
from cpprcoder_tpu.parallel.sharded_rcq import (
    sharded_rcq_decode as jax_rcq_decode,
    sharded_rcq_encode as jax_rcq_encode,
)
from cpprcoder_tpu.parallel.sharded_rcx import (
    sharded_rcx_decode as jax_rcx_decode,
    sharded_rcx_encode as jax_rcx_encode,
)
from cpprcoder_tpu.utils.shapes import bucket
from cpprcoder_tpu_torch.ops import (
    expand,
    layout,
    range_kernels,
    rcq_kernels,
    rcq_ops,
    rcx_kernels,
    rcx_ops,
)
from cpprcoder_tpu_torch.ops import range_ops as trange
from cpprcoder_tpu_torch.parallel import dryrun, mesh as tmesh, spawn
from cpprcoder_tpu_torch.parallel.sharded_rcx import block_layout
from cpprcoder_tpu_torch.reference import rc_ref, rcq_ref, rcx_ref
from cpprcoder_tpu_torch.reference.rc_ref import _write_sizes


def world(shape, tasks):
    """tasks in a gloo world of data x lane ranks on the CPU; -> each
    rank's list of results, after checking that no rank loaded JAX or the
    JAX package."""
    res = spawn.run(shape[0] * shape[1], dryrun.rank_shards, tasks,
                    data=shape[0], lane=shape[1], backend="gloo",
                    device="cpu", timeout=300)
    for r in res:
        assert r.foreign == []
    return [r.value for r in res]


def stitch_events(ranks, i, blocks, k):
    """Task i's events of every rank -> [blocks, K, E] (the JAX layout)."""
    ev = None
    for r in ranks:
        s = r[i]
        e = s["events"]
        if ev is None:
            ev = np.zeros((blocks, k, e.shape[1]), np.int32)
        b0, b1 = s["blocks"]
        ev[b0:b1, s["l0"]:s["l0"] + e.shape[2]] = e.transpose(0, 2, 1)
    return ev


def stitch_lanes(ranks, i, key, blocks, k):
    """A [blocks/data, (steps,) ko] result of every rank -> [blocks, (steps,)
    K]."""
    first = ranks[0][i][key]
    out = np.zeros((blocks, *first.shape[1:-1], k), first.dtype)
    for r in ranks:
        s = r[i]
        b0, b1 = s["blocks"]
        part = s[key]
        out[b0:b1, ..., s["l0"]:s["l0"] + part.shape[-1]] = part
    return out


def check_totals(ranks, i, jax_totals, jax_offsets):
    totals = ranks[0][i]["totals"]
    assert all((r[i]["totals"] == totals).all() for r in ranks)
    assert [r[i]["total"] for r in ranks] == totals.tolist()
    assert [r[i]["offset"] for r in ranks] == \
        (np.cumsum(totals) - totals).tolist()
    assert totals.tolist() == np.asarray(jax_totals).tolist()
    assert np.asarray(jax_offsets).tolist() == \
        (np.cumsum(totals) - totals).tolist()


def jax_rows3d(events, k, steps):
    """The JAX tests' decode input: each block's payload rows from its
    events (compaction + _rows_fn)."""
    l4 = bucket((2 * steps + 8) // 4 + 2)
    rows = []
    for ev in events:
        ev = jnp.asarray(ev)
        total = int(compaction.payload_layout(ev)[4])
        payload, sizes = compaction.materialize(ev, bucket(total + 8))
        p_cap = bucket(max(total, 1))
        padded = np.zeros(p_cap, np.uint8)
        padded[:total] = np.asarray(payload)[:total]
        rows.append(np.asarray(_rows_fn(k, l4, p_cap)(
            jnp.asarray(padded), jnp.asarray(np.asarray(sizes), jnp.int32))))
    return np.stack(rows)


def container(head, sizes, payload) -> bytes:
    wide = bool(sizes.max() >= 1 << 16)
    w = head(wide)
    _write_sizes(w, [int(s) for s in sizes], wide)
    w.raw(payload.tobytes())
    return w.getvalue()


# ------------------------------------------------ CT-RC2 and the histogram

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_sharded_adaptive_and_histogram_match_jax(shape):
    """tests/test_sharded.py's inputs: events, lane sizes and totals of
    sharded_adaptive_encode, and sharded_histogram, against the JAX
    package's on the same mesh; each block's container against the oracle
    and the port's single-device container."""
    k, inc, limit = 16, 24, 16
    data_n = shape[0]
    rng = np.random.default_rng(1)
    x = rng.integers(0, 200, data_n * 1000 - 37, dtype=np.uint8)
    h_x = np.random.default_rng(0).integers(0, 256, 10007, dtype=np.uint8)
    jmesh = jax_mesh(*shape, devices=jax.devices()[:4])
    (jev, jls, jtot, joff), (blocks, steps, per_block) = jax_adaptive(
        x, jmesh, k_global=k, inc=inc, limit_log2=limit)
    ranks = world(shape, [("rc2", dict(x=x, k_global=k, inc=inc,
                                       limit_log2=limit)),
                          ("histogram", dict(x=h_x))])
    assert np.array_equal(stitch_events(ranks, 0, blocks, k),
                          np.asarray(jev).view(np.int32))
    assert np.array_equal(stitch_lanes(ranks, 0, "lane_sizes", blocks, k),
                          np.asarray(jls))
    check_totals(ranks, 0, jtot, joff)
    jh = jax_histogram(h_x, jmesh)
    for r in ranks:
        assert np.array_equal(r[1], jh)
        assert np.array_equal(r[1], np.bincount(h_x, minlength=256))
    for b, (sizes, payload) in enumerate(ranks[0][0]["containers"]):
        xb = x[b * per_block:(b + 1) * per_block].tobytes()
        blob = container(lambda wide: trange.adaptive_header(
            len(xb), k, wide, inc, limit), sizes, payload)
        assert blob == rc_ref.adaptive_encode(xb, lanes=k, inc=inc,
                                              limit_log2=limit)
        assert blob == trange.adaptive_encode(xb, lanes=k, inc=inc,
                                              limit_log2=limit, device="cpu")


# ------------------------------------------------------------- CT-RCQ

def test_sharded_rcq_matches_jax():
    """tests/test_sharded_rcq.py's input on a 2 x 2 mesh: the encode's
    events, sizes and totals, the containers, and the mesh decode of the
    JAX package's rows3d, against the JAX functions."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.integers(97, 105, 1500, dtype=np.uint8),
                        rng.integers(0, 256, 1100, dtype=np.uint8)])
    k = 8
    jmesh = jax_mesh(data=2, lane=2, devices=jax.devices()[:4])
    (jev, jls, jtot, joff), (blocks, steps, per_block) = jax_rcq_encode(
        x, jmesh, k_global=k)
    jev = np.asarray(jev)
    rows3d = jax_rows3d(jev, k, steps)
    n_vec = np.array([len(x[b * per_block:(b + 1) * per_block])
                      for b in range(blocks)], np.uint32)
    jout = jax_rcq_decode(rows3d, n_vec, jmesh, steps=steps, k_global=k)
    ranks = world((2, 2), [("rcq", dict(x=x, k_global=k, rows3d=rows3d))])
    assert np.array_equal(stitch_events(ranks, 0, blocks, k),
                          jev.view(np.int32))
    assert np.array_equal(stitch_lanes(ranks, 0, "lane_sizes", blocks, k),
                          np.asarray(jls))
    check_totals(ranks, 0, jtot, joff)
    out = stitch_lanes(ranks, 0, "decoded", blocks, k)
    for b in range(blocks):
        active = np.arange(steps * k).reshape(steps, k) < n_vec[b]
        assert np.array_equal(out[b][active], jout[b][active])
        assert not out[b][~active].any()
        xb = x[b * per_block:(b + 1) * per_block].tobytes()
        assert out[b].reshape(-1)[:n_vec[b]].tobytes() == xb
        sizes, payload = ranks[0][0]["containers"][b]
        blob = container(lambda wide: rcq_ops.header(len(xb), k, wide, 24,
                                                     16), sizes, payload)
        assert blob == rcq_ref.rcq_encode(xb, lanes=k)
        assert blob == rcq_ops.rcq_encode(xb, lanes=k, device="cpu")


# ------------------------------------------------------------- CT-RCX

K, INC, CB = 64, 16, 4


@pytest.mark.parametrize("n,blocks,seed", [(2600, 2, 5), (3001, 4, 6)])
def test_sharded_rcx_matches_jax(n, blocks, seed):
    """tests/test_sharded_rcx.py's inputs on a 2 x 2 mesh: two blocks, and
    four (two a data shard) with a partial tail block of a smaller stride;
    the encode, the containers and the mesh decode against the JAX
    functions, the oracle at wlog = 0 and the single-device port."""
    rng = np.random.default_rng(seed)
    if seed == 5:
        x = np.concatenate([rng.integers(97, 105, 1500, dtype=np.uint8),
                            rng.integers(0, 256, 1100, dtype=np.uint8)])
    else:
        x = rng.integers(32, 127, n, dtype=np.uint8)
    jmesh = jax_mesh(data=2, lane=2, devices=jax.devices()[:4])
    ((jev, jls, jtot, joff), (blocks, n_vec, stride_vec, steps)) = \
        jax_rcx_encode(x, jmesh, blocks=blocks, k_global=K, inc=INC,
                       cbits=CB)
    t_n, t_stride, t_steps, _ = block_layout(len(x), blocks, K)
    assert np.array_equal(t_n, n_vec) and np.array_equal(t_stride, stride_vec)
    assert t_steps == steps
    jev = np.asarray(jev)
    rows3d = jax_rows3d(jev, K, steps)
    jout = jax_rcx_decode(rows3d, n_vec, stride_vec, jmesh, steps=steps,
                          k_global=K, inc=INC, cbits=CB)
    ranks = world((2, 2), [("rcx", dict(x=x, blocks=blocks, k_global=K,
                                        inc=INC, cbits=CB, rows3d=rows3d))])
    assert np.array_equal(stitch_events(ranks, 0, blocks, K),
                          jev.view(np.int32))
    assert np.array_equal(stitch_lanes(ranks, 0, "lane_sizes", blocks, K),
                          np.asarray(jls))
    check_totals(ranks, 0, jtot, joff)
    out = stitch_lanes(ranks, 0, "decoded", blocks, K)
    per_block = -(-len(x) // blocks)
    for b in range(blocks):
        st, nb = int(stride_vec[b]), int(n_vec[b])
        lens = np.clip(nb - np.arange(K) * st, 0, st)
        active = np.arange(steps)[:, None] < lens[None, :]
        assert np.array_equal(out[b][active], jout[b][active])
        assert not out[b][~active].any()
        xb = x[b * per_block:b * per_block + nb].tobytes()
        assert out[b][:st].T.reshape(-1)[:nb].tobytes() == xb
        sizes, payload = ranks[0][0]["containers"][b]
        blob = dryrun.rcx_container(sizes, payload, nb, K, INC, 16, CB,
                                    bool(sizes.max() >= 1 << 16))
        assert blob == rcx_ref.rcx_encode(xb, lanes=K, inc=INC, cbits=CB,
                                          wlog=0)
        assert blob == rcx_ops.rcx_encode(xb, lanes=K, inc=INC, cbits=CB,
                                          wlog=0, device="cpu")


def test_dryrun_multichip_world_of_two():
    """dryrun_multichip(2)'s world on gloo and the CPU: every check of the
    JAX dryrun and CT-RC2's encode pass in the ranks."""
    res = spawn.run(2, dryrun.rank_main, [("dryrun", {})], backend="gloo",
                    device="cpu", timeout=300)
    assert [r.foreign for r in res] == [[], []]
    v = res[0].value[0]
    assert v["mesh"] == {"data": 1, "lane": 2} and v["backend"] == "gloo"
    assert v["rcx"]["exchanges"] == v["rcx"]["steps"] - 1
    assert v["rcq"]["exchanges"] == v["rcq"]["steps"] - 1
    # the encodes exchange nothing on 'lane': every rank holds the input
    assert [v[c]["enc_exchanges"] for c in ("rcx", "rcq", "rc2")] == [0] * 3


# ----------------------------------------------- no NCCL world it refuses

@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_nccl_with_more_ranks_than_cards_raises(device):
    """NCCL takes one card a rank: with no card here, a world of 2 on
    backend 'nccl' raises before any process starts, naming the cause."""
    with pytest.raises(ValueError, match="nccl"):
        spawn.run(2, dryrun.rank_main, [], backend="nccl", device=device)
    with pytest.raises(ValueError, match="one card a rank|runs on the card"):
        tmesh.resolve("nccl", device, 2)


def test_resolve_defaults_without_a_card():
    """The card is the default device: without one it raises (no fall
    back to the CPU); the CPU takes gloo."""
    with pytest.raises((RuntimeError, ValueError)):
        tmesh.resolve(None, None, 1)
    assert tmesh.resolve(None, "cpu", 4) == ("gloo", torch.device("cpu"))


def test_make_mesh_single_process():
    """A process that joined no world is a 1 x 1 mesh, whose collectives
    are none."""
    m = tmesh.make_mesh(device="cpu")
    assert m.shape == {"data": 1, "lane": 1} and m.lanes(64) == (0, 64)
    t = torch.arange(6, dtype=torch.uint8).reshape(1, 6)
    assert tmesh.lane_gather(t, m) is t
    assert tmesh.world_gather(7, m).tolist() == [7]


# ------------------------------------------ the new forms' plain versions

def _rcx_case(n, k, wlog, seed):
    x = np.random.default_rng(seed).integers(0, 40, n, dtype=np.uint8)
    xt = torch.from_numpy(x)
    stride = -(-n // k)
    return (x, layout.pad2d_chunked(xt, k, stride),
            layout.lane_lengths(n, k, stride, "cpu"), stride)


@pytest.mark.parametrize("l0,ko", [(0, 8), (8, 8), (4, 12), (0, 16)])
def test_range_forms_are_the_one_shot_columns(l0, ko):
    """The lane-range forms of A, D and J on CPU tensors: the one-shot
    events' columns l0 .. l0 + ko - 1 (the lanes' model is every lane's)."""
    _, x2d, ll, _ = _rcx_case(700, 16, 0, 3)
    full = rcx_kernels.encode_events(x2d, ll, 16, 1 << 16, 4, 0)
    assert torch.equal(rcx_kernels.encode_events_range(
        x2d, ll, l0, ko, 16, 1 << 16, 4, 0), full[:, l0:l0 + ko])
    full = rcq_kernels.encode_events(x2d, ll, 24, 1 << 16)
    assert torch.equal(rcq_kernels.encode_events_range(
        x2d, ll, l0, ko, 24, 1 << 16), full[:, l0:l0 + ko])
    full = range_kernels.encode_events(x2d, ll, None, 24, 16)
    assert torch.equal(range_kernels.encode_events_range(
        x2d, ll, l0, ko, None, 24, 16), full[:, l0:l0 + ko])


@pytest.mark.parametrize("k,cbits,wlog,lane_n",
                         [(16, 4, 0, 2), (16, 4, 2, 4), (8, 8, 1, 2),
                          (12, 2, 3, 3)])
def test_stepped_decode_windows_round_trip(k, cbits, wlog, lane_n):
    """kernel C's stepped lane-range form on CPU tensors (its plain
    version), lane_n ranks simulated, a window a launch: the ranks' joined
    symbols are the input, and each launch's state is the one-shot plain
    decode's lane state for the active lanes."""
    x, x2d, ll, stride = _rcx_case(1100, k, wlog, 7)
    ev = rcx_kernels.encode_events(x2d, ll, 16, 1 << 16, cbits, wlog)
    words = layout.decode_words(*expand.materialize_rows(ev))
    ko = k // lane_n
    ws = [words[:, r * ko:(r + 1) * ko].contiguous()[None]
          for r in range(lane_n)]
    states = [rcx_ops.decode_state(w, k, cbits) for w in ws]
    xs = torch.zeros((1, 0, k), dtype=torch.uint8)
    got = []
    for t0 in range(0, stride, 1 << wlog):
        n = min(1 << wlog, stride - t0)
        outs = [rcx_kernels.decode_steps(ws[r], ll[None].contiguous(),
                                         states[r], xs, r * ko, t0, n, 16,
                                         1 << 16, cbits, wlog)
                for r in range(lane_n)]
        xs = torch.cat(outs, dim=2).contiguous()
        got.append(xs[0])
    sym = torch.cat(got)
    assert sym.T.reshape(-1)[:len(x)].numpy().tobytes() == x.tobytes()
    assert not sym[torch.arange(stride)[:, None] >= ll[None, :]].any()


def test_decode_steps_rejects_a_window_across_a_requant():
    """A stepped launch starts at a window and ends in it."""
    _, x2d, ll, stride = _rcx_case(300, 16, 2, 1)
    words = torch.zeros((1, 4, 8), dtype=torch.int32)
    state = rcx_ops.decode_state(words, 16, 4)
    xs = torch.zeros((1, 0, 16), dtype=torch.uint8)
    for t0, n in ((1, 1), (0, 5)):
        with pytest.raises(ValueError, match="window"):
            rcx_kernels.decode_steps(words, ll[None].contiguous(), state, xs,
                                     0, t0, n, 16, 1 << 16, 4, 2)
    with pytest.raises(ValueError, match="lanes"):
        rcx_kernels.encode_events_range(x2d, ll, 12, 8, 16, 1 << 16, 4, 2)
