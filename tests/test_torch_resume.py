"""The port's resumable CT-RCQ encoder (codecs/resume.py) and kernel O's
plain version, on the CPU, against the JAX package's
cpprcoder_tpu/codecs/resume.py: the three cases of
tests/test_rcq_resume.py, `encode_chunk_plain` against `_chunk_fn` and
`_flush_fn` (events, the five state vectors and C), checkpoints key for
key and across the packages both ways, and the run-length guard. Integer
codec: exact equality throughout."""

import pickle

import numpy as np
import pytest
import torch

from cpprcoder_tpu.codecs import resume as jresume
from cpprcoder_tpu.models.qmodel import rcq_params
from cpprcoder_tpu.ops import rcq_ops as jrcq_ops
from cpprcoder_tpu_torch.codecs.resume import RCQResumableEncoder, stitch
from cpprcoder_tpu_torch.ops import layout, rcq_kernels, rcq_ops
from cpprcoder_tpu_torch.reference import rcq_ref

CPU = {"device": "cpu"}


def _roundtrip_resumable(data: bytes, lanes: int, chunk_steps: int,
                         split_at: int) -> bytes:
    enc = RCQResumableEncoder(len(data), lanes=lanes,
                              chunk_steps=chunk_steps, **CPU)
    enc.feed(data[:split_at])
    ckpt = pickle.loads(pickle.dumps(enc.checkpoint()))   # kill + restore
    enc2 = RCQResumableEncoder.resume(ckpt, **CPU)
    enc2.feed(data[split_at:])
    return enc2.finish()


def _mixed():
    rng = np.random.default_rng(3)
    return (rng.integers(97, 123, 3000, dtype=np.uint8).tobytes()
            + rng.integers(0, 256, 2000, dtype=np.uint8).tobytes())


def test_resume_byte_identical_mixed():
    data = _mixed()
    one_shot = jrcq_ops.rcq_encode_jax(data, lanes=8)
    for split in (1, 700, 2048, 4999):
        blob = _roundtrip_resumable(data, lanes=8, chunk_steps=16,
                                    split_at=split)
        assert blob == one_shot, split
    assert jrcq_ops.rcq_decode_jax(one_shot) == data


def test_resume_low_entropy_lanes_emit_late():
    # all zeros: lanes emit nothing for many chunks, which exercises the
    # per-lane dummy-drop tracking across chunk boundaries
    data = b"\x00" * 4096
    one_shot = jrcq_ops.rcq_encode_jax(data, lanes=8)
    blob = _roundtrip_resumable(data, lanes=8, chunk_steps=8, split_at=1000)
    assert blob == one_shot
    assert jrcq_ops.rcq_decode_jax(blob) == data


def test_resume_multiple_checkpoints():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 200, 2500, dtype=np.uint8).tobytes()
    one_shot = jrcq_ops.rcq_encode_jax(data, lanes=8)
    enc = RCQResumableEncoder(len(data), lanes=8, chunk_steps=16, **CPU)
    pos = 0
    for piece in (100, 900, 1300, 200):
        enc.feed(data[pos: pos + piece])
        pos += piece
        enc = RCQResumableEncoder.resume(
            pickle.loads(pickle.dumps(enc.checkpoint())), **CPU)
    assert enc.finish() == one_shot


def _chunks(n, k, steps, seed):
    """Seeded bytes with runs of 0xFF (pending carries across chunk
    edges) and of 0x00, n of them, cut into [steps, K] interleaved chunks
    (the last one zero-padded)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, n, dtype=np.uint8)
    x[n // 5: n // 5 + 3 * k] = 0xFF
    x[n // 2: n // 2 + 5 * k] = 0
    pad = np.zeros(-(-n // (steps * k)) * steps * k, np.uint8)
    pad[:n] = x
    return pad.reshape(-1, steps, k)


def _start(k, pending, seed):
    """(state [5] of u32 [K], C [256] u32): the fresh encoder's, or a saved
    one whose lanes hold pending runs (cache_size up to 4,000, low at
    0xFF......, so that further 0xFF bytes join the run; carry set on some
    lanes) and a model with a history."""
    if not pending:
        return ([np.zeros(k, np.uint32), np.zeros(k, np.uint32),
                 np.full(k, 0xFFFFFFFF, np.uint32), np.zeros(k, np.uint32),
                 np.ones(k, np.uint32)], np.ones(256, np.uint32))
    rng = np.random.default_rng(seed)
    u32 = lambda lo, hi: rng.integers(lo, hi, k, dtype=np.uint64).astype(  # noqa: E731
        np.uint32)
    return ([u32(0xFF000000, 1 << 32), u32(0, 2), u32(1 << 24, 1 << 32),
             u32(0, 256), u32(1, 4000)],
            rng.integers(1, 60, 256, dtype=np.uint32))


@pytest.mark.parametrize("pending", [False, True])
@pytest.mark.parametrize("n", [8 * 16 * 4, 8 * 16 * 3 + 21])
def test_encode_chunk_plain_matches_chunk_fn(n, pending):
    """Chunk after chunk (the last partly active where n is not a multiple
    of a chunk), from the fresh state or from one with pending runs, the
    port's kernel-O wrapper on CPU tensors gives the JAX _chunk_fn's
    events, state and C from the same state, and the flush rows of
    _flush_fn after the last chunk (a flush-only launch)."""
    k, steps = 8, 16
    _, inc, cl = rcq_params(n, lanes=k)
    fn = jresume._chunk_fn(steps, k, inc, cl)
    jst, jC = _start(k, pending, seed=n)
    state = torch.from_numpy(np.stack(jst).view(np.int32))
    C = torch.from_numpy(jC.view(np.int32))
    lens = layout.lane_lengths_interleaved(n, k, -(-n // k), "cpu")
    runs = 0
    chunks = _chunks(n, k, steps, seed=n)
    for i, x2d in enumerate(chunks):
        st, t1, jC, jev = fn(x2d, np.uint32(n), np.uint32(i * steps), *jst,
                             jC)
        jst = [np.asarray(a) for a in st]
        jC = np.asarray(jC)
        ev, state, C = rcq_kernels.encode_chunk(
            torch.from_numpy(x2d), lens, i * steps, state, C, inc, 1 << cl)
        assert int(t1) == (i + 1) * steps
        assert np.array_equal(ev.numpy().view(np.uint32), np.asarray(jev))
        assert np.array_equal(state.numpy().view(np.uint32), np.stack(jst))
        assert np.array_equal(C.numpy().view(np.uint32), jC)
        runs = max(runs, int((np.asarray(jev) & 0x3FFFFF).max()))
    assert runs >= (1000 if pending else 0)
    jfl = np.asarray(jresume._flush_fn(k)(*jst))
    empty = torch.zeros((0, k), dtype=torch.uint8)
    fl, st2, C2 = rcq_kernels.encode_chunk(empty, lens, len(chunks) * steps,
                                           state, C, inc, 1 << cl, flush=True)
    assert np.array_equal(fl.numpy().view(np.uint32), jfl)
    assert torch.equal(st2, state) and torch.equal(C2, C)


def _feed_both(data, splits, **kw):
    """The JAX class and the port's, fed alike."""
    encs = [jresume.RCQResumableEncoder(len(data), **kw),
            RCQResumableEncoder(len(data), **kw, **CPU)]
    for enc in encs:
        pos = 0
        for cut in splits:
            enc.feed(data[pos:cut])
            pos = cut
    return encs


def test_checkpoint_matches_the_jax_class_key_by_key():
    data = _mixed()
    jenc, tenc = _feed_both(data, (100, 1500, 2600), lanes=8, chunk_steps=16)
    jck, tck = jenc.checkpoint(), tenc.checkpoint()
    assert sorted(jck) == sorted(tck)
    for key, want in jck.items():
        got = tck[key]
        if isinstance(want, list):
            assert len(got) == len(want), key
            for a, b in zip(got, want):
                if isinstance(b, np.ndarray):
                    assert a.dtype == b.dtype and np.array_equal(a, b), key
                else:
                    assert a == b, key
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), key
        else:
            assert type(got) is type(want) and got == want, key
    assert len(tck["frag_payload"]) == 2600 // (16 * 8)


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_checkpoints_cross_between_the_packages(direction):
    """A checkpoint of either class, pickled, finishes in the other to the
    one-shot rcq_encode_jax bytes (and the oracle's)."""
    data = _mixed()
    want = jrcq_ops.rcq_encode_jax(data, lanes=8)
    assert want == rcq_ref.rcq_encode(data, lanes=8)
    jenc, tenc = _feed_both(data, (1700,), lanes=8, chunk_steps=16)
    if direction == "jax to port":
        enc = RCQResumableEncoder.resume(
            pickle.loads(pickle.dumps(jenc.checkpoint())), **CPU)
    else:
        enc = jresume.RCQResumableEncoder.resume(
            pickle.loads(pickle.dumps(tenc.checkpoint())))
    enc.feed(data[1700:])
    assert enc.finish() == want


def test_run_length_guard_and_arguments():
    """A lane's pending run lives in the event's 22-bit field over the
    whole stream: 3 * stride + 2 < 2^22, as for one-shot rcq."""
    limit = ((1 << 22) - 2) // 3 + 1      # the first stride refused
    RCQResumableEncoder(limit - 1, lanes=1, **CPU)
    for lanes in (1, 8):
        with pytest.raises(ValueError, match="exceed one container"):
            RCQResumableEncoder(limit * lanes, lanes=lanes, **CPU)
        with pytest.raises(ValueError, match="exceed one container"):
            rcq_ops.rcq_encode(bytes(limit * lanes), lanes=lanes, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        RCQResumableEncoder(100, lanes=3, **CPU)
    with pytest.raises(ValueError, match="backend"):
        RCQResumableEncoder(100, backend="ref")
    enc = RCQResumableEncoder(10, lanes=8, **CPU)
    with pytest.raises(ValueError, match="more than"):
        enc.feed(b"x" * 11)
    enc = RCQResumableEncoder(10, lanes=8, **CPU)
    enc.feed(b"x" * 9)
    with pytest.raises(ValueError, match="fed 9 of 10"):
        enc.finish()


def test_empty_input_and_stitch():
    """n = 0 writes the one-shot header alone; stitch joins each lane's
    fragments in chunk order, as the JAX class's per-lane loop does."""
    want = jrcq_ops.rcq_encode_jax(b"", lanes=8)
    assert RCQResumableEncoder(0, lanes=8, **CPU).finish() == want
    rng = np.random.default_rng(5)
    sizes = rng.integers(0, 4, (3, 5)).astype(np.int64)
    frags = [rng.integers(0, 256, int(s.sum()), dtype=np.uint8).tobytes()
             for s in sizes]
    lanes = [bytearray() for _ in range(5)]
    for frag, s in zip(frags, sizes):
        offs = np.concatenate(([0], np.cumsum(s)))
        for i in range(5):
            lanes[i] += frag[offs[i]:offs[i + 1]]
    payload, lane_sizes = stitch(frags, sizes)
    assert payload.tobytes() == b"".join(lanes)
    assert lane_sizes.tolist() == [len(b) for b in lanes]
