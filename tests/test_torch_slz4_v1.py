"""CT-LZ4's v1 parse in the port, on the CPU: the v1 match table
(lz_ops.match_table_v1, the plain version of kernel Z) against a numpy
statement of the oracle's exact table and against the JAX package's
`_candidates` and `_lcp_estimate`, and the v1 containers
(lz_ops.slz4_encode(parse="v1")) against the oracle's
(slz4_ref.slz4_encode(parse="v1")), the host library's and, where its C1
and C2 bounds allow, `slz4_encode_jax(parse="v1")`'s. Integer tables and
containers: exact equality throughout."""

import shutil

import numpy as np
import pytest
import torch

from conftest import corpus_file
from cpprcoder_tpu.ops import lz_ops as jlz
from cpprcoder_tpu_torch.ops import lz_kernels, lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref
from cpprcoder_tpu_torch.reference.slz4_ref import LCP_CAP, MAX_DISTANCE
from test_slz4 import _cases
from test_torch_slz4 import _jax_ok

CPU = {"device": "cpu"}


def v1(data, seg_log2=17, lazy=True) -> bytes:
    return slz4_ref.slz4_encode(data, seg_log2=seg_log2, lazy=lazy,
                                parse="v1")


def port(data, seg_log2=17, lazy=True) -> bytes:
    """The port's v1 container, checked to decode through the port."""
    blob = lz_ops.slz4_encode(data, seg_log2, lazy, parse="v1", **CPU)
    assert lz_ops.slz4_decode(blob, **CPU) == bytes(data)
    return blob


def table_np(seg: np.ndarray):
    """The oracle's v1 table of one segment (slz4_ref.parse_segment's
    candidate map and lcp at every position): cand the nearest earlier
    indexable position with the same 4 bytes within MAX_DISTANCE, lcp the
    exact common prefix capped at LCP_CAP and the segment's end."""
    n = len(seg)
    bs = seg.tobytes()
    last = {}
    cand = np.full(n, -1, np.int64)
    lcp = np.zeros(n, np.int64)
    for p in range(n - 3):
        k = bs[p:p + 4]
        j = last.get(k)
        if j is not None and p - j <= MAX_DISTANCE:
            cap = min(LCP_CAP, n - p)
            diff = np.flatnonzero(seg[j:j + cap] != seg[p:p + cap])
            cand[p] = j
            lcp[p] = diff[0] if diff.size else cap
        last[k] = p
    return lcp, cand


def _rows(data, seg_log2):
    x = torch.from_numpy(np.frombuffer(bytes(data), np.uint8).copy())
    return lz_ops.segment_rows(x, seg_log2)


def _edges():
    """Name -> bytes: distances at the limit with a farther equal key, a
    long zero run, and runs ending 1 to 12 bytes before the end."""
    rng = np.random.default_rng(71)
    head = bytes(rng.integers(0, 256, 64, dtype=np.uint8))

    def noise(k):
        return bytes(rng.integers(0, 256, k, dtype=np.uint8))

    out = {}
    for dist in (65535, 65536):
        # head at 0 and at 5,000, then again `dist` after the second: the
        # nearest is `dist` back, the farther one 5,000 more
        out[f"nearest_{dist}"] = (head + noise(5000 - 64) + head
                                  + noise(dist - 64) + head + b"end of it")
    out["zeros_20000"] = noise(300) + bytes(20_000) + noise(300)
    text = corpus_file("fields.c")[:2000]
    for k in (1, 5, 11, 12):
        out[f"run_end_{k}"] = text + b"\x05" * 700 + noise(k)
    return out


def _data(name):
    if name in ("grammar.lsp", "fields.c"):
        return corpus_file(name)
    if name == "kennedy_100k":
        return corpus_file("kennedy.xls")[:100_000]
    if name.startswith("jax_case"):
        return _cases()[int(name[8:])]
    return _edges()[name]


NAMES = ([f"jax_case{i}" for i in range(5)]
         + ["grammar.lsp", "fields.c", "kennedy_100k"] + list(_edges()))


def _params(seg_logs=(0, 3, 7, 12, 17)):
    """(name, seg_log2) pairs; the largest inputs skip seg_log2 0 and 3
    (the oracle walks a segment at a time in Python)."""
    return [(nm, sl) for nm in NAMES for sl in seg_logs
            if sl >= 7 or len(_data(nm)) <= 10_000]


@pytest.mark.parametrize("name,seg_log2", _params())
def test_match_table_v1_is_the_oracles(name, seg_log2):
    data = _data(name)
    rows, lens = _rows(data, seg_log2)
    lcp, cand = lz_ops.match_table_v1(rows, lens)
    assert lcp.dtype == cand.dtype == torch.int64
    x = np.frombuffer(data, np.uint8)
    s = 1 << seg_log2
    for i in range(rows.shape[0]):
        seg = x[i * s:(i + 1) * s]
        lw, cw = table_np(seg)
        assert np.array_equal(lcp[i, :len(seg)].numpy(), lw)
        assert np.array_equal(cand[i, :len(seg)].numpy(), cw)
        assert not lcp[i, len(seg):].any() and (cand[i, len(seg):] == -1).all()


@pytest.mark.parametrize("name,seg_log2", [
    ("jax_case4", 17), ("fields.c", 7), ("kennedy_100k", 17),
    ("nearest_65536", 17)])
def test_match_table_v1_against_the_jax_package(name, seg_log2):
    """cand equals `_candidates` wherever that is at most MAX_DISTANCE
    back (-1 elsewhere), and lcp equals `_lcp_estimate` there (the JAX
    estimate is exact unless its two u32 hash chains collide)."""
    rows, lens = _rows(_data(name), seg_log2)
    lcp, cand = lz_ops.match_table_v1(rows, lens)
    jrows, jlens = rows.numpy(), lens.numpy().astype(np.int32)
    jc = np.asarray(jlz._candidates(jrows, jlens))
    jl = np.asarray(jlz._lcp_estimate(jrows, jc, jlens))
    pos = np.arange(rows.shape[1])[None, :]
    near = (jc >= 0) & (pos - jc <= MAX_DISTANCE)
    assert np.array_equal(cand.numpy(), np.where(near, jc, -1))
    assert np.array_equal(lcp.numpy()[near], jl[near])


@pytest.mark.parametrize("dist", [65535, 65536])
def test_nearest_key_at_the_distance_limit(dist):
    """A key whose nearest earlier copy is `dist` back and whose farther
    copy is 5,000 more: a candidate at 65,535, none at 65,536."""
    data = _data(f"nearest_{dist}")
    p = 5000 + dist
    rows, lens = _rows(data, 17)
    lcp, cand = lz_ops.match_table_v1(rows, lens)
    assert int(cand[0, p]) == (p - dist if dist <= MAX_DISTANCE else -1)
    assert int(lcp[0, p]) == (64 if dist <= MAX_DISTANCE else 0)
    toks = slz4_ref.parse_segment(np.frombuffer(data, np.uint8))
    assert any(t[3] == 65535 for t in toks) == (dist == 65535)
    assert port(data) == v1(data)


@pytest.mark.parametrize("name,seg_log2", _params())
def test_v1_container_is_the_oracles(name, seg_log2):
    data = _data(name)
    assert port(data, seg_log2) == v1(data, seg_log2)


@pytest.mark.parametrize("name", ["jax_case1", "jax_case4", "fields.c",
                                  "run_end_12", "zeros_20000"])
@pytest.mark.parametrize("seg_log2", [7, 12])
def test_greedy_v1_container_is_the_oracles(name, seg_log2):
    """lazy=False: the walk takes every valid match."""
    data = _data(name)
    assert port(data, seg_log2, lazy=False) == v1(data, seg_log2, lazy=False)


@pytest.mark.parametrize("data", [b"", b"x", b"xyz", b"abcd", b"q" * 13])
def test_short_inputs(data):
    """No positions, or too few for a candidate: literals only."""
    for sl in (0, 2, 17):
        assert port(data, sl) == v1(data, sl)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native library is built from "
                    "native/ctrc.cpp)")


def test_equals_the_host_library(gxx):
    """The host library (native/ctrc.cpp) writes the v1 parse too."""
    from cpprcoder_tpu_torch.native import ctrc

    for name in ("jax_case2", "fields.c", "run_end_1", "nearest_65535"):
        data = _data(name)
        for sl in (7, 17):
            for lazy in (True, False):
                assert port(data, sl, lazy) == ctrc.slz4_encode(
                    data, seg_log2=sl, lazy=lazy)


@pytest.mark.parametrize("name,seg_log2", [
    ("jax_case2", 12), ("jax_case3", 12), ("jax_case4", 7),
    ("fields.c", 17), ("kennedy_100k", 16)])
def test_equals_the_jax_package(name, seg_log2):
    """Where C1 and C2 allow (n_segs * (2^seg_log2 / 4 + 3) < 2^18,
    seg_log2 >= 7) the port writes slz4_encode_jax(parse="v1")'s bytes
    (exact unless the JAX lcp estimate's hashes collide)."""
    data = _data(name)
    assert _jax_ok(len(data), seg_log2) and seg_log2 >= 7
    assert port(data, seg_log2) == jlz.slz4_encode_jax(
        data, seg_log2=seg_log2, parse="v1")


def test_match_v1_wrapper():
    """On a CPU tensor the wrapper runs the plain version (no launch
    counted); it checks its inputs as the walk's wrapper does."""
    rows, lens = _rows(corpus_file("grammar.lsp"), 9)
    before = lz_kernels.match_launches
    for a, b in zip(lz_kernels.match_v1(rows, lens),
                    lz_ops.match_table_v1(rows, lens)):
        assert torch.equal(a, b)
    assert lz_kernels.match_launches == before
    with pytest.raises(ValueError, match="uint8"):
        lz_kernels.match_v1(rows.to(torch.int32), lens)
    with pytest.raises(ValueError, match="lens"):
        lz_kernels.match_v1(rows, lens[:1].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        lz_kernels.match_v1(rows.t(), lens)
    with pytest.raises(ValueError, match="parse"):
        lz_ops.slz4_encode(b"abc" * 9, parse="v3", **CPU)
