"""CT-LZ4 (SLZ4) in the port, on the CPU: the `torch` backend (the plain
versions of kernels P, Q and R) against the v2 oracle
(slz4_ref.slz4_encode(parse="v2")), byte for byte and back, and against
the JAX package's `slz4_encode_jax` wherever its C1 bound allows
(n_segs * (2^seg_log2 / 4 + 3) < 2^18); above it, the oracle alone (the
C1 case). Also the v1 oracle's and the native library's containers,
malformed containers, the plain versions against the oracle's tokens and
`decode_block`, and CT-PIPE and CT-SB over slz4 against the JAX package.
Integer codecs: exact equality throughout."""

import shutil

import numpy as np
import pytest
import torch

import cpprcoder_tpu
import cpprcoder_tpu_torch as ctt
from conftest import CANTERBURY, corpus_file
from cpprcoder_tpu.codecs import stream as jstream
from cpprcoder_tpu.ops import lz_ops as jlz
from cpprcoder_tpu_torch.codecs import stream as tstream
from cpprcoder_tpu_torch.core.bytesutil import (
    ByteReader,
    ByteWriter,
    CorruptContainerError,
)
from cpprcoder_tpu_torch.ops import lz_kernels, lz_ops
from cpprcoder_tpu_torch.reference import slz4_ref
from test_slz4 import _cases

CPU = {"device": "cpu"}


def v2(data, seg_log2=17, lazy=True) -> bytes:
    return slz4_ref.slz4_encode(data, seg_log2=seg_log2, lazy=lazy,
                                parse="v2")


def port(data, seg_log2=17, lazy=True) -> bytes:
    blob = ctt.compress(data, codec="slz4", seg_log2=seg_log2, lazy=lazy,
                        **CPU)
    assert ctt.decompress(blob, codec="slz4", **CPU) == bytes(data)
    return blob


def _rng(seed):
    return np.random.default_rng(seed)


def _edge_cases():
    """Name -> bytes: the edges the oracle defines (short inputs, runs,
    long literal and match lengths, partial last segments)."""
    rng = _rng(13)
    text = corpus_file("fields.c")
    return {
        "empty": b"",
        **{f"{k}_bytes": bytes(rng.integers(97, 100, k, dtype=np.uint8))
           for k in (1, 2, 5, 11, 12, 13)},
        "13_same": b"q" * 13,
        "14_same": b"q" * 14,
        # literal runs of 15, 269 (15 + 254), 270 (15 + 255) and more
        "lit_269": bytes(rng.integers(0, 256, 269, dtype=np.uint8)) + b"ab" * 9,
        "lit_270": bytes(rng.integers(0, 256, 270, dtype=np.uint8)) + b"ab" * 9,
        "lit_1300": bytes(rng.integers(0, 256, 1300, dtype=np.uint8)),
        # match lengths past 15 + 255: several 255 bytes
        "match_600": b"xyz0" + b"abcdefgh" * 75 + b"tail!",
        # a partial last segment ending in zeros, and in a run of one byte
        "tail_zeros": text[:3000] + b"\x00" * 1200,
        "tail_run": text[:3000] + b"\x07" * 1200,
        "tail_short_run": text[:4100] + b"\x07" * 3,
    }


def _params():
    """(name, seg_log2) pairs: the JAX suite's cases and the edges at
    seg_log2 0, 3, 7, 12 and 17 (the oracle walks a segment at a time in
    Python, so the largest inputs skip seg_log2 0 and 3)."""
    out = []
    for name, data in list(_named_cases().items()):
        for sl in (0, 3, 7, 12, 17):
            if sl >= 7 or len(data) <= 10_000:
                out.append((name, sl))
    return out


def _named_cases():
    return {**{f"jax_case{i}": d for i, d in enumerate(_cases())},
            **_edge_cases()}


@pytest.mark.parametrize("name,seg_log2", _params())
def test_torch_backend_equals_the_v2_oracle(name, seg_log2):
    data = _named_cases()[name]
    assert port(data, seg_log2) == v2(data, seg_log2)


@pytest.mark.parametrize("name", ["jax_case1", "jax_case4", "tail_run",
                                  "match_600"])
@pytest.mark.parametrize("seg_log2", [7, 12])
def test_greedy_parse_equals_the_v2_oracle(name, seg_log2):
    """lazy=False: the walk takes every valid match."""
    data = _named_cases()[name]
    assert port(data, seg_log2, lazy=False) == v2(data, seg_log2, lazy=False)


@pytest.mark.parametrize("dist", [65535, 65536])
def test_offsets_at_max_distance(dist):
    """A repeat exactly 65,535 and 65,536 bytes back in one 2^17 segment:
    the first is a match, the second is not."""
    rng = _rng(dist)
    head = bytes(rng.integers(0, 256, 64, dtype=np.uint8))
    filler = bytes(rng.integers(0, 256, dist - 64, dtype=np.uint8))
    data = head + filler + head + b"end of it all"
    blob = port(data)
    assert blob == v2(data)
    toks = slz4_ref.parse_segment_v2(np.frombuffer(data, np.uint8))
    assert any(t[3] == 65535 for t in toks) == (dist == 65535)


@pytest.mark.parametrize("name", ["alice29.txt", "kennedy.xls", "ptt5"])
def test_corpus_files_equal_the_v2_oracle(name):
    data = corpus_file(name)
    assert port(data) == v2(data)


def _concat():
    return b"".join(corpus_file(nm) for nm in CANTERBURY)


def test_past_the_jax_packages_serializer_bound():
    """C1: the first 1,200,000 bytes of the 11 files concatenated are 10
    segments of 2^17, past the JAX serializer's 2^18-token packing. The
    port writes the oracle's 434,770 bytes."""
    data = _concat()[:1_200_000]
    blob = port(data)
    assert len(blob) == 434_770
    assert blob == v2(data)


def _jax_ok(n, seg_log2):
    s = 1 << seg_log2
    return -(-n // s) * (s // 4 + 3) < 1 << 18


@pytest.mark.parametrize("name,seg_log2", [
    ("jax_case0", 12), ("jax_case2", 12), ("jax_case3", 12),
    ("tail_zeros", 12), ("match_600", 7), ("fields.c", 17),
    ("grammar.lsp", 17), ("kennedy_100k", 16)])
def test_equals_the_jax_package(name, seg_log2):
    """Where C1 does not apply the port writes slz4_encode_jax's bytes; each
    decodes the other's container."""
    data = (corpus_file(name) if "." in name else
            corpus_file("kennedy.xls")[:100_000] if name == "kennedy_100k"
            else _named_cases()[name])
    assert _jax_ok(len(data), seg_log2)
    blob = port(data, seg_log2)
    jblob = jlz.slz4_encode_jax(data, seg_log2=seg_log2)
    assert blob == jblob
    assert jlz.slz4_decode_jax(blob) == data
    assert ctt.decompress(jblob, codec="slz4", **CPU) == data


@pytest.mark.parametrize("seg_log2", [3, 12, 17])
def test_v1_oracle_containers_decode(seg_log2):
    """backend="ref" writes the v1 parse, as the JAX codec's "ref" does;
    the port's decoders read it."""
    for data in _cases() + [corpus_file("grammar.lsp")]:
        if seg_log2 < 7 and len(data) > 10_000:
            continue
        blob = ctt.compress(data, codec="slz4", backend="ref",
                            seg_log2=seg_log2)
        assert blob == slz4_ref.slz4_encode(data, seg_log2=seg_log2)
        assert blob == cpprcoder_tpu.compress(data, codec="slz4",
                                              backend="ref",
                                              seg_log2=seg_log2)
        assert ctt.decompress(blob, codec="slz4", **CPU) == data
        assert ctt.decompress(port(data, seg_log2), codec="slz4",
                              backend="ref") == data


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native library is built from "
                    "native/ctrc.cpp)")


def test_native_loader_copy(gxx, tmp_path, monkeypatch):
    """The port's native/ctrc.py builds native/ctrc.cpp under build/host/
    and writes the JAX package's loader's bytes (that loader built into a
    temporary directory here), which are the v1 oracle's; the port's
    decoders read them and the native decoder reads the port's."""
    from cpprcoder_tpu import native as jnative
    from cpprcoder_tpu_torch.native import ctrc

    monkeypatch.setattr(jnative, "_SO", str(tmp_path / "libctrc.so"))
    monkeypatch.setattr(jnative, "_LIB", None)
    assert ctrc.build().parent.parent == ctrc.BUILD_ROOT
    for data in _cases() + [corpus_file("fields.c")]:
        for sl in (7, 17):
            blob = ctt.compress(data, codec="slz4", backend="native",
                                seg_log2=sl)
            assert blob == jnative.slz4_encode(data, seg_log2=sl)
            assert blob == slz4_ref.slz4_encode(data, seg_log2=sl)
            assert ctt.decompress(blob, codec="slz4", **CPU) == data
            assert ctt.decompress(port(data, sl), codec="slz4",
                                  backend="native") == data
    with pytest.raises(CorruptContainerError):
        ctrc.slz4_decode(b"\x01\x00")


def _container(data=None, seg_log2=12):
    data = data or corpus_file("grammar.lsp")
    return data, bytearray(v2(data, seg_log2))


def _first_match(blob):
    """(offset byte position, offset) of segment 0's first match."""
    r = ByteReader(bytes(blob))
    r.u32()
    r.u8()
    r.u32s(r.u32())
    pos = r.pos
    tok = blob[pos]
    lit = tok >> 4
    p = pos + 1
    if lit == 15:
        while blob[p] == 255:
            lit += 255
            p += 1
        lit += blob[p]
        p += 1
    p += lit
    return p, blob[p] | blob[p + 1] << 8


def _malformed(kind):
    data, blob = _container()
    if kind == "truncated_header":
        return bytes(blob[:7])
    if kind == "truncated_sizes":
        return bytes(blob[:10])
    if kind == "truncated_payload":
        return bytes(blob[:-1])
    if kind == "segment_count":
        blob[5] += 1
        return bytes(blob)
    p, off = _first_match(blob)
    if kind == "offset_zero":
        blob[p] = blob[p + 1] = 0
    elif kind == "offset_before_start":
        blob[p], blob[p + 1] = 0xFF, 0xFF
    elif kind == "segment_too_long":   # one more byte than the header says
        blob[0] -= 1
    elif kind == "segment_too_short":  # the block ends 1 byte short
        blob[0] += 1
    elif kind == "size_cut":           # a block cut inside a token
        blob[9] -= 3
        blob = blob[:-3]
    return bytes(blob)


MALFORMED = ["truncated_header", "truncated_sizes", "truncated_payload",
             "segment_count", "offset_zero", "offset_before_start",
             "segment_too_long", "segment_too_short", "size_cut"]


@pytest.mark.parametrize("kind", MALFORMED)
def test_malformed_containers_raise(kind):
    blob = _malformed(kind)
    with pytest.raises(CorruptContainerError):
        ctt.decompress(blob, codec="slz4", **CPU)
    with pytest.raises((ValueError, IndexError)):
        slz4_ref.slz4_decode(blob)


@pytest.mark.parametrize("kind,code", [
    ("offset_zero", lz_kernels.OFFSET_ZERO),
    ("offset_before_start", lz_kernels.OFFSET_BEFORE),
    ("segment_too_long", lz_kernels.WRITE_OVERRUN),
    ("segment_too_short", lz_kernels.BAD_LENGTH),
    ("size_cut", lz_kernels.READ_OVERRUN)])
def test_decode_error_codes(kind, code):
    """Kernel R's plain version names the fault of the segment."""
    blob = _malformed(kind)
    r = ByteReader(blob)
    n, sl, ns = r.u32(), r.u8(), r.u32()
    sizes = torch.from_numpy(r.u32s(ns).astype(np.int64))
    payload = torch.from_numpy(r.raw(int(sizes.sum())).copy())
    _, err = lz_kernels.decode(payload, sizes.cumsum(0) - sizes, sizes, n,
                               1 << sl)
    assert err.tolist() == [code]


def _tokens(data, seg_log2, lazy=True):
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    rows, lens = lz_ops.segment_rows(x, seg_log2)
    lcp, cand = lz_ops.match_table(rows, lens)
    return rows, lens, lz_kernels.walk(lcp, cand, lens, lazy)


@pytest.mark.parametrize("name,seg_log2", [
    ("grammar.lsp", 17), ("fields.c", 7), ("jax_case3", 12),
    ("jax_case2", 12), ("tail_run", 9)])
def test_plain_versions_against_the_oracles_tokens(name, seg_log2):
    """P's matches and Q's bytes are parse_segment_v2's tokens and
    serialize_tokens' blocks, segment by segment; R's plain version decodes
    each block as decode_block does."""
    data = corpus_file(name) if "." in name else _named_cases()[name]
    rows, lens, (mpos, mlen, moff, count) = _tokens(data, seg_log2)
    payload, sizes = lz_kernels.serialize(rows, lens, mpos, mlen, moff, count)
    x = np.frombuffer(data, np.uint8)
    s = 1 << seg_log2
    base = 0
    for i in range(rows.shape[0]):
        seg = x[i * s:(i + 1) * s]
        toks = slz4_ref.parse_segment_v2(seg)
        c = int(count[i])
        assert c == len(toks) - 1
        assert mpos[i, :c].tolist() == [t[0] + t[1] for t in toks[:-1]]
        assert moff[i, :c].tolist() == [t[3] for t in toks[:-1]]
        # the walk's lengths are unclamped: at least the clamped ones
        assert all(m >= t[2] for m, t in zip(mlen[i, :c].tolist(), toks))
        block = payload[base:base + int(sizes[i])].numpy().tobytes()
        assert block == slz4_ref.serialize_tokens(seg, toks)
        assert slz4_ref.decode_block(block, len(seg)) == seg.tobytes()
        base += int(sizes[i])
    out, err = lz_kernels.decode(payload, sizes.cumsum(0) - sizes, sizes,
                                 len(data), s)
    assert err.abs().sum() == 0 and out.numpy().tobytes() == data


def test_wrappers_check_their_inputs():
    lcp = torch.ones((2, 8), dtype=torch.int64)
    lens = torch.full((2,), 8, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        lz_kernels.walk(lcp.to(torch.int32), lcp, lens)
    with pytest.raises(ValueError, match="cand"):
        lz_kernels.walk(lcp, lcp[:, :4].contiguous(), lens)
    with pytest.raises(ValueError, match="lens"):
        lz_kernels.walk(lcp, lcp, lens[:1].contiguous())
    with pytest.raises(ValueError, match="segments"):
        lz_kernels.decode(torch.zeros(4, dtype=torch.uint8),
                          torch.zeros(1, dtype=torch.int64),
                          torch.ones(1, dtype=torch.int64), 300, 128)
    with pytest.raises(TypeError, match="device"):
        lz_ops.slz4_encode(b"needs a device")


def test_pipeline_stage_and_stream_equal_the_jax_package():
    """CT-PIPE with an slz4 stage and CT-SB over slz4: the JAX package's
    containers (its "jax" backend, the v2 parse), read back both ways."""
    data = corpus_file("fields.c") * 2
    stages = [("slz4", {"seg_log2": 12}), "rans"]
    blob = ctt.compress(data, codec="pipeline", stages=stages, **CPU)
    assert blob[:3] == bytes([2, 6, 2])
    assert blob == cpprcoder_tpu.compress(data, codec="pipeline",
                                          stages=stages)
    assert ctt.decompress(blob, codec="pipeline", **CPU) == data
    sblob = tstream.stream_encode(data, codec="slz4", sb_log2=13, **CPU)
    assert sblob[0] == 6
    assert sblob == jstream.stream_encode(data, codec="slz4", sb_log2=13)
    assert tstream.stream_decode(sblob, **CPU) == data
    assert jstream.stream_decode(sblob) == data
    assert tstream.stream_decode_range(sblob, 8000, 9000, **CPU) \
        == data[8000:9000]


def test_registry_has_slz4():
    c = ctt.get_codec("slz4")
    assert c.codec_id == 6 and ctt.get_codec_by_id(6) is c
    assert "slz4" in ctt.list_codecs()
    data = b"abc" * 9 + corpus_file("fields.c")[:500]
    assert lz_ops.slz4_encode(data, parse="v1", device="cpu") \
        == slz4_ref.slz4_encode(data, parse="v1")


# ------------------------------------------------- kernel R's failed segments

def _payload(blob):
    """A container's (payload, bases, sizes, n, s) as CPU tensors."""
    r = ByteReader(bytes(blob))
    n, sl, ns = r.u32(), r.u8(), r.u32()
    sizes = r.u32s(ns).astype(np.int64)
    payload = torch.from_numpy(r.raw(int(sizes.sum())).copy())
    sizes = torch.from_numpy(sizes)
    return payload, sizes.cumsum(0) - sizes, sizes, n, 1 << sl


@pytest.mark.parametrize("kind,code", [
    ("offset_zero", lz_kernels.OFFSET_ZERO),
    ("offset_before_start", lz_kernels.OFFSET_BEFORE),
    ("segment_too_long", lz_kernels.WRITE_OVERRUN),
    ("segment_too_short", lz_kernels.BAD_LENGTH),
    ("size_cut", lz_kernels.READ_OVERRUN)])
def test_failed_segment_is_zero(kind, code):
    """A segment whose code is not 0 is all zero in decode_plain's output
    (kernel R's contract), with its code."""
    out, err = lz_kernels.decode(*_payload(_malformed(kind)))
    assert err.tolist() == [code]
    assert not out.any()


def _eight_segments(bad=3):
    """kennedy.xls's first 32,768 bytes at seg_log2 12 (8 segments), with
    the offset of segment `bad`'s first match set to 0."""
    data = corpus_file("kennedy.xls")[:8 << 12]
    blob = bytearray(v2(data, 12))
    sizes = np.frombuffer(bytes(blob[9:41]), "<u4").astype(np.int64)
    head = 41 + int(sizes[:bad].sum())
    seg = blob[head:head + int(sizes[bad])]
    p, _ = _first_match(bytes(9) + bytes(seg))
    p -= 9
    blob[head + p] = blob[head + p + 1] = 0
    return data, bytes(blob)


def test_one_corrupted_segment_of_eight():
    """Segment 3 of 8 is zero and has its code; the others decode."""
    data, blob = _eight_segments()
    args = _payload(blob)
    for out, err in (lz_kernels.decode(*args), _r_model(*args)[:2]):
        assert err.tolist() == [0, 0, 0, lz_kernels.OFFSET_ZERO, 0, 0, 0, 0]
        got = bytes(out.numpy())
        assert got[3 << 12:4 << 12] == bytes(1 << 12)
        assert got[:3 << 12] == data[:3 << 12]
        assert got[4 << 12:] == data[4 << 12:]
    with pytest.raises(CorruptContainerError, match="segment 3 of 8"):
        ctt.decompress(blob, codec="slz4", **CPU)


# --------------------------------------- a numpy model of kernel R's design

MAX_THREADS, MIN_LB, PROBE = 512, 4, 32
GOES_ON, LIT_EXT, LIT_DATA, OFF_BYTES, OFF_ZERO, MATCH_EXT = range(6)
RESOLVED = 1 << 31


def _r_next(b):
    """The token at every position p of a block b (csrc/lz_decode.cu
    `parse`), as arrays over p: lit, lsrc, off, mlen, nx (the next token
    start; size + 1 where a check that needs no output position fails),
    stop (the check, GOES_ON where none)."""
    size = len(b)
    x = np.concatenate([b.astype(np.int64), np.zeros(4, np.int64)])
    pos = np.arange(size + 1)
    # first position at or after q whose byte is not 255 (size: none)
    nn = np.minimum.accumulate(
        np.where(np.append(b != 255, True), pos, size)[::-1])[::-1]
    p = np.arange(size)
    tok = x[p]
    q = p + 1
    lit = tok >> 4
    stop = np.zeros(size, np.int64)
    e = nn[q]
    ext = lit == 15
    stop[ext & (e >= size)] = LIT_EXT
    lit = np.where(ext, 15 + 255 * (e - q) + x[np.minimum(e, size)], lit)
    q = np.where(ext, e + 1, q)
    stop[(stop == 0) & (q + lit > size)] = LIT_DATA
    r = q + lit
    last = (stop == 0) & (r == size)
    stop[(stop == 0) & ~last & (r + 2 > size)] = OFF_BYTES
    rc = np.minimum(r, size)
    off = x[rc] | x[np.minimum(rc + 1, size)] << 8
    stop[(stop == 0) & ~last & (off == 0)] = OFF_ZERO
    r2 = np.minimum(r + 2, size)
    e2 = nn[r2]
    mext = (tok & 15) == 15
    stop[(stop == 0) & ~last & mext & (e2 >= size)] = MATCH_EXT
    mlen = np.where(mext, 19 + 255 * (e2 - r2) + x[np.minimum(e2, size)],
                    (tok & 15) + slz4_ref.MIN_MATCH)
    nx = np.where(mext, e2 + 1, r2)
    ok = stop == 0
    mlen = np.where(ok & ~last, mlen, 0)
    off = np.where(ok & ~last, off, 0)
    nx = np.where(ok, np.where(last, size, nx), size + 1)
    return dict(lit=lit, lsrc=q, off=off, mlen=mlen, nx=nx, stop=stop)


def _token_code(stop, lit, mlen, off, d, length):
    """csrc/lz_decode.cu `token_code`: a token's first failing check."""
    if stop in (LIT_EXT, LIT_DATA):
        return lz_kernels.READ_OVERRUN
    if d + lit > length:
        return lz_kernels.WRITE_OVERRUN
    if stop in (OFF_BYTES, MATCH_EXT):
        return lz_kernels.READ_OVERRUN
    if stop == OFF_ZERO:
        return lz_kernels.OFFSET_ZERO
    if mlen == 0:
        return 0
    if d + lit < off:
        return lz_kernels.OFFSET_BEFORE
    return lz_kernels.WRITE_OVERRUN if d + lit + mlen > length else 0


def _r_geometry(s, size):
    """(threads, blen): the token kernel's CTA for segments of s bytes and
    a block's positions a thread (2^lb + 4), as ct_lz_decode picks them."""
    cap = s + s // 255 + 16
    threads = min(MAX_THREADS, -(-cap // 512) * 32)
    lb = MIN_LB
    while threads * ((1 << lb) + 4) < size or (1 << 2 * lb) < size // 3:
        lb += 1
    return threads, (1 << lb) + 4


def _r_tokens(b, s, length, tcap):
    """Kernel R's token kernel on one block: the next table, thread 0's
    first PROBE tokens, then (where the block goes on) each block's exits
    (scanned backwards) and thread 0's hops, the re-walks from the
    entries, the first-error rule. -> (code, token table [k, 4]: output
    start, literal length, literal source, offset; the walk's tokens in
    order for the checks)."""
    t = _r_next(b)
    size = len(b)
    _, blen = _r_geometry(s, size)
    nb = -(-size // blen)
    his = np.minimum((np.arange(nb) + 1) * blen, size)
    entry = np.full(nb, -1)
    p = 0
    for _ in range(PROBE):               # thread 0's first tokens
        if p >= size:
            break
        if entry[p // blen] < 0:
            entry[p // blen] = p
        p = int(t["nx"][p])
    if p < size:
        ex = np.zeros(size, np.int64)
        for k in range(blen - 1, -1, -1):     # every block's scan, in step
            q = np.arange(nb) * blen + k
            act = q < his
            q, hi = q[act], his[act]
            nx = t["nx"][q]
            ex[q] = np.where(nx >= hi, nx, ex[np.minimum(nx, size - 1)])
        hops = 0
        while p < size:
            if entry[p // blen] < 0:
                entry[p // blen] = p
            p = int(ex[p])
            hops += 1
        assert hops <= nb
    walk = []
    for blk in range(nb):                 # the re-walks, in block order
        p = int(entry[blk])
        while 0 <= p < his[blk]:
            walk.append(p)
            p = int(t["nx"][p])
    code, d, table = 0, 0, []
    for k, p in enumerate(walk):
        lit, mlen, off = int(t["lit"][p]), int(t["mlen"][p]), int(t["off"][p])
        c = _token_code(int(t["stop"][p]), lit, mlen, off, d, length)
        if c:
            code = c
            break
        if k < tcap:
            table.append((d, lit, int(t["lsrc"][p]), off))
        d += lit + mlen
    if not code and d != length:
        code = lz_kernels.BAD_LENGTH
    return code, np.array(table, np.int64).reshape(-1, 4), walk


def _serial_walk(b):
    """Token starts from 0 by next(p), one after another."""
    nx = _r_next(b)["nx"]
    p, out = 0, []
    while p < len(b):
        out.append(p)
        p = int(nx[p])
    return out


def _r_model(payload, bases, sizes, n, s):
    """Kernel R's design in numpy -> (out, err, rounds it needed): the token
    kernel a segment, then every byte's owner token, the literal bytes and
    the match bytes' mod-hop pointers, and rounds of HOPS hops a byte read
    from the array as the round found it (the least that a round of the
    kernel, which hops in place, achieves)."""
    comp = payload.numpy()
    s = min(s, n)
    n_segs = len(bases)
    tcap, rounds = lz_kernels.decode_geometry(n, s)
    err = np.zeros(n_segs, np.int32)
    src = np.zeros(n, np.int64)
    for i in range(n_segs):
        b = comp[int(bases[i]):int(bases[i]) + int(sizes[i])]
        length = min(s, n - i * s)
        code, table, walk = _r_tokens(b, s, length, tcap)
        if code != lz_kernels.READ_OVERRUN:
            assert walk == _serial_walk(b)[:len(walk)]
        err[i] = code
        d = np.arange(length)
        if code:
            src[i * s:i * s + length] = RESOLVED
            continue
        start, lit, lsrc, off = table.T
        own = np.searchsorted(start, d, "right") - 1
        j = d - start[own]
        in_lit = j < lit[own]
        byte = comp[np.minimum(int(bases[i]) + lsrc[own] + j,
                               len(comp) - 1)].astype(np.int64)
        mj = j - lit[own]
        ptr = start[own] + lit[own] - off[own] + mj % np.maximum(off[own], 1)
        src[i * s:i * s + length] = np.where(in_lit, RESOLVED | byte, ptr)
    base = np.arange(n) // s * s
    used = 0
    while (src < RESOLVED).any():
        used += 1
        assert used <= rounds, "pointers left after the rounds"
        snap = src.copy()
        for _ in range(lz_kernels.HOPS):
            ptr = src < RESOLVED
            src[ptr] = snap[base[ptr] + src[ptr]]
    out = torch.from_numpy((src & 255).astype(np.uint8))
    return out, torch.from_numpy(err), used


def _chain_block(tokens):
    """An LZ4 block whose every match copies the previous token's match:
    5 literals and a match of 4 at offset 4, then `tokens` tokens of one
    literal and a match of 4 at offset 5, then 5 literals. -> (block, n)."""
    block = bytearray([0x50]) + b"abcde" + bytes([4, 0])
    for i in range(tokens):
        block += bytes([0x10, 97 + i % 26, 5, 0])
    block += bytes([0x50]) + b"vwxyz"
    return bytes(block), 14 + 5 * tokens


def _run_block(n, byte=ord("q")):
    """One literal and a match at offset 1 of n - 1 bytes."""
    m = n - 1 - slz4_ref.MIN_MATCH - 15
    return (bytes([0x1F, byte, 1, 0]) + b"\xff" * (m // 255)
            + bytes([m % 255]))


def _block_container(block, n):
    return (ByteWriter().u32(n).u8(17).u32(1).u32(len(block)).raw(block)
            .getvalue())


MODEL_CASES = [*(f"text at seg_log2 {sl}" for sl in (0, 3, 7, 12, 17)),
               "grammar.lsp", "kennedy.xls[:200000] at 16",
               "alice29.txt v1 at 12", "offset-1 run of 2^17",
               "longest chain", "tail zeros at 9"]


def _model_case(name):
    """The container of a MODEL_CASES entry."""
    text = corpus_file("fields.c")
    if name.startswith("text at seg_log2"):
        sl = int(name.split()[-1])
        return v2(text[:3000] if sl < 7 else text, sl)
    if name == "grammar.lsp":
        return v2(corpus_file("grammar.lsp"))
    if name == "kennedy.xls[:200000] at 16":
        return v2(corpus_file("kennedy.xls")[:200_000], 16)
    if name == "alice29.txt v1 at 12":
        return slz4_ref.slz4_encode(corpus_file("alice29.txt")[:60_000],
                                    seg_log2=12)
    if name == "offset-1 run of 2^17":
        return _block_container(_run_block(1 << 17), 1 << 17)
    if name == "longest chain":
        return _block_container(*_chain_block((131_072 - 14) // 5))
    return v2(_edge_cases()["tail_zeros"], 9)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_r_model_equals_plain_and_the_oracle(name):
    """The numpy model of kernel R's design decodes each container as
    decode_plain does and to the oracle's bytes."""
    blob = _model_case(name)
    args = _payload(blob)
    out, err, used = _r_model(*args)
    pout, perr = lz_kernels.decode_plain(*args)
    assert err.tolist() == perr.tolist() == [0] * len(err)
    assert torch.equal(out, pout)
    assert bytes(out.numpy()) == slz4_ref.slz4_decode(blob)
    if name == "longest chain":
        # 26,211 tokens, each match a hop past the one before: 8^4 < 26,212
        # <= 8^5 (HOPS = 7), the most of any case
        assert used == 5


@pytest.mark.parametrize("kind", ["offset_zero", "offset_before_start",
                                  "segment_too_long", "segment_too_short",
                                  "size_cut"])
def test_r_model_on_malformed_blocks(kind):
    """The model's first-error rule gives decode_plain's code and zeros."""
    args = _payload(_malformed(kind))
    out, err, _ = _r_model(*args)
    pout, perr = lz_kernels.decode_plain(*args)
    assert err.tolist() == perr.tolist() and torch.equal(out, pout)


@pytest.mark.parametrize("name", ["grammar.lsp", "text at seg_log2 7",
                                  "offset-1 run of 2^17"])
def test_r_model_equals_the_jax_package(name):
    """The model's token table is the JAX package's `_walk_v2_fn` records
    (literal source, literal length, output start, match length, offset)
    and its bytes `_resolve_v2_fn`'s (slz4_decode_jax_v2), below C1."""
    blob = _model_case(name)
    payload, bases, sizes, n, s = _payload(blob)
    assert _jax_ok(n, s.bit_length() - 1)
    n_segs = len(sizes)
    cmax = -(-(int(sizes.max()) + 8) // jlz.WALK_B) * jlz.WALK_B
    t_eff = min(jlz._t_cap(s), cmax)
    comp = np.zeros(int(sizes.sum()) + 16, np.uint8)
    comp[:int(sizes.sum())] = payload.numpy()
    b32, e32 = bases.numpy().astype(np.int32), (bases + sizes).numpy().astype(
        np.int32)
    recs = [np.asarray(r).T for r in jlz._walk_v2_cached(n_segs, t_eff, cmax)(
        comp, b32, e32)]
    tcap, _ = lz_kernels.decode_geometry(n, s)
    for i in range(n_segs):
        b = payload.numpy()[int(bases[i]):int(bases[i] + sizes[i])]
        code, table, walk = _r_tokens(b, s, min(s, n - i * s), tcap)
        nxt = _r_next(b)
        k = len(table)
        assert code == 0 and k <= t_eff
        start, lit, lsrc, off = table.T
        mlen = nxt["mlen"][walk]
        assert recs[0][i, :k].tolist() == (lsrc + int(bases[i])).tolist()
        assert recs[1][i, :k].tolist() == lit.tolist()
        assert recs[2][i, :k].tolist() == start.tolist()
        assert recs[3][i, :k].tolist() == mlen.tolist()
        assert recs[4][i, :k].tolist() == off.tolist()
        assert not recs[1][i, k:].any() and not recs[3][i, k:].any()
    out, _, _ = _r_model(payload, bases, sizes, n, s)
    assert bytes(out.numpy()) == jlz.slz4_decode_jax_v2(blob)


def test_decode_geometry():
    """tcap holds every token of a segment that decodes, and the rounds
    reach across the longest chain a segment can hold: a hop a token with a
    match, min(s, n) // 4 of them."""
    for n, s in ((1, 1), (300, 1), (2000, 8), (11_150, 128), (70_000, 1 << 17),
                 (1 << 20, 1 << 14), (1 << 20, 1 << 17), (1 << 20, 1 << 18)):
        tcap, rounds = lz_kernels.decode_geometry(n, s)
        hops = min(n, s) // 4
        assert tcap == hops + 2
        assert (lz_kernels.HOPS + 1) ** rounds >= hops
        assert rounds == 1 or (lz_kernels.HOPS + 1) ** (rounds - 1) < hops
    assert lz_kernels.decode_geometry(131_069, 1 << 17)[1] == 5
    scratch = lz_kernels.decode_scratch(1000, 3, 300_000, 1 << 17, "cpu")
    assert [t.numel() for t in scratch] == [1000, 1000, 3 * 4 * 32_770, 3,
                                            300_000, 6]
    assert all(t.data_ptr() % 16 == 0 for t in scratch[2:5:2])


# ------------------------------------------- kernel Q's worst-case payload

def _match_dense(n, seed=5):
    """Words of 4 to 8 bytes drawn from 40: short matches everywhere."""
    rng = _rng(seed)
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8))
             for k in rng.integers(4, 9, 40)]
    out = b""
    while len(out) < n:
        out += words[int(rng.integers(0, 40))]
    return out[:n]


@pytest.mark.parametrize("name", ["all literals", "zero run", "match dense",
                                  "kennedy.xls"])
def test_payload_bound_holds(name):
    """Each segment's block is at most L + L // 255 + 2 bytes (the proof in
    payload_bound), so within payload_bound(L) and payload_bound(W)."""
    data = {"all literals": _rng(8).integers(0, 256, 300_000, np.uint8)
            .tobytes(),
            "zero run": bytes(140_000),
            "match dense": _match_dense(140_000),
            "kennedy.xls": corpus_file("kennedy.xls")[:300_000]}[name]
    for sl in (7, 12, 17):
        blob = v2(data, sl)
        r = ByteReader(blob)
        n, _, ns = r.u32(), r.u8(), r.u32()
        sizes = r.u32s(ns)
        w = min(1 << sl, n)
        for i, z in enumerate(sizes.tolist()):
            length = min(w, n - i * w)
            assert z <= length + length // 255 + 2
            assert z <= lz_kernels.payload_bound(length) \
                <= lz_kernels.payload_bound(w)
    if name == "all literals":   # the bound is nearly met: one literal run
        assert sizes[0] == (1 << 17) + ((1 << 17) - 15) // 255 + 2


@pytest.mark.parametrize("name,seg_log2", [("grammar.lsp", 17),
                                           ("fields.c", 7), ("zeros", 12)])
def test_serialize_plain_is_padded(name, seg_log2):
    """serialize_plain returns n_segs * payload_bound(W) bytes: the blocks
    in order from byte 0, the oracle's, and zeros past them."""
    data = bytes(20_000) if name == "zeros" else corpus_file(name)
    rows, lens, tokens = _tokens(data, seg_log2)
    payload, sizes = lz_kernels.serialize(rows, lens, *tokens)
    n_segs, w = rows.shape
    total = int(sizes.sum())
    assert payload.numel() == n_segs * lz_kernels.payload_bound(w)
    assert not payload[total:].any()
    assert bytes(payload[:total].numpy()) == v2(data, seg_log2)[
        9 + 4 * n_segs:]
