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
from cpprcoder_tpu_torch.core.bytesutil import ByteReader, CorruptContainerError
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
    step, off = lz_ops.walk_inputs(rows, lens, lazy)
    return rows, lens, lz_kernels.walk(step, off)


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
    step = torch.ones((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        lz_kernels.walk(step.to(torch.int64), step)
    with pytest.raises(ValueError, match="off"):
        lz_kernels.walk(step, step[:, :4].contiguous())
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
    with pytest.raises(NotImplementedError, match="A11b"):
        lz_ops.slz4_encode(b"abc" * 9, parse="v1", device="cpu")
