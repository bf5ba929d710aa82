"""CT-SB in the port, on the CPU, against the JAX package's
codecs/stream.py: the five cases of tests/test_stream_resume.py at a
smaller size (4 KiB superblocks over 10,000 bytes), checkpoints crossing
between the packages both ways, every ported codec under CT-SB, and the
registry's handling of codec id 10 and of codec ids not ported yet.
Integer codecs: exact equality throughout."""

import pickle

import numpy as np
import pytest

import cpprcoder_tpu
import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.codecs import stream as jstream
from cpprcoder_tpu_torch.codecs import stream as tstream
from cpprcoder_tpu_torch.core.bytesutil import ByteWriter

SB_LOG2 = 12
CPU = {"device": "cpu"}


def _data(n=10_000):
    rng = np.random.default_rng(17)
    return bytes(rng.integers(0, 48, n, dtype=np.uint8))


def test_incremental_matches_oneshot():
    data = _data()
    enc = tstream.SuperblockEncoder("rans", sb_log2=SB_LOG2, **CPU)
    for i in range(0, len(data), 1001):  # misaligned pieces
        enc.feed(data[i:i + 1001])
    blob = enc.finish()
    assert blob == tstream.stream_encode(data, codec="rans", sb_log2=SB_LOG2,
                                         **CPU)
    assert blob == jstream.stream_encode(data, codec="rans", sb_log2=SB_LOG2)
    assert tstream.stream_decode(blob, **CPU) == data


def test_checkpoint_resume_after_crash():
    data = _data()
    enc = tstream.SuperblockEncoder("adaptive_range", sb_log2=SB_LOG2, **CPU)
    enc.feed(data[:5000])
    ckpt = pickle.loads(pickle.dumps(enc.checkpoint()))  # survives a restart
    enc2 = tstream.SuperblockEncoder.resume(ckpt, **CPU)
    enc2.feed(data[5000:])
    blob = enc2.finish()
    assert blob == jstream.stream_encode(data, codec="adaptive_range",
                                         sb_log2=SB_LOG2)
    assert tstream.stream_decode(blob, **CPU) == data


def test_checkpoint_rejects_garbage():
    with pytest.raises(ValueError):
        tstream.SuperblockEncoder.resume({"format": "nope"})


def test_decode_range():
    data = _data()
    blob = jstream.stream_encode(data, codec="rans", sb_log2=SB_LOG2)
    assert tstream.stream_encode(data, codec="rans", sb_log2=SB_LOG2,
                                 **CPU) == blob
    for start, stop in [(0, 100), (4100, 4500), (4095, 8200), (9000, 10_000),
                        (5, 5), (9990, 20_000), (12_000, 13_000)]:
        got = tstream.stream_decode_range(blob, start, stop, **CPU)
        assert got == data[start:stop] \
            == jstream.stream_decode_range(blob, start, stop), (start, stop)


def test_empty_stream():
    enc = tstream.SuperblockEncoder("rans", **CPU)
    blob = enc.finish()
    assert blob == jstream.SuperblockEncoder("rans").finish()
    assert blob == tstream.stream_encode(b"", **CPU)
    assert tstream.stream_decode(blob, **CPU) == b""
    assert tstream.stream_decode_range(blob, 0, 0, **CPU) == b""


@pytest.mark.parametrize("direction", ["jax to port", "port to jax"])
def test_checkpoints_cross_between_the_packages(direction):
    """A checkpoint written by either package resumes in the other, key
    for key, and finishes to the JAX stream_encode's bytes (CT-RC2 at its
    defaults, in both packages)."""
    data = _data()
    want = jstream.stream_encode(data, codec="adaptive_range",
                                 sb_log2=SB_LOG2)
    encs = {"jax": jstream.SuperblockEncoder("adaptive_range", SB_LOG2),
            "port": tstream.SuperblockEncoder("adaptive_range", SB_LOG2,
                                              **CPU)}
    for enc in encs.values():
        enc.feed(data[:6000])
    ck = {nm: pickle.loads(pickle.dumps(e.checkpoint()))
          for nm, e in encs.items()}
    assert ck["jax"] == ck["port"]
    if direction == "jax to port":
        enc = tstream.SuperblockEncoder.resume(ck["jax"], **CPU)
    else:
        enc = jstream.SuperblockEncoder.resume(ck["port"])
    enc.feed(data[6000:])
    assert enc.finish() == want


@pytest.mark.parametrize("codec", sorted(set(ctt.list_codecs()) - {"stream"}))
def test_every_ported_codec_under_ct_sb(codec):
    """Each ported codec over 1 KiB superblocks of 2,600 bytes (a short
    tail): the port's CT-SB on the CPU and through its oracles equals the
    JAX package's over the JAX oracles, and decodes back. (slz4's oracle
    writes the v1 parse, as the JAX codec's "ref" backend does, and its
    CPU path the v2 parse of the JAX codec's default backend.)"""
    data = (b"superblocks of every codec " * 60 + _data(1000))[:2600]
    blob = tstream.stream_encode(data, codec=codec, sb_log2=10, **CPU)
    ref = tstream.stream_encode(data, codec=codec, sb_log2=10, backend="ref")
    assert ref == jstream.stream_encode(data, codec=codec, sb_log2=10,
                                        backend="ref")
    assert blob == (ref if codec != "slz4" else
                    jstream.stream_encode(data, codec=codec, sb_log2=10))
    assert tstream.stream_decode(ref, **CPU) == data
    assert tstream.stream_decode(blob, **CPU) == data
    assert tstream.stream_decode_range(blob, 1000, 2100, **CPU) \
        == data[1000:2100]


def test_registry_and_options():
    """compress(codec="stream") is CT-SB (id 10), the codec's options reach
    every superblock, a header naming adaptive_rans (id 13, the last codec
    ported) decodes, and one naming an unknown id raises KeyError."""
    data = _data(3000)
    assert ctt.get_codec_by_id(10) is ctt.get_codec("stream") \
        is tstream.CODEC
    blob = ctt.compress(data, codec="stream", sb_log2=SB_LOG2, lanes=2, **CPU)
    assert blob == cpprcoder_tpu.compress(data, codec="stream",
                                          sb_log2=SB_LOG2, lanes=2)
    assert ctt.decompress(blob, codec="stream", **CPU) == data
    blob = tstream.stream_encode(data[:900], codec="adaptive_rans",
                                 sb_log2=9, **CPU)
    assert blob[0] == 13
    assert blob == jstream.stream_encode(data[:900], codec="adaptive_rans",
                                         sb_log2=9)
    assert tstream.stream_decode(blob, **CPU) == data[:900]
    assert tstream.stream_decode_range(blob, 400, 700, **CPU) \
        == data[400:700]
    head = ByteWriter().u8(99).u8(SB_LOG2).u32(1).u32(0).getvalue()
    with pytest.raises(KeyError, match="unknown codec id"):
        tstream.stream_decode(head, **CPU)
    with pytest.raises(KeyError, match="unknown codec id"):
        tstream.stream_decode_range(head, 0, 1, **CPU)
    # ids 7 (ase) and 11 (adaptive_o1) are ported: their superblocks are
    # the JAX package's and decode
    small = data[:600]
    for codec in ("ase", "adaptive_o1"):
        blob = tstream.stream_encode(small, codec=codec, sb_log2=9, **CPU)
        assert blob == jstream.stream_encode(small, codec=codec, sb_log2=9)
        assert tstream.stream_decode(blob, **CPU) == small
        assert jstream.stream_decode(blob) == small
