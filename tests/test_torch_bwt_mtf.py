"""CT-BWT1 (blocksort), CT-MTF1 (mtf, mtf1), CT-RLE0 (rle0) and CT-PIPE
(pipeline) in the port, on the CPU (tensor code, and the plain version of
kernels M and N), with exact equality throughout (tolerance 0).

The same seeded inputs go through the JAX package's bwt_ops / mtf_ops /
rle0_ops / pipeline_encode (XLA on the CPU, no Pallas kernel) and through
the port's `backend="torch"`: the containers must be byte-identical, equal
to the oracles (the port's copies of reference/{bwt,mtf,rle0}_ref.py), and
decode on both sides."""

import numpy as np
import pytest
import torch

from conftest import corpus_file

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.codecs.pipeline import pipeline_decode, pipeline_encode
from cpprcoder_tpu.ops import bwt_ops as jbwt
from cpprcoder_tpu.ops import mtf_ops as jmtf
from cpprcoder_tpu.ops import rle0_ops as jrle0
from cpprcoder_tpu_torch.codecs.pipeline import DEFAULT_STAGES
from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError
from cpprcoder_tpu_torch.ops import bwt_ops, mtf_kernels, mtf_ops, rle0_ops
from cpprcoder_tpu_torch.reference import bwt_ref, mtf_ref, rle0_ref


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8))
             for _ in range(150)]
    return b" ".join(words[i] for i in rng.integers(0, 150, n // 3))[:n]


def _runs(n, seed):
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 256))]) * int(rng.integers(1, 200))
    return bytes(out[:n])


# --------------------------------------------------------------- CT-BWT1

BWT_CASES = {
    # block_log2 8: 256-byte blocks
    "grammar.lsp, 8": (lambda: corpus_file("grammar.lsp"), 8),
    "tied rotations, 8": (lambda: b"ab" * 128 + b"xyz" * 100, 8),
    "one repeated byte, 8": (lambda: b"\x00" * 1000, 8),
    "runs, 8": (lambda: _runs(3000, 1), 8),
    "n = 0, 8": (lambda: b"", 8),
    "n = 1, 8": (lambda: b"q", 8),
    # block_log2 12: 4096-byte blocks, the tail split 2048 .. 256 + raw
    "grammar.lsp, 12": (lambda: corpus_file("grammar.lsp"), 12),
    "text 16 KB, 12": (lambda: _text(16_000, 2), 12),
    "tied rotations, 12": (lambda: b"abcd" * 1024 + b"\x07" * 300, 12),
    "below one block, 12": (lambda: _text(700, 3), 12),
}


@pytest.mark.parametrize("case", list(BWT_CASES))
def test_blocksort_matches_jax_and_oracle(case):
    make, block_log2 = BWT_CASES[case]
    data = make()
    blob = ctt.compress(data, codec="blocksort", device="cpu",
                        block_log2=block_log2)
    assert blob == jbwt.bwt_encode_jax(data, block_log2=block_log2)
    assert blob == bwt_ref.bwt_encode(data, block_log2=block_log2)
    assert ctt.decompress(blob, codec="blocksort", device="cpu") == data
    assert jbwt.bwt_decode_jax(blob) == data


@pytest.mark.parametrize("b", [256, 4096])
def test_tied_blocks_at_the_sort_interface(b):
    """Blocks whose rotations tie (a period dividing the block, one byte)
    next to a plain one, batched: the same last columns and rows as the
    JAX package's fixed-round sort with its index tiebreak, and as the
    oracle's sort that stops once every rank is distinct."""
    blocks = np.stack([np.frombuffer(b"abc" * (b // 3) + b"a" * (b % 3),
                                     np.uint8),
                       np.frombuffer((b"xy" * b)[:b], np.uint8),
                       np.full(b, 9, np.uint8),
                       np.frombuffer(_text(b, 4), np.uint8)])
    last, rows = bwt_ops.forward_blocks(torch.from_numpy(blocks))
    jlast, jrows = jbwt._forward_fn(4, b)(blocks)
    assert np.array_equal(last.numpy(), np.asarray(jlast))
    assert np.array_equal(rows.numpy(), np.asarray(jrows))
    for i in range(4):
        olast, orow = bwt_ref.bwt_forward_block(blocks[i])
        assert np.array_equal(last[i].numpy(), olast) and rows[i] == orow
    assert np.array_equal(bwt_ops.inverse_blocks(last, rows).numpy(), blocks)


def test_blocksort_rejects_a_row_past_its_block():
    blob = bytearray(bwt_ref.bwt_encode(b"z" * 300, block_log2=8))
    blob[5 + 256:5 + 260] = (256).to_bytes(4, "little")
    with pytest.raises(CorruptContainerError, match="row index"):
        ctt.decompress(bytes(blob), codec="blocksort", device="cpu")


# --------------------------------------------------------------- CT-MTF1

MTF_CASES = {
    "grammar.lsp": lambda: corpus_file("grammar.lsp"),
    "runs": lambda: _runs(4000, 5),
    "one repeated byte": lambda: b"\xee" * 3000,
    "n = 0": lambda: b"",
    "n = 1": lambda: b"\x01",
    "text 16 KB": lambda: _text(16_000, 6),
}


@pytest.mark.parametrize("codec", ["mtf", "mtf1"])
@pytest.mark.parametrize("case", list(MTF_CASES))
def test_mtf_matches_jax_and_oracle(codec, case):
    data = MTF_CASES[case]()
    mtf1 = codec == "mtf1"
    blob = ctt.compress(data, codec=codec, device="cpu")
    assert blob == jmtf.mtf_encode_jax(data, mtf1)
    assert blob == mtf_ref.mtf_encode(data, mtf1)
    assert ctt.decompress(blob, codec=codec, device="cpu") == data
    assert jmtf.mtf_decode_jax(blob) == data


@pytest.mark.parametrize("mtf1", [False, True])
def test_mtf_across_a_block_boundary(mtf1):
    """Two 2^15-byte blocks, the second cut short: each starts from the
    identity list and prev = 1, as in the JAX package and the oracle."""
    data = (_text(20_000, 7) + _runs(14_000, 8))[:mtf_ref.MTF_BLOCK + 301]
    blob = ctt.compress(data, codec="mtf1" if mtf1 else "mtf", device="cpu")
    assert blob == jmtf.mtf_encode_jax(data, mtf1)
    assert blob == mtf_ref.mtf_encode(data, mtf1)
    assert ctt.decompress(blob, codec="mtf", device="cpu") == data


def test_mtf_wrappers_check_their_arguments():
    blocks = torch.zeros((2, mtf_ref.MTF_BLOCK), dtype=torch.uint8)
    with pytest.raises(ValueError, match="does not fill"):
        mtf_kernels.encode_ranks(blocks, 100, False)
    with pytest.raises(ValueError, match="uint8"):
        mtf_kernels.decode_bytes(blocks.to(torch.int32), 40_000, True)
    x = torch.arange(100, dtype=torch.uint8)
    ranks = mtf_kernels.encode_ranks(mtf_ops.pad_blocks(x), 100, True)
    assert torch.equal(mtf_kernels.decode_bytes(mtf_ops.pad_blocks(ranks),
                                                 100, True), x)


# --------------------------------------------------------------- CT-RLE0

RLE0_CASES = {
    "n = 0": lambda: b"",
    "n = 1, a zero": lambda: b"\x00",
    "n = 1": lambda: b"a",
    "a long run": lambda: b"\x00" * 100_000,
    "escapes next to runs": lambda: b"\xfe\xff\x00\x00\xff\xfe",
    "short runs": lambda: bytes([0, 1, 0, 0, 2, 0] * 500),
    "random": lambda: bytes(np.random.default_rng(9).integers(
        0, 256, 4097, dtype=np.uint8)),
    "mtf-like skew": lambda: bytes(np.random.default_rng(10).integers(
        0, 3, 9000, dtype=np.uint8)),
    "escape heavy": lambda: bytes(np.random.default_rng(11).integers(
        253, 256, 777, dtype=np.uint8)),
    "grammar.lsp after mtf1": lambda: mtf_ref.mtf_encode(
        corpus_file("grammar.lsp"), True)[5:],
}


@pytest.mark.parametrize("case", list(RLE0_CASES))
def test_rle0_matches_jax_and_oracle(case):
    data = RLE0_CASES[case]()
    blob = ctt.compress(data, codec="rle0", device="cpu")
    assert blob == jrle0.rle0_encode_jax(data)
    assert blob == rle0_ref.rle0_encode(data)
    assert len(blob) - 4 <= 2 * len(data)
    assert ctt.decompress(blob, codec="rle0", device="cpu") == data
    assert jrle0.rle0_decode_jax(blob) == data


def test_rle0_run_digits_and_bad_length():
    """A run of L zeros is floor(log2(L + 1)) digits, least significant
    first; a container whose tokens do not make n bytes raises."""
    for run in (1, 2, 3, 6, 7, 255, 65_535, 65_536):
        toks = rle0_ops.encode_tokens(torch.zeros(run, dtype=torch.uint8))
        digits = [((run + 1) >> j) & 1 for j in range((run + 1).bit_length() - 1)]
        assert toks.tolist() == digits
    blob = rle0_ref.rle0_encode(b"\x05\x00\x00\x09")
    bad = (5).to_bytes(4, "little") + blob[4:]
    with pytest.raises(ValueError, match="expected 5"):
        ctt.decompress(bad, codec="rle0", device="cpu")


# --------------------------------------------------------------- CT-PIPE

def test_default_pipeline_matches_jax_and_oracle():
    """BASELINE Config 4 (blocksort at 2^19, mtf1, rle0, adaptive_range):
    the port's CPU path, the JAX package and the oracles write the same
    container, and each decodes it."""
    data = corpus_file("grammar.lsp")
    assert DEFAULT_STAGES == [("blocksort", {"block_log2": 19}), "mtf1",
                              "rle0", "adaptive_range"]
    blob = ctt.compress(data, codec="pipeline", device="cpu")
    assert blob[:5] == bytes([4, 4, 8, 12, 1])
    assert blob == pipeline_encode(data)
    assert blob == ctt.compress(data, codec="pipeline", backend="ref")
    assert ctt.decompress(blob, codec="pipeline", device="cpu") == data
    assert ctt.decompress(blob, codec="pipeline", backend="ref") == data
    assert pipeline_decode(blob) == data


def test_named_stage_pipeline():
    """The (name, opts) stage form, options reaching their stage."""
    data = _text(3000, 12)
    stages = [("blocksort", {"block_log2": 10}), "mtf", "rle0",
              ("static_range", {"lanes": 4})]
    blob = ctt.compress(data, codec="pipeline", device="cpu", stages=stages)
    assert blob[:5] == bytes([4, 4, 5, 12, 0])
    assert blob == pipeline_encode(data, stages=stages)
    assert blob == ctt.compress(data, codec="pipeline", backend="ref",
                                stages=stages)
    assert ctt.decompress(blob, codec="pipeline", device="cpu") == data


def test_pipeline_stage_not_yet_ported():
    """adaptive_rans (id 13), the last codec ported, is a pipeline stage:
    its container is the JAX package's and the oracle's and decodes; a
    stage the registry lacks still raises KeyError, on encode (by name)
    and on decode (by id)."""
    data = b"abc" * 50
    stages = ["adaptive_rans"]
    blob = ctt.compress(data, codec="pipeline", device="cpu", stages=stages)
    assert blob[:2] == bytes([1, 13])
    assert blob == pipeline_encode(data, stages=stages)
    assert blob == ctt.compress(data, codec="pipeline", backend="ref",
                                stages=stages)
    assert ctt.decompress(blob, codec="pipeline", device="cpu") == data
    assert pipeline_decode(blob) == data
    with pytest.raises(KeyError, match="unknown codec"):
        ctt.compress(data, codec="pipeline", device="cpu",
                     stages=["adaptive_ranz"])
    blob = bytes([1, 99]) + b"whatever"
    with pytest.raises(KeyError, match="unknown codec id"):
        ctt.decompress(blob, codec="pipeline", device="cpu")


def test_container_functions_need_a_device():
    data = b"explicit device " * 20
    for enc, dec in ((bwt_ops.bwt_encode, bwt_ops.bwt_decode),
                     (mtf_ops.mtf_encode, mtf_ops.mtf_decode),
                     (rle0_ops.rle0_encode, rle0_ops.rle0_decode)):
        with pytest.raises(TypeError, match="device"):
            enc(data)
        blob = enc(data, device="cpu")
        with pytest.raises(TypeError, match="device"):
            dec(blob)
        assert dec(blob, device="cpu") == data
