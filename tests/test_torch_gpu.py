"""The CUDA kernels against their plain versions, on the card. Marked `gpu`:
they skip where no CUDA device is present. On a GPU machine without JAX
(tests/conftest.py imports it) and without pytest-xdist, run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -o addopts=
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.models.qmodel import rcq_params
from cpprcoder_tpu_torch.ops import (
    compaction,
    expand,
    huffman_kernels,
    huffman_ops,
    layout,
    rans_kernels,
    rans_ops,
    rcq_kernels,
    rcx_kernels,
    rcx_ops,
)
from cpprcoder_tpu_torch.reference import rans_ref, rcx_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


@pytest.mark.parametrize("k,cbits,wlog", [(8, 0, 3), (32, 6, 2), (256, 8, 0),
                                          (1024, 5, 1), (3000, 4, 2)])
def test_coder_kernels_match_plain(dev, k, cbits, wlog):
    n = 40 * k + 7
    x = torch.from_numpy(_textish(n, k)).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_chunked(x, k, stride)
    lens = layout.lane_lengths(n, k, stride, dev)
    args = (16, 1 << 16, cbits, wlog)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, *args))
    rows, sizes = expand.materialize_rows(ev)
    prow, psizes = compaction.materialize_rows_t(ev, rows.shape[1])
    assert torch.equal(rows, prow) and torch.equal(sizes, psizes)
    words = layout.decode_words(rows, sizes)
    sym = rcx_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(sym, rcx_ops.decode_symbols_plain(words, lens, n,
                                                         stride, *args))
    assert torch.equal(sym, x)


def test_wide_lane_round_trip(dev):
    """One lane past 64 KiB of payload: u32 size table, oracle-identical."""
    data = np.random.default_rng(1).integers(0, 256, 140_000, np.uint8).tobytes()
    blob = ctt.compress(data, codec="rcx", device="cuda", lanes=2)
    assert blob[4] & 0x80
    assert blob == rcx_ref.rcx_encode(data, lanes=2)
    assert ctt.decompress(blob, codec="rcx", device="cuda") == data


def test_launch_counters_move(dev):
    before = (rcx_kernels.encode_launches, expand.launches,
              rcx_kernels.decode_launches)
    data = _textish(5000, 3).tobytes()
    assert ctt.decompress(ctt.compress(data, codec="rcx"), codec="rcx",
                          device="cuda") == data
    after = (rcx_kernels.encode_launches, expand.launches,
             rcx_kernels.decode_launches)
    assert all(a == b + 1 for a, b in zip(after, before))
    counters = [(rcq_kernels, "encode_launches"), (expand, "launches"),
                (rcq_kernels, "decode_launches"),
                (rans_kernels, "encode_launches"),
                (rans_kernels, "decode_launches")]
    before = [getattr(m, a) for m, a in counters]
    for codec in ("rcq", None):       # None: the default codec, rans
        blob = ctt.compress(data, device="cuda", **({"codec": codec}
                                                    if codec else {}))
        assert ctt.decompress(blob, codec=codec or "rans") == data
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
        == [1] * 5


@pytest.mark.parametrize("k", [32, 128, 2048])
def test_rcq_kernels_match_plain(dev, k):
    """Kernels D and E against kernel A's and C's step loops with one
    context, a requant every step and one halving."""
    n = 30 * k + 5
    x = torch.from_numpy(_textish(n, k + 1)).to(dev)
    _, inc, cl = rcq_params(n, lanes=k)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    ev = rcq_kernels.encode_events(x2d, lens, inc, 1 << cl)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, inc,
                                                       1 << cl, 0, 0, 1))
    rows, sizes = expand.materialize_rows(ev)
    words = layout.decode_words(rows, sizes)
    sym = rcq_kernels.decode_symbols(words, lens, n, stride, inc, 1 << cl)
    assert torch.equal(sym, rcx_ops.decode_symbols_plain(
        words, lens, n, stride, inc, 1 << cl, 0, 0, 1, interleaved=True))
    assert torch.equal(sym, x)


@pytest.mark.parametrize("k,single", [(1, False), (2, False), (64, True),
                                      (256, False), (8192, False)])
def test_rans_kernels_match_plain(dev, k, single):
    """Kernels F and G against their step loops; n is not a multiple of K,
    and one case is a single-symbol run."""
    n = 20 * k + 3
    data = np.full(n, 0x42, np.uint8) if single else _textish(n, k + 2)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    tables = rans_ops.tables(rans_ops.static_freqs(x), dev)
    ev, st = rans_kernels.encode_events(x2d, lens, *tables)
    pev, pst = rans_ops.encode_events_plain(x2d, lens, *tables)
    assert torch.equal(ev, pev) and torch.equal(st, pst)
    rows = rans_ops.word_rows(*rans_ops.lane_words(ev))
    sym = rans_kernels.decode_symbols(st, rows, lens, *tables, n, stride)
    assert torch.equal(sym, rans_ops.decode_symbols_plain(
        st, rows, lens, *tables, n, stride))
    assert torch.equal(sym, x)


@pytest.mark.parametrize("k,single", [(1, False), (2, False), (64, True),
                                      (256, False), (8192, False)])
def test_huffman_kernels_match_plain(dev, k, single):
    """Kernels H and I against their step loops; n is not a multiple of K,
    and one case is a single-symbol run (one code of length 1, all 0
    bits)."""
    n = 20 * k + 3
    data = np.full(n, 0x42, np.uint8) if single else _textish(n, k + 4)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    lengths, tab = huffman_ops.encoder_table(x)
    out = huffman_kernels.encode_events(x2d, lens, tab)
    plain = huffman_ops.encode_events_plain(x2d, lens, tab)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    words, counts = huffman_ops.lane_stream(out[0], out[1])
    rows = rans_ops.word_rows(words, counts)
    tables = huffman_ops.decoder_tables(lengths, dev)
    sym = huffman_kernels.decode_symbols(rows, lens, *tables, n, stride)
    assert torch.equal(sym, huffman_ops.decode_symbols_plain(
        rows, lens, *tables, n, stride))
    assert torch.equal(sym, x)


def test_huffman_decode_random_rows_match_plain(dev):
    """Random word rows against an incomplete code: windows no code matches
    decode as perm[0] and consume 16 bits in the kernel as in the plain
    version."""
    rng = np.random.default_rng(9)
    lengths = np.zeros(256, np.uint8)
    lengths[[5, 9, 200]] = [2, 3, 3]
    tables = huffman_ops.decoder_tables(lengths, dev)
    k, stride = 300, 50
    rows = torch.from_numpy(rng.integers(0, 1 << 16, (30, k),
                                         dtype=np.int32)).to(dev)
    lens = torch.from_numpy(rng.integers(0, stride + 1, k,
                                         dtype=np.int32)).to(dev)
    sym = huffman_kernels.decode_symbols(rows, lens, *tables, k * stride,
                                         stride)
    plain = huffman_ops.decode_symbols_plain(rows, lens, *tables, k * stride,
                                             stride)
    active = (torch.arange(stride, device=dev)[:, None] < lens[None, :])
    assert torch.equal(sym.view(stride, k)[active], plain.view(stride, k)[active])


@pytest.mark.parametrize("codec", ["rans", "rcq", "huffman"])
def test_corpus_file_matches_oracle(dev, codec):
    data = (Path(__file__).resolve().parent.parent / "data"
            / "fields.c").read_bytes()
    blob = ctt.compress(data, codec=codec, device="cuda")
    assert blob == ctt.compress(data, codec=codec, backend="ref")
    assert ctt.decompress(blob, codec=codec, device="cuda") == data


def test_rans_wide_count_table(dev):
    """One lane with more than 0xFFFF words: u32 count table (lane_desc
    bit 7), oracle-identical, decoded on the card."""
    data = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    blob = ctt.compress(data, device="cuda", lanes=1)
    assert blob[4] & 0x80
    assert blob == rans_ref.rans_encode(data, lanes=1)
    assert ctt.decompress(blob, device="cuda") == data
