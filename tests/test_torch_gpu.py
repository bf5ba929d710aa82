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
from cpprcoder_tpu_torch.core import bytesutil as ctt_bytes
from cpprcoder_tpu_torch.models.cxmodel import rcx_params
from cpprcoder_tpu_torch.models.qmodel import rcq_params
from cpprcoder_tpu_torch.models.static_table import normalize_freqs
from cpprcoder_tpu_torch.ops import (
    ans2_kernels,
    ans2_ops,
    ase_kernels,
    ase_ops,
    compaction,
    expand,
    huffman_kernels,
    huffman_ops,
    layout,
    lz_kernels,
    lz_ops,
    mtf_kernels,
    mtf_ops,
    o1_kernels,
    o1_ops,
    range_kernels,
    range_ops,
    rans_kernels,
    rans_ops,
    rcq_kernels,
    rcq_ops,
    rcx_kernels,
    rcx_ops,
)
from cpprcoder_tpu_torch.reference import (
    ans2_ref,
    ase_ref,
    bwt_ref,
    o1_ref,
    rans_ref,
    rcq_ref,
    rcx_ref,
    slz4_ref,
)

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


@pytest.mark.parametrize("wlog", [0, 2])
@pytest.mark.parametrize("cbits", [0, 6, 8])
@pytest.mark.parametrize("k", [32, 256, 1024, 4096, 8192])
def test_rcx_encode_matches_plain(dev, k, cbits, wlog):
    """Kernel A against its step loop: one block (K = 32, 256; cbits 8 with
    the model in global scratch) and the 4-block cluster from K = 1024 (1 to
    2 lanes a thread), at one context, 64 and 256, with a requant every
    step and every 4; then kernel C inverts it."""
    n = 24 * k + 5
    x = torch.from_numpy(_textish(n, 7 * k + cbits + wlog)).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_chunked(x, k, stride)
    lens = layout.lane_lengths(n, k, stride, dev)
    _, inc, cl, _ = rcx_params(n, lanes=k, cbits=cbits)
    args = (inc, 1 << cl, cbits, wlog)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, *args))
    words = layout.decode_words(*expand.materialize_rows(ev))
    assert torch.equal(rcx_kernels.decode_symbols(words, lens, n, stride,
                                                  *args), x)


# alice29.txt[:40000] at the largest lane counts K * inc <= 49,152 admits:
# the oracle's container bytes
WIDE_K_BYTES = {("rcq", 16384): 71038, ("rcq", 32768): 131317,
                ("rcx", 16384): 89162, ("rcx", 32768): 138314}


@pytest.mark.parametrize("codec,k", list(WIDE_K_BYTES))
def test_widest_lane_counts_match_the_oracle(dev, codec, k):
    """Kernels A and C (a 4-block cluster, 4 and 8 lanes a thread) and D
    and E (one block, 16 and 32 lanes a thread) at 16,384 and 32,768 lanes:
    the card writes the oracle's container and decodes it, and each kernel
    equals its plain version."""
    data = (Path(__file__).resolve().parent.parent / "data"
            / "alice29.txt").read_bytes()[:40000]
    ref = {"rcx": rcx_ref.rcx_encode, "rcq": rcq_ref.rcq_encode}[codec]
    want = ref(data, lanes=k)
    assert len(want) == WIDE_K_BYTES[codec, k]
    assert ctt.compress(data, codec=codec, device="cuda", lanes=k) == want
    assert ctt.decompress(want, codec=codec, device="cuda") == data
    n = len(data)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    stride = -(-n // k)
    if codec == "rcx":
        _, inc, cl, cbits = rcx_params(n, lanes=k)
        args = (inc, 1 << cl, cbits, 2)
        x2d = layout.pad2d_chunked(x, k, stride)
        lens = layout.lane_lengths(n, k, stride, dev)
        ev = rcx_kernels.encode_events(x2d, lens, *args)
        assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, *args))
        words = layout.decode_words(*expand.materialize_rows(ev))
        assert torch.equal(rcx_kernels.decode_symbols(words, lens, n, stride,
                                                      *args),
                           rcx_ops.decode_symbols_plain(words, lens, n,
                                                        stride, *args))
    else:
        _, inc, cl = rcq_params(n, lanes=k)
        x2d = layout.pad2d_interleaved(x, k, stride)
        lens = layout.lane_lengths_interleaved(n, k, stride, dev)
        ev = rcq_kernels.encode_events(x2d, lens, inc, 1 << cl)
        assert torch.equal(ev, rcx_ops.encode_events_plain(
            x2d, lens, inc, 1 << cl, 0, 0, 1))
        words = layout.decode_words(*expand.materialize_rows(ev))
        assert torch.equal(
            rcq_kernels.decode_symbols(words, lens, n, stride, inc, 1 << cl),
            rcx_ops.decode_symbols_plain(words, lens, n, stride, inc,
                                         1 << cl, 0, 0, 1, interleaved=True))


@pytest.mark.parametrize("climit_log2", [31, 32, 40, 64, 255])
@pytest.mark.parametrize("codec", ["rcx", "rcq"])
def test_large_climit_matches_the_oracle_on_the_card(dev, codec, climit_log2):
    """climit = 1 << climit_log2 reaches the kernels as a u32 (clamped to
    2^32 - 1 from 2^32 on, exact here): the card writes the oracle's
    container and decodes it."""
    data = (Path(__file__).resolve().parent.parent / "data"
            / "grammar.lsp").read_bytes()
    ref = {"rcx": rcx_ref.rcx_encode, "rcq": rcq_ref.rcq_encode}[codec]
    want = ref(data, climit_log2=climit_log2)
    assert ctt.compress(data, codec=codec, device="cuda",
                        climit_log2=climit_log2) == want
    assert ctt.decompress(want, codec=codec, device="cuda") == data


def _runs_and_text(n):
    """Alternate 4 KB blocks of kennedy.xls (runs, records) and
    alice29.txt (text)."""
    d = Path(__file__).resolve().parent.parent / "data"
    a, b = (d / "kennedy.xls").read_bytes(), (d / "alice29.txt").read_bytes()
    blocks = [(a if i % 2 == 0 else b)[i // 2 * 4096:(i // 2 + 1) * 4096]
              for i in range(-(-n // 4096))]
    return np.frombuffer(b"".join(blocks)[:n], np.uint8)


# (data, K, cbits, wlog, inc, climit) for kernels A and C; None: rcx_params
DECODE_CASES = {
    "one-byte run": (lambda: np.zeros(20_000, np.uint8), 64, 6, 2, None, None),
    "runs and text": (lambda: _runs_and_text(300_000), 2048, 4, 2, None, None),
    "K=32 cbits=8 global model": (lambda: _textish(5000, 5), 32, 8, 2, None,
                                  None),
    "K=100": (lambda: _textish(100 * 90 + 11, 6), 100, 6, 1, None, None),
    "K=1500": (lambda: _textish(1500 * 40, 7), 1500, 5, 2, None, None),
    "K=1024 cbits=0": (lambda: _textish(1024 * 30 + 5, 11), 1024, 0, 3, None,
                       None),
    "cluster one-byte run": (lambda: np.zeros(1024 * 60, np.uint8), 1024, 4,
                             2, None, None),
    "K=4096": (lambda: _textish(4096 * 30 + 3, 8), 4096, 4, 2, None, None),
    "K=8192 cbits=7": (lambda: _textish(8192 * 20 + 9, 9), 8192, 7, 2, None,
                       None),
    "halves every window": (lambda: _textish(256 * 200, 10), 256, 6, 3, 255,
                            1 << 10),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_rcx_decode_hard_cases_match_plain(dev, case):
    """Kernel C (and A) against their step loops where the decode design
    has its edges: every lane on one cell, runs, the model in global
    scratch, partial warps, the 4-block cluster (K >= 1024) with one row or
    with blocks of K / 4 lanes not a multiple of 32, 2 to 8 lanes a thread,
    rows left at or above climit by their requant, and a cluster row whose
    halvings bring it back to the total it had at the window before."""
    make, k, cbits, wlog, inc, climit = DECODE_CASES[case]
    data = make()
    n = len(data)
    _, inc0, cl, _ = rcx_params(n, lanes=k, cbits=cbits)
    args = (inc0 if inc is None else inc,
            1 << cl if climit is None else climit, cbits, wlog)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_chunked(x, k, stride)
    lens = layout.lane_lengths(n, k, stride, dev)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, *args))
    words = layout.decode_words(*expand.materialize_rows(ev))
    sym = rcx_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(sym, rcx_ops.decode_symbols_plain(words, lens, n,
                                                         stride, *args))
    assert torch.equal(sym, x)


@pytest.mark.parametrize("case", ["one-byte run", "runs and text", "K=100",
                                  "K=4096", "K=8192", "halves every step"])
def test_rcq_decode_hard_cases_match_plain(dev, case):
    """Kernel E (and D) against their step loops on the same edges."""
    data, k, inc, cl = {
        "one-byte run": (np.full(20_000, 7, np.uint8), 64, None, None),
        "runs and text": (_runs_and_text(300_000), 2048, None, None),
        "K=100": (_textish(100 * 60 + 7, 11), 100, None, None),
        "K=4096": (_textish(4096 * 25 + 1, 12), 4096, None, None),
        "K=8192": (_textish(8192 * 12 + 3, 13), 8192, None, None),
        "halves every step": (_textish(4096, 14), 128, 24, 10),
    }[case]
    n = len(data)
    _, inc0, cl0 = rcq_params(n, lanes=k)
    inc = inc0 if inc is None else inc
    climit = 1 << (cl0 if cl is None else cl)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    ev = rcq_kernels.encode_events(x2d, lens, inc, climit)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, inc,
                                                       climit, 0, 0, 1))
    words = layout.decode_words(*expand.materialize_rows(ev))
    sym = rcq_kernels.decode_symbols(words, lens, n, stride, inc, climit)
    assert torch.equal(sym, rcx_ops.decode_symbols_plain(
        words, lens, n, stride, inc, climit, 0, 0, 1, interleaved=True))
    assert torch.equal(sym, x)


def test_wide_lane_round_trip(dev):
    """One lane past 64 KiB of payload: u32 size table, oracle-identical."""
    data = np.random.default_rng(1).integers(0, 256, 140_000, np.uint8).tobytes()
    blob = ctt.compress(data, codec="rcx", device="cuda", lanes=2)
    assert blob[4] & 0x80
    assert blob == rcx_ref.rcx_encode(data, lanes=2)
    assert ctt.decompress(blob, codec="rcx", device="cuda") == data


@pytest.mark.parametrize("codec", ["rcx", "rcq"])
def test_one_lane_past_2_mib_decodes(dev, codec):
    """The oracle's container of one lane of 2 MiB + 4099 bytes decodes on
    the card: below 4 lanes a thread the decode kernels keep a lane's length
    and word index at full width. (The port's encoder refuses a lane this
    long: a pending run of 0xFF bytes must fit its events' 22-bit field.)"""
    d = Path(__file__).resolve().parent.parent / "data"
    src = (d / "kennedy.xls").read_bytes() + (d / "alice29.txt").read_bytes()
    n = (2 << 20) + 4099
    data = (src * -(-n // len(src)))[:n]
    ref = {"rcx": rcx_ref.rcx_encode, "rcq": rcq_ref.rcq_encode}[codec]
    blob = ref(data, lanes=1)
    assert ctt.decompress(blob, codec=codec, device="cuda") == data


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


@pytest.mark.parametrize("k,run", [(32, False), (128, False), (2048, False),
                                   (100, False), (8192, False), (64, True)])
def test_rcq_kernels_match_plain(dev, k, run):
    """Kernels D and E against kernel A's and C's step loops with one
    context, a requant every step and one halving: K from one warp to 8
    lanes a thread (100 not a multiple of 32), and a one-byte run (every
    lane's update on one cell)."""
    n = 30 * k + 5
    data = np.full(n, 0x61, np.uint8) if run else _textish(n, k + 1)
    x = torch.from_numpy(data).to(dev)
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


@pytest.mark.parametrize("k,n", [(4, 60_003), (1, 70_001)])
def test_rans_encode_edges_match_plain(dev, k, n):
    """Kernel F against its step loop where its quotient has its edges: a
    table with a symbol of frequency 1 beside one of 2^14 - 1 (one rare
    byte in a run), and one lane over a long chain (K = 1, n not a
    multiple of the steps loaded ahead)."""
    if k == 1:
        data = _textish(n, 21)
    else:
        data = np.full(n, 0x30, np.uint8)
        data[n // 3] = 0x31
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    tables = rans_ops.tables(rans_ops.static_freqs(x), dev)
    if k != 1:
        assert sorted(tables[0][tables[0] > 0].tolist()) == [1, (1 << 14) - 1]
    ev, st = rans_kernels.encode_events(x2d, lens, *tables)
    pev, pst = rans_ops.encode_events_plain(x2d, lens, *tables)
    assert torch.equal(ev, pev) and torch.equal(st, pst)


@pytest.mark.parametrize("k,single", [(1, False), (2, False), (64, True),
                                      (256, False), (8192, False)])
def test_huffman_kernels_match_plain(dev, k, single):
    """Kernels H and I against their plain versions; n is not a multiple of
    K, and one case is a single-symbol run (one code of length 1, all 0
    bits)."""
    n = 20 * k + 3
    data = np.full(n, 0x42, np.uint8) if single else _textish(n, k + 4)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    lengths, tab = huffman_ops.encoder_table(x)
    payload, counts, bits = huffman_kernels.encode_stream(x2d, lens, tab)
    plain = huffman_ops.encode_stream_plain(x2d, lens, tab)
    assert all(torch.equal(a, b) for a, b in zip((payload, counts, bits), plain))
    rows = rans_ops.word_rows(huffman_ops.stream_words(payload, counts), counts)
    tables = huffman_ops.decoder_tables(lengths, dev)
    sym = huffman_kernels.decode_symbols(rows, lens, *tables, n, stride)
    assert torch.equal(sym, huffman_ops.decode_symbols_plain(
        rows, lens, *tables, n, stride))
    assert torch.equal(sym, x)


def _long_codes(n, seed):
    """Bytes whose canonical code reaches 15 bits (test_huffman_pallas.py's
    skewed case)."""
    rng = np.random.default_rng(seed)
    probs = np.array([2.0 ** -min(i // 16 + 1, 14) for i in range(256)])
    return rng.choice(256, n, p=probs / probs.sum()).astype(np.uint8)


def _huffman_edge(case):
    """(data, K, table or None, lane lengths or None) of kernel H's edge
    cases."""
    c = huffman_kernels.CHUNK
    if case == "15-bit codes":
        return _long_codes(20_000, 3), 64, None, None
    if case == "all codes 15 bits":
        tab = np.zeros((2, 256), np.int32)
        tab[0] = 15
        tab[1] = np.arange(256) * 97 % (1 << 15)
        return _textish(64 * 51 + 7, 4), 64, tab, None
    if case == "K=65536":
        return _textish(65536 * 3 + 5, 5), 65536, None, None
    if case == "lanes of length 0":
        return _textish(3, 6), 4, None, None
    if case == "lanes of length 0, K=4096":
        return _textish(4096 - 100, 7), 4096, None, None
    if case.startswith("stride "):
        stride = c + int(case.removeprefix("stride C"))
        return _textish(16 * stride - 3, 8 + stride), 16, None, None
    if case == "odd lane offsets":
        # one-symbol lanes of a 2-code table: every lane 40 bits in 3 u16
        # words, so lane i starts at word 3 * i, mid-u32 for odd i
        return np.resize(np.array([0x61, 0x62], np.uint8), 128 * 40), 128, None, None
    if case == "ragged lane lengths":
        return _textish(256 * 70, 9), 256, None, "random"
    raise KeyError(case)


HUFFMAN_EDGES = ["15-bit codes", "all codes 15 bits", "K=65536",
                 "lanes of length 0", "lanes of length 0, K=4096",
                 "stride C-1", "stride C+0", "stride C+1", "odd lane offsets",
                 "ragged lane lengths"]


@pytest.mark.parametrize("case", HUFFMAN_EDGES)
def test_huffman_encode_edges_match_plain(dev, case):
    """Kernel H against its plain version where its chunks and words have
    their edges: codes of 15 bits (and a table of nothing else), K = 65,536,
    lanes of length 0, strides of CHUNK - 1, CHUNK and CHUNK + 1, lanes
    whose words start mid-u32, and lane lengths drawn at random."""
    data, k, tab, lens = _huffman_edge(case)
    n = len(data)
    stride = -(-n // k)
    x = torch.from_numpy(data).to(dev)
    x2d = layout.pad2d_interleaved(x, k, stride)
    if lens == "random":
        lens = torch.from_numpy(np.random.default_rng(10).integers(
            0, stride + 1, k, dtype=np.int32)).to(dev)
    else:
        lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    if tab is None:
        _, tab = huffman_ops.encoder_table(x)
    else:
        tab = torch.from_numpy(tab).to(dev)
    out = huffman_kernels.encode_stream(x2d, lens, tab)
    plain = huffman_ops.encode_stream_plain(x2d, lens, tab)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    if case == "odd lane offsets":
        assert (out[1] == 3).all() and (out[2] == 40).all()


def test_huffman_one_lane_matches_the_oracle(dev):
    """200,000 random bytes in one lane (about 12,500 chunks of one lane,
    held to the oracle: the plain step loop over 200,000 steps is too
    slow), and the round trip."""
    data = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    blob = ctt.compress(data, codec="huffman", device="cuda", lanes=1)
    assert blob == ctt.compress(data, codec="huffman", backend="ref", lanes=1)
    assert ctt.decompress(blob, codec="huffman", device="cuda") == data


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


@pytest.mark.parametrize("complete", [True, False])
def test_huffman_decode_word_counts_match_plain(dev, complete):
    """Kernel I's words in flight at a lane's edges: lanes of 0, 1 and l2
    words (zero past each count) and lane lengths past their bits, K = 300
    (not a multiple of 32), under a complete code from text and under an
    incomplete one whose unmatched windows decode as perm[0] and consume 16
    bits; only the active steps are compared."""
    rng = np.random.default_rng(11 + complete)
    if complete:
        lengths, _ = huffman_ops.encoder_table(
            torch.from_numpy(_textish(5000, 12)))
    else:
        lengths = np.zeros(256, np.uint8)
        lengths[[5, 9, 200]] = [2, 3, 3]
    tables = huffman_ops.decoder_tables(lengths, dev)
    k, stride, l2 = 300, 60, 24
    words = rng.integers(0, 1 << 16, (l2, k), dtype=np.int32)
    counts = rng.choice([0, 1, l2], k)
    words[np.arange(l2)[:, None] >= counts[None, :]] = 0
    rows = torch.from_numpy(words).to(dev)
    lens = torch.from_numpy(rng.integers(0, stride + 1, k,
                                         dtype=np.int32)).to(dev)
    sym = huffman_kernels.decode_symbols(rows, lens, *tables, k * stride,
                                         stride)
    plain = huffman_ops.decode_symbols_plain(rows, lens, *tables, k * stride,
                                             stride)
    active = (torch.arange(stride, device=dev)[:, None] < lens[None, :])
    assert torch.equal(sym.view(stride, k)[active],
                       plain.view(stride, k)[active])


@pytest.mark.parametrize("codec", ["rans", "rcq", "huffman"])
def test_corpus_file_matches_oracle(dev, codec):
    data = (Path(__file__).resolve().parent.parent / "data"
            / "fields.c").read_bytes()
    blob = ctt.compress(data, codec=codec, device="cuda")
    assert blob == ctt.compress(data, codec=codec, backend="ref")
    assert ctt.decompress(blob, codec=codec, device="cuda") == data


def _events(e, k, seed, run_max=3):
    """Random packed u32 events [e, k] (half of them emit) as uint32."""
    rng = np.random.default_rng(seed)
    first = rng.integers(0, 512, (e, k), dtype=np.uint32)   # byte and carry
    run = rng.integers(0, run_max + 1, (e, k), dtype=np.uint32)
    ev = (np.uint32(1) << 31) | (first << 22) | run
    return np.where(rng.random((e, k)) < 0.5, ev, 0).astype(np.uint32)


def _expand_edge(case):
    """(events uint32 [E, K], may_drop, l2 or None) for kernel B's edges."""
    if case == "one run of 2^22 - 1 bytes":
        ev = np.zeros((3, 1), np.uint32)
        ev[1, 0] = (1 << 31) | (0x5A << 23) | ((1 << 22) - 1)
        return ev, True, None
    if case == "long runs at tile boundaries":
        ev = _events(96, 40, 30)
        rng = np.random.default_rng(31)
        for e in (31, 32, 63, 64):
            ev[e] = (1 << 31) | (rng.integers(0, 512, 40, dtype=np.uint32) << 22) \
                | rng.integers(0, 200, 40, dtype=np.uint32)
        return ev, True, None
    if case == "first emits in later tiles, masked":
        ev = _events(150, 64, 32)
        for i in range(64):
            ev[:32 * (i % 4) + i % 7, i] = 0
        md = np.zeros(64, bool)
        md[::2] = True
        return ev, md, None
    if case == "K=100":
        return _events(300, 100, 33, run_max=40), True, None
    if case == "K=32768":
        return _events(40, 32768, 34), True, None
    ev = _events(70, 50, 35, run_max=9)     # a given l2 above the largest lane
    _, sizes = compaction.materialize_rows_t(torch.from_numpy(ev.view(np.int32)))
    return ev, False, int(sizes.max()) + 37


@pytest.mark.parametrize("case", [
    "one run of 2^22 - 1 bytes", "long runs at tile boundaries",
    "first emits in later tiles, masked", "K=100", "K=32768", "given l2"])
def test_expand_edges_match_plain(dev, case):
    """Kernel B against its plain version where its write pass has its
    edges: the warp's long-run path (a run of the field's largest length;
    runs of up to 200 bytes at both sides of the 32-step scans and 64-step
    tiles), the dummy dropped in a later tile under a mask, partial and many
    blocks of 16 lanes, and a given row width."""
    ev, may_drop, l2 = _expand_edge(case)
    t = torch.from_numpy(ev.view(np.int32)).to(dev)
    md = may_drop if isinstance(may_drop, bool) else torch.from_numpy(may_drop).to(dev)
    rows, sizes = expand.materialize_rows(t, l2, md)
    assert l2 is None or rows.shape[1] == l2
    prow, psizes = compaction.materialize_rows_t(t, rows.shape[1], md)
    assert torch.equal(sizes, psizes) and torch.equal(rows, prow)


@pytest.mark.parametrize("case", ["one lane past 65,535 words",
                                  "one symbol at K=48", "f = 2^14"])
def test_rans_decode_hard_cases_match_plain(dev, case):
    """Kernel G against its plain version: one lane of 200,000 random bytes
    (more than 65,535 words through its words in flight; the plain loop
    runs on the host), the single-symbol lane (f = 16,383 beside 1) at K not
    a multiple of 32, and a hand-made table where one symbol owns all 2^14
    slots (f needs the entry's 15 bits) over random states and rows."""
    if case == "f = 2^14":
        rng = np.random.default_rng(36)
        freqs = np.zeros(256, np.int64)
        freqs[0x77] = 1 << 14
        tables = rans_ops.tables(freqs, dev)
        k, stride = 100, 60
        st = torch.from_numpy(rng.integers(1 << 16, 1 << 32, k, dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev)
        rows = torch.from_numpy(rng.integers(0, 1 << 16, (8, k),
                                             dtype=np.int32)).to(dev)
        lens = torch.full((k,), stride, dtype=torch.int32, device=dev)
        sym = rans_kernels.decode_symbols(st, rows, lens, *tables, k * stride,
                                          stride)
        assert torch.equal(sym, rans_ops.decode_symbols_plain(
            st, rows, lens, *tables, k * stride, stride))
        assert bool((sym == 0x77).all())
        return
    if case == "one symbol at K=48":
        k, data = 48, np.full(48 * 40 + 7, 0x42, np.uint8)
    else:
        k, data = 1, np.random.default_rng(7).integers(0, 256, 200_000, np.uint8)
    n = len(data)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    tables = rans_ops.tables(rans_ops.static_freqs(x), dev)
    ev, st = rans_kernels.encode_events(x2d, lens, *tables)
    rows = rans_ops.word_rows(*rans_ops.lane_words(ev))
    if k == 1:
        assert rows.shape[0] > 0x10000
    sym = rans_kernels.decode_symbols(st, rows, lens, *tables, n, stride)
    assert torch.equal(sym.cpu(), rans_ops.decode_symbols_plain(
        st.cpu(), rows.cpu(), lens.cpu(), *(t.cpu() for t in tables), n,
        stride))
    assert torch.equal(sym, x)


def test_rans_wide_count_table(dev):
    """One lane with more than 0xFFFF words: u32 count table (lane_desc
    bit 7), oracle-identical, decoded on the card."""
    data = np.random.default_rng(7).integers(0, 256, 200_000,
                                             np.uint8).tobytes()
    blob = ctt.compress(data, device="cuda", lanes=1)
    assert blob[4] & 0x80
    assert blob == rans_ref.rans_encode(data, lanes=1)
    assert ctt.decompress(blob, device="cuda") == data


# ------------------------------------------ kernels J, L (CT-RC1/CT-RC2)

def _zipf(n, seed):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(1.3, n) - 1, 255).astype(np.uint8)


@pytest.mark.parametrize("k,static,limit_log2,data", [
    (1, False, 16, "text"), (8, False, 18, "text"), (256, False, 16, "text"),
    (1024, False, 17, "zipf"), (8192, False, 18, "text"),
    (64, False, 16, "run"), (100, False, 16, "text"),
    (1, True, 16, "text"), (2048, True, 16, "zipf"), (64, True, 16, "run")])
def test_range_kernels_match_plain(dev, k, static, limit_log2, data):
    """Kernels J and L against their plain step loops: one lane to 8 lanes
    a thread, three slots a step (limit_log2 > 16; Zipf bytes take the
    third slot at K = 1,024), a one-byte run (every lane's update on one
    count), n not a multiple of K, CT-RC1's static table. K = 100 is not a
    power of two: the card refuses it."""
    n = (400 if k < 64 else 30) * k + 7
    x_np = {"text": lambda: _textish(n, k), "zipf": lambda: _zipf(n, k),
            "run": lambda: np.full(n, 0x61, np.uint8)}[data]()
    x = torch.from_numpy(x_np).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    freqs = torch.from_numpy(normalize_freqs(np.bincount(
        x_np, minlength=256), 16).astype(np.int32)).to(dev) if static else None
    args = (freqs, 24 if k < 8192 else 12, limit_log2)
    if k & (k - 1):
        with pytest.raises(ValueError, match="power of two"):
            range_kernels.encode_events(x2d, lens, *args)
        return
    ev = range_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, range_ops.encode_events_plain(x2d, lens, *args))
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = range_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(out, range_ops.decode_symbols_plain(
        words, lens, n, stride, *args))
    assert torch.equal(out, x)


@pytest.mark.parametrize("codec", ["static_range", "adaptive_range"])
def test_range_codecs_at_three_slots_match_the_oracle(dev, codec):
    """K = 1,024 (2 MiB and more pick it; limit_log2 17, three slots) and a
    one-lane stream, against the numpy oracle."""
    data = _zipf(1024 * 40 + 9, 3).tobytes()
    for lanes in (1024, 1):
        blob = ctt.compress(data[:20_000] if lanes == 1 else data,
                            codec=codec, device="cuda", lanes=lanes)
        want = ctt.compress(data[:20_000] if lanes == 1 else data,
                            codec=codec, backend="ref", lanes=lanes)
        assert blob == want
        assert ctt.decompress(blob, codec=codec, device="cuda") \
            == (data[:20_000] if lanes == 1 else data)


@pytest.mark.parametrize("name,lanes,cut", [
    ("grammar.lsp", 512, None), ("grammar.lsp", 1024, None),
    ("alice29.txt", 1024, 30000)])
def test_range_totals_past_2_16_match_plain_and_the_oracle(dev, name, lanes, cut):
    """CT-RC2 at inc 255 and limit_log2 16, where the total passes 2^16
    and a step takes three slots: J and L equal their plain versions, the
    container the oracle's, and L decodes the oracle's container."""
    data = (Path(__file__).resolve().parent.parent / "data" / name
            ).read_bytes()[:cut]
    x_np = np.frombuffer(data, np.uint8)
    n, k = len(data), lanes
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(torch.from_numpy(x_np.copy()).to(dev), k,
                                   stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    args = (None, 255, 16)
    ev = range_kernels.encode_events(x2d, lens, *args)
    assert ev.shape[0] == 3 * stride + 2
    assert torch.equal(ev, range_ops.encode_events_plain(x2d, lens, *args))
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = range_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(out, range_ops.decode_symbols_plain(
        words, lens, n, stride, *args))
    opts = dict(lanes=lanes, inc=255, limit_log2=16)
    want = ctt.compress(data, codec="adaptive_range", backend="ref", **opts)
    assert ctt.compress(data, codec="adaptive_range", device="cuda",
                        **opts) == want
    assert ctt.decompress(want, codec="adaptive_range", device="cuda") == data


RANGE_WIDE_BYTES = {("static_range", 16384): 50193,
                    ("static_range", 32768): 99345,
                    ("static_range", 65536): 197649,
                    ("adaptive_range", 16384): 60309,
                    ("adaptive_range", 32768): 109461,
                    ("adaptive_range", 65536): 207765}


@pytest.mark.parametrize("codec,lanes", list(RANGE_WIDE_BYTES))
def test_range_widest_lanes_match_the_oracle(dev, codec, lanes):
    """fields.c at 16,384 to 65,536 lanes (L's CT-RC2 a cluster of 4 to 8
    CTAs): the oracle's sizes and bytes, and a round trip on the card."""
    data = (Path(__file__).resolve().parent.parent / "data" / "fields.c"
            ).read_bytes()
    blob = ctt.compress(data, codec=codec, device="cuda", lanes=lanes)
    assert len(blob) == RANGE_WIDE_BYTES[codec, lanes]
    assert blob == ctt.compress(data, codec=codec, backend="ref", lanes=lanes)
    assert ctt.decompress(blob, codec=codec, device="cuda") == data


@pytest.mark.parametrize("k,static,data", [
    (65536, False, "run"), (65536, True, "run"), (16384, False, "text"),
    (512, False, "zipf"), (256, False, "ragged"), (128, True, "text"),
    (256, True, "ragged"), (32, False, "ragged")])
def test_range_kernels_at_edges_match_plain(dev, k, static, data):
    """J and L at their geometry's edges: a one-byte run over 65,536 lanes
    (every lane's update on one count; L's CT-RC2 a cluster of 8), 16,384
    lanes (a cluster of 4), J's CT-RC2 over 8 CTAs of 64 lanes, CT-RC1
    over two CTAs (J: 64 lanes a CTA; L: 128), and lanes of unequal length
    (each 0 to stride steps), against the plain step loops."""
    stride = 3 if k >= 16384 else 50
    n = k * stride - 1
    rng = np.random.default_rng(k)
    x_np = {"run": lambda: np.full(n, 0x61, np.uint8),
            "text": lambda: _textish(n, k), "zipf": lambda: _zipf(n, k),
            "ragged": lambda: _zipf(n, k)}[data]()
    x2d = layout.pad2d_interleaved(torch.from_numpy(x_np).to(dev), k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    if data == "ragged":
        lens = torch.from_numpy(rng.integers(0, stride + 1, k).astype(
            np.int32)).to(dev)
    freqs = torch.from_numpy(normalize_freqs(np.bincount(
        x_np, minlength=256), 16).astype(np.int32)).to(dev) if static else None
    inc, limit_log2 = (0, 16) if static else (24, 16 if k <= 512 else 21)
    args = (freqs, inc, limit_log2)
    ev = range_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, range_ops.encode_events_plain(x2d, lens, *args))
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = range_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(out, range_ops.decode_symbols_plain(
        words, lens, n, stride, *args))
    if data != "ragged":
        assert torch.equal(out, torch.from_numpy(x_np).to(dev))


# ------------------------------------------------ kernels M, N (CT-MTF1)

@pytest.mark.parametrize("n", [1, 100, 32768, 32768 + 129, 3 * 32768 + 5])
@pytest.mark.parametrize("mtf1", [False, True])
def test_mtf_kernels_match_plain(dev, n, mtf1):
    """Kernels M and N against their plain loop: a block cut inside a
    128-byte chunk, whole blocks, blocks after the first."""
    x = torch.from_numpy(_textish(n, n)).to(dev)
    blocks = mtf_ops.pad_blocks(x)
    ranks = mtf_kernels.encode_ranks(blocks, n, mtf1)
    assert torch.equal(ranks, mtf_ops.transform_plain(blocks, n, mtf1, False))
    rblocks = mtf_ops.pad_blocks(ranks)
    out = mtf_kernels.decode_bytes(rblocks, n, mtf1)
    assert torch.equal(out, mtf_ops.transform_plain(rblocks, n, mtf1, True))
    assert torch.equal(out, x)


def _bwt_of_text(n):
    x = _textish(n, 13)
    return np.concatenate([bwt_ref.bwt_forward_block(x[i:i + 32768])[0]
                           for i in range(0, n, 32768)])


# the segments of a full block are 256 bytes (of a block of v bytes,
# ceil(v / 128) rounded up to a multiple of 4): under MTF-1 "aabb" then
# "ab"... puts a swap (rank 1 after a nonzero rank) on every segment's first
# byte, "aab" then "ab"... a rank 1 after a rank 0 (no move)
MTF_EDGES = {
    "bwt": _bwt_of_text,
    "one byte": lambda n: np.full(n, 7, np.uint8),
    "swaps at segment starts": lambda n: np.frombuffer(
        (b"aabb" + b"ab" * n)[:n], np.uint8),
    "rank 1 after rank 0 at segment starts": lambda n: np.frombuffer(
        (b"aab" + b"ab" * n)[:n], np.uint8),
    "all 256 values": lambda n: np.random.default_rng(14).integers(
        0, 256, n, np.uint8),
}


@pytest.mark.parametrize("case,n", [(c, 32768 + 1) for c in MTF_EDGES]
                         + [("bwt", n) for n in (1, 1023, 1025, 32768)])
@pytest.mark.parametrize("mtf1", [False, True])
def test_mtf_kernels_at_segment_edges(dev, case, n, mtf1):
    """Kernels M and N (each block's segments side by side, each from its
    computed start list) against their plain loop where a segment starts
    on a swap, on a rank 1 that does not move, in runs, on all 256 values,
    and at lengths of one byte, a short block's segments, a block and a
    block and one byte."""
    x = torch.from_numpy(np.array(MTF_EDGES[case](n))).to(dev)
    blocks = mtf_ops.pad_blocks(x)
    ranks = mtf_kernels.encode_ranks(blocks, n, mtf1)
    assert torch.equal(ranks, mtf_ops.transform_plain(blocks, n, mtf1, False))
    rblocks = mtf_ops.pad_blocks(ranks)
    out = mtf_kernels.decode_bytes(rblocks, n, mtf1)
    assert torch.equal(out, mtf_ops.transform_plain(rblocks, n, mtf1, True))
    assert torch.equal(out, x)


# ------------------------------------------------ the seven codecs

NEW_CODEC_CASES = {
    "static_range": {}, "adaptive_range": {}, "blocksort": {},
    "mtf": {}, "mtf1": {}, "rle0": {}, "pipeline": {},
    "blocksort tied rotations": {"block_log2": 12},
    "pipeline named stages": {"stages": [("blocksort", {"block_log2": 12}),
                                         "mtf", "rle0",
                                         ("static_range", {"lanes": 8})]},
}


@pytest.mark.parametrize("case", list(NEW_CODEC_CASES))
def test_new_codecs_match_the_oracle_on_the_card(dev, case):
    root = Path(__file__).resolve().parent.parent / "data"
    data = (root / "fields.c").read_bytes()
    if "tied" in case:
        data = b"abcd" * 1024 + b"\x00" * 4096 + data
    codec = case.split()[0]
    opts = NEW_CODEC_CASES[case]
    blob = ctt.compress(data, codec=codec, device="cuda", **opts)
    assert blob == ctt.compress(data, codec=codec, backend="ref", **opts)
    assert ctt.decompress(blob, codec=codec, device="cuda") == data


def test_new_launch_counters_move(dev):
    counters = [(range_kernels, "encode_launches"), (expand, "launches"),
                (range_kernels, "decode_launches"),
                (mtf_kernels, "encode_launches"),
                (mtf_kernels, "decode_launches")]
    before = [getattr(m, a) for m, a in counters]
    data = _textish(5000, 4).tobytes()
    blob = ctt.compress(data, codec="pipeline")
    assert ctt.decompress(blob, codec="pipeline") == data
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
        == [1] * 5


# ------------------------------------- kernel O, CT-SB and the resumable encoder

def _chunk_start(k, pending, seed, dev):
    """(state [5, K] int32, C [256] int32): the fresh encoder's, or a saved
    state whose lanes hold pending runs (low at 0xFF......, cache_size up to
    4,000, carry on some lanes) and a model with a history."""
    if pending:
        rng = np.random.default_rng(seed)
        u32 = lambda lo, hi: rng.integers(lo, hi, k, dtype=np.uint64)  # noqa: E731
        st = np.stack([u32(0xFF000000, 1 << 32), u32(0, 2),
                       u32(1 << 24, 1 << 32), u32(0, 256), u32(1, 4000)])
        C = rng.integers(1, 60, 256)
    else:
        st = np.stack([np.full(k, v) for v in (0, 0, 0xFFFFFFFF, 0, 1)])
        C = np.ones(256)
    to = lambda a: torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(dev)  # noqa: E731
    return to(st), to(C)


# (K, chunk steps, input, pending runs at the start): chunks of 1, 63, 64
# and 65 steps; K = 1, 8 lanes a thread (8,192) and 32,768 (32 a thread);
# zeros, whose lanes first emit chunks later; 0xFF-heavy input after a
# state with pending runs; n not a multiple of a chunk
CHUNK_CASES = [(1, 1, "text", False), (64, 63, "text", False),
               (256, 64, "zeros", False), (100, 65, "text", True),
               (8192, 64, "ff", True), (32768, 1, "text", False),
               (2048, 64, "ff", True)]


@pytest.mark.parametrize("case", CHUNK_CASES)
def test_rcq_encode_chunk_matches_plain(dev, case):
    """Kernel O against its plain version chunk after chunk (3 chunks, the
    last partly active), then a flush-only launch: events, state and C
    exactly equal."""
    k, steps, kind, pending = case
    n = 3 * steps * k - k // 2 - 1 if k > 1 else 3 * steps
    data = {"text": _textish(n, k), "zeros": np.zeros(n, np.uint8),
            "ff": np.where(np.arange(n) % 7 < 5, 0xFF, _textish(n, k + 5))
            .astype(np.uint8)}[kind]
    _, inc, cl = rcq_params(n, lanes=k)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(torch.from_numpy(data).to(dev), k,
                                   3 * steps)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    st, C = _chunk_start(k, pending, k, dev)
    pst, pC = st, C
    for t0 in range(0, 3 * steps, steps):
        rows = x2d[t0:t0 + steps].contiguous()
        ev, st, C = rcq_kernels.encode_chunk(rows, lens, t0, st, C, inc,
                                             1 << cl)
        pev, pst, pC = rcq_ops.encode_chunk_plain(rows, lens, t0, pst, pC,
                                                  inc, 1 << cl, False)
        assert torch.equal(ev, pev) and torch.equal(st, pst) \
            and torch.equal(C, pC)
    empty = x2d[:0]
    outs = rcq_kernels.encode_chunk(empty, lens, 3 * steps, st, C, inc,
                                    1 << cl, flush=True)
    pouts = rcq_ops.encode_chunk_plain(empty, lens, 3 * steps, pst, pC, inc,
                                       1 << cl, True)
    assert outs[0].shape == (2, k)
    assert all(torch.equal(a, b) for a, b in zip(outs, pouts))


def test_encode_chunk_equals_kernel_d(dev):
    """Kernel O run from the fresh state over the whole stream, with the
    flush, writes kernel D's events."""
    n, k = 20_000 + 37, 64
    _, inc, cl = rcq_params(n, lanes=k)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(torch.from_numpy(_textish(n, 9)).to(dev),
                                   k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    st, C = _chunk_start(k, False, 0, dev)
    ev, _, _ = rcq_kernels.encode_chunk(x2d, lens, 0, st, C, inc, 1 << cl,
                                        flush=True)
    assert torch.equal(ev, rcq_kernels.encode_events(x2d, lens, inc, 1 << cl))


@pytest.mark.parametrize("name,chunk_steps", [("fields.c", 64),
                                              ("kennedy.xls", 64),
                                              ("grammar.lsp", 7)])
def test_resumable_container_matches_one_shot_and_the_oracle(dev, name,
                                                             chunk_steps):
    """RCQResumableEncoder on the card, checkpointed mid-way through
    pickle and resumed: one-shot rcq's container and the oracle's, and it
    decodes back; kernel O launched once a chunk."""
    import pickle

    from cpprcoder_tpu_torch.codecs.resume import RCQResumableEncoder

    data = (Path(__file__).resolve().parent.parent / "data" / name).read_bytes()
    before = rcq_kernels.chunk_launches
    enc = RCQResumableEncoder(len(data), chunk_steps=chunk_steps)
    half = len(data) // 2 + 17
    enc.feed(data[:half])
    enc = RCQResumableEncoder.resume(pickle.loads(pickle.dumps(
        enc.checkpoint())))
    enc.feed(data[half:])
    blob = enc.finish()
    assert blob == ctt.compress(data, codec="rcq", device="cuda")
    assert blob == rcq_ref.rcq_encode(data)
    assert ctt.decompress(blob, codec="rcq", device="cuda") == data
    k = rcq_params(len(data))[0]
    chunks = len(data) // (chunk_steps * k) + 1
    assert rcq_kernels.chunk_launches - before == chunks


@pytest.mark.parametrize("codec", ["rcx", "rans", "rcq", "huffman"])
def test_stream_matches_the_oracle_on_the_card(dev, codec):
    """CT-SB over 2^16-byte superblocks of kennedy.xls (16 superblocks, the
    last short) on the card: the oracle codec's container, a round trip,
    and a range across a superblock edge; SuperblockEncoder fed in pieces
    gives the same bytes."""
    from cpprcoder_tpu_torch.codecs import stream

    data = (Path(__file__).resolve().parent.parent / "data"
            / "kennedy.xls").read_bytes()
    blob = stream.stream_encode(data, codec=codec, sb_log2=16)
    assert blob == stream.stream_encode(data, codec=codec, sb_log2=16,
                                        backend="ref")
    assert stream.stream_decode(blob) == data
    assert stream.stream_decode_range(blob, 65_000, 140_000) \
        == data[65_000:140_000]
    enc = stream.SuperblockEncoder(codec, sb_log2=16)
    for i in range(0, len(data), 100_003):
        enc.feed(data[i:i + 100_003])
    assert enc.finish() == blob


def _corpus(name):
    return (Path(__file__).resolve().parent.parent / "data" / name).read_bytes()


def _lz_input(name):
    rng = np.random.default_rng(61)
    text = _corpus("fields.c")
    concat = b"".join(_corpus(nm) for nm in sorted(SLZ4_BYTES))
    return {"grammar.lsp": _corpus("grammar.lsp"),
            "kennedy.xls": _corpus("kennedy.xls"), "fields.c": text,
            "zeros": bytes(70_000),
            "random": rng.integers(0, 256, 200_000, np.uint8).tobytes(),
            "1 byte": b"z", "13 bytes": b"q" * 13,
            "text 300": text[:300], "text 2000": text[:2000],
            "tail run": text[:3000] + b"\x07" * 1200,
            "tail zeros": text[:3000] + bytes(1200),
            "match 600": b"xyz0" + b"abcdefgh" * 75 + b"tail!",
            "runs": b"".join(text[k * 1000:(k + 1) * 1000] + bytes([k + 1]) * n
                             for k, n in enumerate((300, 700, 1500, 5000,
                                                    2600, 4097))),
            "2^17 - 1": (text * 12)[:(1 << 17) - 1],
            "superblock": concat[:1 << 14],
            "2^18": concat[:1 << 18], "2^20": concat[:1 << 20],
            "C1": concat[:1_200_000]}[name]


@pytest.mark.parametrize("name,seg_log2,lazy", [
    ("grammar.lsp", 17, True), ("kennedy.xls", 17, True),
    ("fields.c", 7, True), ("zeros", 17, True), ("random", 17, True),
    ("1 byte", 17, True), ("13 bytes", 17, True), ("text 300", 0, True),
    ("text 2000", 3, True), ("tail run", 9, True), ("tail zeros", 12, True),
    ("fields.c", 12, False), ("match 600", 17, True), ("C1", 17, True),
    ("runs", 17, True), ("2^17 - 1", 17, True), ("superblock", 17, True),
    ("2^18", 18, True), ("2^20", 20, True)])
def test_lz_kernels_match_plain_and_the_oracle(dev, name, seg_log2, lazy):
    """Kernels P, Q and R against their plain versions, and the container
    against the v2 oracle's: one segment and eight of 2^17, 88 of 2^7, runs,
    random bytes, inputs of 1 and 13 bytes, seg_log2 0 to 17, partial last
    segments ending in runs, lazy=False, a match past 15 + 255, the C1
    input (10 segments); for P also runs of up to 5,000 bytes between text
    (exits 256 or more past their block's end, step bytes of 255), 2^17 - 1
    positions (a partial last block), a 2^14-byte CT-SB superblock and one
    segment of 2^18 and of 2^20 positions (P's global-memory branch)."""
    data = _lz_input(name)
    n = len(data)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    rows, lens = lz_ops.segment_rows(x, seg_log2)
    lcp, cand = lz_ops.match_table(rows, lens)
    tokens = lz_kernels.walk(lcp, cand, lens, lazy)
    assert lz_kernels.walk_geometry(rows.shape[1]).staged == (
        rows.shape[1] <= 1 << 17)
    for a, b in zip(tokens, lz_kernels.walk_plain(lcp, cand, lens, lazy)):
        assert torch.equal(a, b)
    payload, sizes = lz_kernels.serialize(rows, lens, *tokens)
    pp, ps = lz_kernels.serialize_plain(rows, lens, *tokens)
    assert torch.equal(payload, pp) and torch.equal(sizes, ps)
    want = slz4_ref.slz4_encode(data, seg_log2=seg_log2, lazy=lazy,
                                parse="v2")
    total = int(sizes.sum())
    assert want[9 + 4 * rows.shape[0]:] == payload[:total].cpu().numpy() \
        .tobytes()
    assert payload.numel() == rows.shape[0] * lz_kernels.payload_bound(
        rows.shape[1]) and not payload[total:].any()
    assert ctt.compress(data, codec="slz4", seg_log2=seg_log2,
                        lazy=lazy) == want
    bases = sizes.cumsum(0) - sizes
    out, err = lz_kernels.decode(payload, bases, sizes, n, 1 << seg_log2)
    # the plain loop takes ~40 us a token on an H100
    if name not in ("kennedy.xls", "C1", "2^20"):
        po, pe = lz_kernels.decode_plain(payload, bases, sizes, n,
                                         1 << seg_log2)
        assert torch.equal(out, po) and torch.equal(err, pe)
    assert not err.any() and out.cpu().numpy().tobytes() == data
    assert ctt.decompress(want, codec="slz4") == data


def _lz_block(edit):
    """grammar.lsp's v2 block at seg_log2 12 with `edit` applied to the
    offset of its first match ("offset0", "before") or its length ("cut")."""
    data = _corpus("grammar.lsp")
    block = bytearray(slz4_ref.slz4_encode(data, seg_log2=12,
                                           parse="v2")[13:])
    lit = block[0] >> 4
    p = 1
    if lit == 15:
        while block[p] == 255:
            lit += 255
            p += 1
        lit += block[p]
        p += 1
    p += lit
    if edit == "offset0":
        block[p] = block[p + 1] = 0
    elif edit == "before":
        block[p] = block[p + 1] = 255
    elif edit == "cut":
        block = block[:-3]
    return data, bytes(block)


@pytest.mark.parametrize("edit,dn,code", [
    ("offset0", 0, lz_kernels.OFFSET_ZERO),
    ("before", 0, lz_kernels.OFFSET_BEFORE),
    ("none", -1, lz_kernels.WRITE_OVERRUN),
    ("none", 1, lz_kernels.BAD_LENGTH),
    ("cut", 0, lz_kernels.READ_OVERRUN)])
def test_lz_decode_refuses_as_plain(dev, edit, dn, code):
    """Kernel R sets its plain version's error code on a malformed block,
    and the codec raises CorruptContainerError."""
    from cpprcoder_tpu_torch.core.bytesutil import (
        ByteWriter,
        CorruptContainerError,
    )

    data, block = _lz_block(edit)
    n = len(data) + dn
    payload = torch.from_numpy(np.frombuffer(block, np.uint8).copy()).to(dev)
    bases = torch.zeros(1, dtype=torch.int64, device=dev)
    sizes = torch.tensor([len(block)], dtype=torch.int64, device=dev)
    out, err = lz_kernels.decode(payload, bases, sizes, n, 1 << 12)
    pout, perr = lz_kernels.decode_plain(payload, bases, sizes, n, 1 << 12)
    assert err.tolist() == perr.tolist() == [code]
    assert torch.equal(out, pout) and not out.any()
    blob = ByteWriter().u32(n).u8(12).u32(1).u32(len(block)).raw(block)
    with pytest.raises(CorruptContainerError):
        ctt.decompress(blob.getvalue(), codec="slz4")


# CT-LZ4 at seg_log2 17: the v2 oracle's container sizes
SLZ4_BYTES = {"alice29.txt": 71996, "asyoulik.txt": 63239, "cp.html": 11200,
              "fields.c": 4698, "grammar.lsp": 1844, "kennedy.xls": 328159,
              "lcet10.txt": 194547, "plrabn12.txt": 255487, "ptt5": 82237,
              "sum": 17377, "xargs.1": 2505}


@pytest.mark.parametrize("name", sorted(SLZ4_BYTES))
def test_slz4_corpus_on_the_card(dev, name):
    """compress(codec="slz4") on the card (kernels P and Q) writes the v2
    oracle's container of each file; decompress (kernel R) reads it and
    the v1 oracle's (backend="ref")."""
    data = _corpus(name)
    blob = ctt.compress(data, codec="slz4")
    assert len(blob) == SLZ4_BYTES[name]
    assert blob == slz4_ref.slz4_encode(data, parse="v2")
    assert ctt.decompress(blob, codec="slz4") == data
    v1 = ctt.compress(data, codec="slz4", backend="ref")
    assert ctt.decompress(v1, codec="slz4") == data


def _lz_container_args(blob, dev):
    r = ctt_bytes.ByteReader(blob)
    n, sl, ns = r.u32(), r.u8(), r.u32()
    sizes = r.u32s(ns).astype(np.int64)
    payload = torch.from_numpy(r.raw(int(sizes.sum())).copy()).to(dev)
    bases = torch.from_numpy(np.cumsum(sizes) - sizes).to(dev)
    return payload, bases, torch.from_numpy(sizes).to(dev), n, 1 << sl


def _lz_chain(tokens=(131_072 - 14) // 5):
    """A block whose every match copies the previous token's match."""
    block = bytearray([0x50]) + b"abcde" + bytes([4, 0])
    for i in range(tokens):
        block += bytes([0x10, 97 + i % 26, 5, 0])
    block += bytes([0x50]) + b"vwxyz"
    n = 14 + 5 * tokens
    blob = ctt_bytes.ByteWriter().u32(n).u8(17).u32(1).u32(len(block)).raw(
        bytes(block)).getvalue()
    return blob, slz4_ref.decode_block(bytes(block), n), [0]


def _lz_corrupt_segment():
    """kennedy.xls's first 32,768 bytes at seg_log2 12, segment 3's first
    match at offset 0."""
    data = _corpus("kennedy.xls")[:8 << 12]
    blob = bytearray(slz4_ref.slz4_encode(data, seg_log2=12, parse="v2"))
    sizes = np.frombuffer(bytes(blob[9:41]), "<u4")
    p = 41 + int(sizes[:3].sum())
    lit = blob[p] >> 4
    p += 1
    if lit == 15:
        while blob[p] == 255:
            lit += 255
            p += 1
        lit += blob[p]
        p += 1
    p += lit
    blob[p] = blob[p + 1] = 0
    return (bytes(blob), data[:3 << 12] + bytes(1 << 12) + data[4 << 12:],
            [0, 0, 0, lz_kernels.OFFSET_ZERO, 0, 0, 0, 0])


@pytest.mark.parametrize("case", ["corrupt segment", "chain", "seg_log2 18"])
def test_lz_decode_cases_as_plain(dev, case):
    """Kernel R against its plain version: 8 segments with segment 3
    corrupted (zero, its code), the longest chain of matches (26,211
    tokens, each a pointer hop past the one before), and 300,000 random
    bytes at seg_log2 18 (blocks past shared memory, read in place)."""
    if case == "seg_log2 18":
        data = np.random.default_rng(18).integers(0, 256, 300_000,
                                                  np.uint8).tobytes()
        blob = slz4_ref.slz4_encode(data, seg_log2=18, parse="v2")
        assert ctt.compress(data, codec="slz4", seg_log2=18) == blob
        want, codes = data, [0, 0]
    else:
        blob, want, codes = (_lz_corrupt_segment() if case == "corrupt segment"
                             else _lz_chain())
    args = _lz_container_args(blob, dev)
    out, err = lz_kernels.decode(*args)
    pout, perr = lz_kernels.decode_plain(*args)
    assert err.tolist() == perr.tolist() == codes
    assert torch.equal(out, pout) and out.cpu().numpy().tobytes() == want


def test_lz_serialize_and_decode_do_not_synchronize(dev):
    """Kernels P, Q and R at kennedy.xls, their inputs on the card, after a
    warm-up: no call synchronizes with the host."""
    data = _corpus("kennedy.xls")
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    rows, lens = lz_ops.segment_rows(x, 17)
    lcp, cand = lz_ops.match_table(rows, lens)
    tokens = lz_kernels.walk(lcp, cand, lens)
    payload, sizes = lz_kernels.serialize(rows, lens, *tokens)
    bases = sizes.cumsum(0) - sizes
    lz_kernels.decode(payload, bases, sizes, len(data), 1 << 17)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens2 = lz_kernels.walk(lcp, cand, lens)
        payload2, sizes2 = lz_kernels.serialize(rows, lens, *tokens)
        out, err = lz_kernels.decode(payload, bases, sizes, len(data),
                                     1 << 17)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(torch.equal(a, b) for a, b in zip(tokens2, tokens))
    assert torch.equal(payload2, payload) and torch.equal(sizes2, sizes)
    assert not err.any() and out.cpu().numpy().tobytes() == data


# ------------------------------------- kernels S, T (CT-ASE1) and U, V (CT-RC3)

def _seeded(n, seed, alphabet=256):
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet, n, dtype=np.uint8).tobytes()


def table_edge_hits(rounds: int) -> bytes:
    """64 distinct symbols, then hits at table indices 15, 16, 31, 32, 47,
    48, 0 and 63 in turn (`rounds` times): the entries that kernel T's quad
    keeps on either side of its threads' boundaries (16 entries each)."""
    table = list(range(64))
    out = list(table)
    for _ in range(rounds):
        for idx in (15, 16, 31, 32, 47, 48, 0, 63):
            s = table.pop(idx)
            table.append(s)
            out.append(s)
    return bytes(out)


# (data, K): runs (every hit at d = 0), all 256 values cycled (a full table
# evicting every step), exactly 64 and 65 distinct symbols, n not a
# multiple of K, K = 1, and K = 65,536 (the top, with lanes of length 0);
# for T's quads: lanes whose first words sit at offsets 0, 2, 1, 3 mod 4
# (the last lane ending on the payload's last word), hits at the indices
# on either side of its threads' boundaries, and a full table evicting
# every step at K = 2 (128 symbols a lane)
ASE_CASES = {
    "runs": (b"\x33" * 3000 + b"\x44" * 3000, 2),
    "cycle": (bytes(range(256)) * 40, 4),
    "64 distinct": (_seeded(8000, 31, 64), 1),
    "65 distinct": (_seeded(8000, 32, 65), 1),
    "ragged": (_seeded(256 * 40 + 7, 33, 90), 256),
    "K=1": (_seeded(10_000, 34, 200), 1),
    "K=65536": (b"\x05" * 70_000 + _seeded(60_000, 35), 65536),
    "first words at each offset mod 4": (_seeded(4 * 500 + 1, 1, 70), 4),
    "hits at the quad's edges": (table_edge_hits(300), 1),
    "full table evicting, K=2": (bytes(range(256)) * 30, 2),
}


@pytest.mark.parametrize("case", list(ASE_CASES))
def test_ase_kernels_match_plain_and_the_oracle(dev, case):
    data, k = ASE_CASES[case]
    n = len(data)
    stride = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    payload, bits = ase_kernels.encode_words(x2d, lens)
    p_plain, b_plain = ase_ops.encode_words_plain(x2d, lens)
    assert torch.equal(payload, p_plain) and torch.equal(bits, b_plain)
    counts = (bits.to(torch.int64) + 15) // 16
    p = int(counts.sum())
    bases = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    args = (payload[:p].contiguous(), bases, counts.to(torch.int32), lens, n,
            stride)
    if case == "first words at each offset mod 4":
        assert sorted((bases % 4).tolist()) == [0, 1, 2, 3]
        assert int(bases[-1] + counts[-1]) == p
    out = ase_kernels.decode_symbols(*args)
    assert torch.equal(out, ase_ops.decode_symbols_plain(*args))
    assert out.cpu().numpy().tobytes() == data
    blob = ctt.compress(data, codec="ase", device="cuda", lanes=k)
    assert blob == ase_ref.ase_encode(data, lanes=k)
    assert ctt.decompress(blob, codec="ase", device="cuda") == data


def _s_lane(kind, seed):
    """One lane's bytes for kernel S's segment edges (about 700 steps)."""
    rng = np.random.default_rng(seed)
    if kind == "63 and 64 distinct between occurrences":
        out = []
        for r in range(6):
            a, b = 200 + r % 40, 250 - r % 5
            out += [a] + list(range(63)) + [a] + [b] + list(range(64)) + [b]
        return bytes(out)
    if kind == "previous occurrence segments back":
        out = []
        for r in range(5):
            out += [7 + r] + list(rng.integers(0, 3, 130)) + [7 + r]
        return bytes(np.array(out, np.uint8))
    if kind == "one byte over many segments":
        return b"\x00" * 400 + rng.integers(0, 90, 300, dtype=np.uint8).tobytes()
    if kind == "66 values (eviction at the edge)":
        return rng.integers(0, 66, 700, dtype=np.uint8).tobytes()
    return bytes(700)                      # zeros: a segment in one word


def _s_input(kind, k, dev):
    """The lanes interleaved, the first k // 2 one step longer."""
    lanes = [np.frombuffer(_s_lane(kind, i), np.uint8) for i in range(k)]
    steps = min(len(v) for v in lanes) - 1
    x = np.stack([v[:steps + 1] for v in lanes], axis=1).reshape(-1)
    data = x[:steps * k + (k // 2 if k > 1 else 1)].tobytes()
    n, stride = len(data), steps + 1
    t = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    return (data, layout.pad2d_interleaved(t, k, stride),
            layout.lane_lengths_interleaved(n, k, stride, dev))


@pytest.mark.parametrize("seg", [1, 3, 64, None])
@pytest.mark.parametrize("lanes", [1, 2, 8])
@pytest.mark.parametrize("kind", ["63 and 64 distinct between occurrences",
                                  "previous occurrence segments back",
                                  "one byte over many segments",
                                  "66 values (eviction at the edge)",
                                  "zeros (a segment in one word)"])
def test_s_segment_edges_match_plain(dev, kind, lanes, seg):
    """Kernel S at 1, 3 and 64 steps a segment (and its default): the
    payload and bit counts equal its plain version's, and the oracle's
    container's."""
    data, x2d, lens = _s_input(kind, lanes, dev)
    payload, bits = ase_kernels.encode_words(x2d, lens, seg_steps=seg)
    want = ase_ops.encode_words_plain(x2d, lens)
    assert torch.equal(payload, want[0]) and torch.equal(bits, want[1])
    p = int(((bits.to(torch.int64) + 15) // 16).sum())
    blob = ase_ref.ase_encode(data, lanes=lanes)
    assert blob[5 + 4 * lanes:] == payload[:p].cpu().view(torch.uint8) \
        .numpy().tobytes()


@pytest.mark.parametrize("seg", [1, 2, 5])
def test_s_many_lanes_and_segments(dev, seg):
    """K = 65,536 (lanes of length 0 among them) and 2,048 at a few steps
    a segment: many segments a lane, and a payload tail to zero."""
    for data, k in ((b"\x05" * 70_000 + _seeded(60_000, 35), 65536),
                    (_seeded(2048 * 20 + 3, 37, 80), 2048)):
        n = len(data)
        stride = -(-n // k)
        x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
        x2d = layout.pad2d_interleaved(x, k, stride)
        lens = layout.lane_lengths_interleaved(n, k, stride, dev)
        payload, bits = ase_kernels.encode_words(x2d, lens, seg_steps=seg)
        want = ase_ops.encode_words_plain(x2d, lens)
        assert torch.equal(payload, want[0]) and torch.equal(bits, want[1])


def test_ase_decode_random_words_match_plain(dev):
    """T and its plain version agree on words that no encoder wrote
    (hits past a table's end, counts that claim more words than there
    are)."""
    rng = np.random.default_rng(36)
    k, stride = 64, 300
    words = torch.from_numpy(rng.integers(-(1 << 15), 1 << 15, 5000,
                                          dtype=np.int16)).to(dev)
    counts = torch.from_numpy(rng.integers(0, 120, k).astype(np.int32)).to(dev)
    bases = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    lens = torch.full((k,), stride, dtype=torch.int32, device=dev)
    args = (words, bases, counts, lens, k * stride, stride)
    assert torch.equal(ase_kernels.decode_symbols(*args),
                       ase_ops.decode_symbols_plain(*args))


# (data, K, options): rows that halve nearly every step (limit1_log2 9),
# t0 rescales, n < K (empty lanes), a one-byte run (every lane's update on
# one cell), the u32 table (blend 0, limit1_log2 17: t1[7][7] passes 2^16)
# at one and four lanes, a large inc, 2,048 lanes (two a thread) and
# K = 65,536 (64 a thread, the u32 table)
O1_CASES = {
    "limit1 9": (_textish(3000, 41).tobytes(), 2, dict(limit1_log2=9)),
    "t0 rescales": (_seeded(6000, 42, 50), 4, dict(limit0_log2=10, inc=16)),
    "n < K": (b"abcde", 8, {}),
    "one-byte run": (b"\x61" * 20_000, 64, dict(inc=255)),
    "u32 lanes 1": (b"\x07" * 6000 + bytes(range(256)) * 4, 1,
                    dict(blend_log2=0, limit1_log2=17)),
    "u32 lanes 4": (b"\x07" * 6000 + bytes(range(256)) * 4, 4,
                    dict(blend_log2=0, limit1_log2=17)),
    "large inc": (_textish(8000, 43).tobytes(), 8,
                  dict(inc=200, blend_log2=0, limit1_log2=13)),
    "K=2048": (_textish(2048 * 6 + 5, 44).tobytes(), 2048, {}),
    "K=65536": (_seeded(65536 * 2 + 100, 45), 65536, {}),
    # kernel V's second design: every row halved every step (limit1_log2
    # 8), rows halving at 64 lanes (9), t0 every step (limit0_log2 8), 64
    # lanes on the same bytes (all of them taking one row over its limit in
    # one step), one-byte runs at 256 and 2,048 lanes (every atomic on one
    # address; at 2,048 grouped by __match_any_sync), 256 symbols in one
    # warp (K = 32), and K = 1, 32 and 64
    "limit1_log2 8": (_textish(3000, 47).tobytes(), 2, dict(limit1_log2=8)),
    "limit1_log2 9, 64 lanes": (_textish(64 * 50 + 3, 48).tobytes(), 64,
                                dict(limit1_log2=9)),
    "limit0_log2 8": (_seeded(4000, 49, 60), 4, dict(limit0_log2=8)),
    "lanes crossing a row together": (_textish(80, 50).tobytes() * 64, 64, {}),
    "one-byte run, 256 lanes": (bytes(256 * 40), 256, {}),
    "one-byte run, 2048 lanes": (bytes(2048 * 6), 2048, {}),
    "256 symbols in one warp": (bytes(i % 256 for i in range(32 * 300)), 32,
                                {}),
    "K=1": (_textish(3000, 51).tobytes(), 1, {}),
    "K=32": (_textish(32 * 60 + 5, 52).tobytes(), 32, {}),
    "K=64": (_textish(64 * 40 + 3, 53).tobytes(), 64, {}),
}


@pytest.mark.parametrize("case", list(O1_CASES))
def test_o1_kernels_match_plain_and_the_oracle(dev, case):
    data, k, opts = O1_CASES[case]
    n = len(data)
    steps = -(-n // k)
    params = (opts.get("inc", o1_ref.pick_inc(k)), opts.get("limit1_log2", 11),
              opts.get("limit0_log2", 15), opts.get("blend_log2", 5))
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    x2d = layout.pad2d_chunked(x, k, steps)
    lens = layout.lane_lengths(n, k, steps, dev)
    ev = o1_kernels.encode_events(x2d, lens, *params)
    assert torch.equal(ev, o1_ops.encode_events_plain(x2d, lens, *params))
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = o1_kernels.decode_symbols(words, lens, n, steps, *params)
    assert torch.equal(out, o1_ops.decode_symbols_plain(words, lens, n, steps,
                                                        *params))
    assert out.cpu().numpy().tobytes() == data
    blob = ctt.compress(data, codec="adaptive_o1", device="cuda", lanes=k,
                        **opts)
    assert blob == o1_ref.o1_encode(data, lanes=k, **opts)
    assert ctt.decompress(blob, codec="adaptive_o1", device="cuda") == data


def _o1_inputs(data, k, opts, dev):
    n = len(data)
    steps = -(-n // k)
    params = (opts.get("inc", o1_ref.pick_inc(k)),
              opts.get("limit1_log2", o1_ref.LIMIT1_LOG2),
              opts.get("limit0_log2", o1_ref.LIMIT0_LOG2),
              opts.get("blend_log2", o1_ref.BLEND_LOG2))
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    return (n, steps, layout.pad2d_chunked(x, k, steps),
            layout.lane_lengths(n, k, steps, dev), params)


# kernel U's passes alone and over chunks (data, K, options, chunk steps):
# the CPU tests' chunk cases (steps one below, at and one past the chunk,
# chunks of one step, the last lane ending mid-chunk, every row halved
# every step, a one-byte run at 256 lanes), the u32 table (t1 in global
# memory across the edges), 2,048 lanes (two a thread) and 65,536, each
# crossing at least two chunk edges
U_CHUNKED = {
    "steps one below the chunk": (_textish(8 * 60, 54).tobytes(), 8, {}, 61),
    "steps at the chunk": (_textish(8 * 60, 54).tobytes(), 8, {}, 60),
    "steps one past the chunk": (_textish(8 * 60, 54).tobytes(), 8, {}, 59),
    "chunks of one step": (_textish(4 * 50, 55).tobytes(), 4, {}, 1),
    "the last lane ending mid-chunk": (_textish(8 * 50 + 17, 56).tobytes(), 8,
                                       {}, 20),
    "every row halved every step": (_textish(3000, 47).tobytes(), 2,
                                    dict(limit1_log2=8), 7),
    "one-byte run at 256 lanes": (bytes(256 * 40), 256, {}, 16),
    "u32 table": (b"\x07" * 6000 + bytes(range(256)) * 4, 4,
                  dict(blend_log2=0, limit1_log2=17), 300),
    "K=2048": (_textish(2048 * 6 + 5, 44).tobytes(), 2048, {}, 2),
    "K=65536": (_seeded(65536 * 3 + 100, 45), 65536, {}, 1),
}


@pytest.mark.parametrize("case", list(U_CHUNKED))
def test_u_passes_match_their_plain_versions(dev, case):
    """U's model pass equals model_triples_plain, its coder pass
    coder_events_plain, and U over chunks of a few steps (at least two
    edges) equals encode_events_plain and the oracle's container."""
    data, k, opts, chunk = U_CHUNKED[case]
    n, steps, x2d, lens, params = _o1_inputs(data, k, opts, dev)
    trip = o1_kernels.model_triples(x2d, lens, *params)
    trip_p, _ = o1_ops.model_triples_plain(x2d, lens, *params)
    assert torch.equal(trip, trip_p)
    ev = o1_kernels.coder_events(trip)
    assert torch.equal(ev, o1_ops.coder_events_plain(trip_p)[0])
    assert torch.equal(o1_kernels.encode_events(x2d, lens, *params,
                                                chunk_steps=chunk), ev)
    assert torch.equal(o1_ops.encode_events_plain(x2d, lens, *params,
                                                  chunk_steps=chunk), ev)
    rows, sizes = expand.materialize_rows(ev)
    blob = layout.assemble(lambda wide: o1_ops.header(n, k, wide, *params),
                           rows.cpu().numpy(), sizes.cpu().numpy())
    assert blob == o1_ref.o1_encode(data, lanes=k, **opts)


@pytest.mark.parametrize("rows", ["one word row", "rows ending at a word edge"])
def test_o1_decode_word_row_edges(dev, rows):
    """V against its plain version on word rows cut short: a single row
    (l4 = 1), and rows that end with the longest lane's last word (no zero
    row after it; three lanes' payloads end on a word edge there). Past a
    row's end both read zeros."""
    data = _seeded(8 * 120, 3, 40)
    n, k = len(data), 8
    steps = -(-n // k)
    params = (o1_ref.pick_inc(k), 11, 15, 5)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    lens = layout.lane_lengths(n, k, steps, dev)
    rows_, sizes = expand.materialize_rows(
        o1_kernels.encode_events(layout.pad2d_chunked(x, k, steps), lens,
                                 *params))
    words = layout.decode_words(rows_, sizes)
    assert int(sizes.max()) % 4 == 0 and int((sizes % 4 == 0).sum()) == 3
    cut = words[:1] if rows == "one word row" \
        else words[:int(sizes.max()) // 4]
    cut = cut.contiguous()
    out = o1_kernels.decode_symbols(cut, lens, n, steps, *params)
    assert torch.equal(out, o1_ops.decode_symbols_plain(cut, lens, n, steps,
                                                        *params))
    if rows != "one word row":
        assert out.cpu().numpy().tobytes() == data


def test_o1_outside_the_bound_raises_on_the_card(dev):
    """Fault P6 on the card: U raises ValueError at the first step whose t
    = range / tot_eff is 0 ("abracadabra" x 50 at lanes 1, blend_log2 14:
    step 100), V raises CorruptContainerError at a header with n >= 1 and
    blend_log2 24 (t = 0 at step 0) and at a step past the first (ten
    zeros at blend_log2 23, a zero payload: step 1); the plain versions
    name the same steps."""
    data = b"abracadabra" * 50
    x2d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).reshape(
        -1, 1).to(dev)
    lens = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    for fn in (o1_kernels.encode_events, o1_ops.encode_events_plain):
        with pytest.raises(ValueError, match="step 100, lane 0"):
            fn(x2d, lens, 32, 11, 15, 14)
    words = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    ten = torch.tensor([10], dtype=torch.int32, device=dev)
    with pytest.raises(ctt_bytes.CorruptContainerError, match="step 0"):
        o1_kernels.decode_symbols(words, ten, 10, 10, 32, 11, 15, 24)
    for fn in (o1_kernels.decode_symbols, o1_ops.decode_symbols_plain):
        with pytest.raises(ctt_bytes.CorruptContainerError,
                           match="step 1, lane 0"):
            fn(words, ten, 10, 10, 32, 16, 16, 23)


# fault P6: the CPU tests' inputs past C8's bound, which the oracle writes
# and decodes (20,000 zeros at lanes 1 at full size here)
DATA = Path(__file__).resolve().parent.parent / "data"
O1_P6 = {
    "b'a' at lanes 64": (b"a", 64, {}),
    "alice29.txt[:488] at lanes 64": (
        (DATA / "alice29.txt").read_bytes()[:488], 64, {}),
    "grammar.lsp at lanes 2": ((DATA / "grammar.lsp").read_bytes(),
                               2, {}),
    "20,000 zeros at lanes 1": (bytes(20000), 1, {}),
    "xargs.1 at lanes 4, limits 16 / 16": (
        (DATA / "xargs.1").read_bytes(), 4, dict(limit0_log2=16)),
}


# fault P7's repair: streams past the u32 kernels' old guard (256 +
# inc*L*K >= 2^32 - 1 at a limit_log2 of 32 or more), where U and V keep
# their counts and totals in 64 bits (what the refusal test of the u32
# kernels refused): zeros at blend 5 (t = 0 once row 0 passes 2^27), and
# random bytes at limit1_log2 32 and 33 (-> (x2d, K, params))
def _past_guard(case, dev):
    k, steps, params, zeros = {
        "4,096 x 4,200 zeros, limits 32 / 11, blend 5":
            (4096, 4200, (255, 32, 11, 5), True),
        "65,536 x 263 random bytes, limits 32 / 11":
            (65536, 263, (255, 32, 11, 0), False),
        "65,536 x 263 random bytes, limits 33 / 11":
            (65536, 263, (255, 33, 11, 0), False)}[case]
    x = np.zeros(k * steps, np.uint8) if zeros else \
        np.random.default_rng(22).integers(0, 256, k * steps, np.uint8)
    x2d = torch.from_numpy(x).to(dev).reshape(k, steps).T.contiguous()
    return x2d, k, params


def _outcome(fn):
    """-> ("ok", output) or the error's type and message."""
    try:
        return "ok", fn()
    except ValueError as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", [
    "4,096 x 4,200 zeros, limits 32 / 11, blend 5",
    "65,536 x 263 random bytes, limits 32 / 11",
    "65,536 x 263 random bytes, limits 33 / 11"])
def test_o1_past_the_old_guard_matches_plain_on_the_card(dev, case):
    """U and V at streams whose totals could reach 2^32 - 1: the 64-bit
    instantiation (o1_ops.counts_long) gives what the plain versions give,
    the same events (which V decodes back, as its plain version does) or
    the same step error, step and lane."""
    x2d, k, params = _past_guard(case, dev)
    steps = x2d.shape[0]
    assert o1_ops.counts_long(steps, k, *params[:3])
    lens = torch.full((k,), steps, dtype=torch.int32, device=dev)
    got = _outcome(lambda: o1_kernels.encode_events(x2d, lens, *params))
    want = _outcome(lambda: o1_ops.encode_events_plain(x2d, lens, *params))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert torch.equal(got[1], want[1])
        words = layout.decode_words(*expand.materialize_rows(got[1]))
    else:
        assert got[1] == want[1] and "range / tot_eff = 0" in got[1]
        words = torch.zeros((1, k), dtype=torch.int32, device=dev)
    n = k * steps
    got = _outcome(lambda: o1_kernels.decode_symbols(words, lens, n, steps,
                                                     *params))
    want = _outcome(lambda: o1_ops.decode_symbols_plain(words, lens, n,
                                                        steps, *params))
    assert got[0] == want[0] and (got[0] != "ok" or torch.equal(got[1],
                                                                want[1]))
    if got[0] == "ok":
        assert torch.equal(got[1], x2d.T.reshape(-1))
    else:
        assert got[1] == want[1]


@pytest.mark.parametrize("case", ["limit1 9", "t0 rescales", "n < K",
                                  "u32 lanes 4", "large inc", "K=2048",
                                  "K=65536", "limit1_log2 8",
                                  "limit0_log2 8", "one-byte run, 2048 lanes",
                                  "K=1", "K=64"])
def test_o1_long_counts_match_plain_on_the_card(dev, case):
    """The 64-bit instantiation of U and V (long_counts=True), which the
    wrappers pick only past the old guard, equals the plain versions and
    the u32 instantiation wherever both hold: rows and t0 halved, the
    table in global memory, 2,048 and 65,536 lanes."""
    data, k, opts = O1_CASES[case]
    n, steps, x2d, lens, params = _o1_inputs(data, k, opts, dev)
    ev = o1_kernels.encode_events(x2d, lens, *params, long_counts=True)
    assert torch.equal(ev, o1_ops.encode_events_plain(x2d, lens, *params))
    assert torch.equal(o1_kernels.encode_events(x2d, lens, *params,
                                                chunk_steps=3,
                                                long_counts=True), ev)
    assert torch.equal(o1_kernels.model_triples(x2d, lens, *params,
                                                long_counts=True),
                       o1_ops.model_triples_plain(x2d, lens, *params)[0])
    words = layout.decode_words(*expand.materialize_rows(ev))
    out = o1_kernels.decode_symbols(words, lens, n, steps, *params,
                                    long_counts=True)
    assert out.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("case", list(O1_P6))
def test_o1_p6_inputs_match_the_oracle_on_the_card(dev, case):
    """U writes the oracle's container and V decodes it; both equal their
    plain versions (but at 20,000 steps, where the plain loops would take
    most of a minute: the oracle's bytes hold U there)."""
    data, k, extra = O1_P6[case]
    opts = {**dict(inc=32, limit1_log2=16, limit0_log2=12, blend_log2=8),
            **extra}
    n, steps, x2d, lens, params = _o1_inputs(data, k, opts, dev)
    ev = o1_kernels.encode_events(x2d, lens, *params)
    oracle = o1_ref.o1_encode(data, lanes=k, **opts)
    rows, sizes = expand.materialize_rows(ev)
    assert layout.assemble(lambda wide: o1_ops.header(n, k, wide, *params),
                           rows.cpu().numpy(), sizes.cpu().numpy()) == oracle
    assert ctt.compress(data, codec="adaptive_o1", device="cuda", lanes=k,
                        **opts) == oracle
    assert ctt.decompress(oracle, codec="adaptive_o1", device="cuda") == data
    words = layout.decode_words(rows, sizes)
    out = o1_kernels.decode_symbols(words, lens, n, steps, *params)
    assert out.cpu().numpy().tobytes() == data
    if steps <= 2200:
        assert torch.equal(ev, o1_ops.encode_events_plain(x2d, lens, *params))
        assert torch.equal(out, o1_ops.decode_symbols_plain(words, lens, n,
                                                            steps, *params))


@pytest.mark.parametrize("codec", ["ase", "adaptive_o1"])
def test_s_t_u_v_launch_counters_move(dev, codec):
    counters = ([(ase_kernels, "encode_launches"),
                 (ase_kernels, "decode_launches")] if codec == "ase" else
                [(o1_kernels, "encode_launches"), (expand, "launches"),
                 (o1_kernels, "decode_launches")])
    before = [getattr(m, a) for m, a in counters]
    data = _textish(5000, 46).tobytes()
    blob = ctt.compress(data, codec=codec)
    assert ctt.decompress(blob, codec=codec) == data
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
        == [1] * len(counters)


# ------------------------------------------- kernels W, X, Y (CT-ANS2)

def _corpus(name):
    return (Path(__file__).resolve().parent.parent / "data" / name).read_bytes()


def _ans2_counts():
    """Count vectors [B, 256] for the normalize: random at every scale (to
    past 2^32), sparse, one dominant symbol, one symbol alone (rule 5), all
    equal, all zero."""
    rng = np.random.default_rng(51)
    rows = [rng.integers(0, 10 ** int(rng.integers(1, 12)), 256)
            for _ in range(60)]
    for i in range(20):
        h = rng.integers(1, 1000, 256)
        h[rng.random(256) < 0.9] = 0
        rows.append(h)
    dominant = np.ones(256, np.int64)
    dominant[9] = 1 << 40
    alone = np.zeros(256, np.int64)
    alone[255] = 12345
    rows += [dominant, alone, np.full(256, 777, np.int64),
             np.full(256, 1 << 33, np.int64), np.zeros(256, np.int64),
             (2.0 ** -np.minimum(np.arange(256) // 3, 60) * 1e15)
             .astype(np.int64)]
    return np.stack(rows).astype(np.int64)


def test_ans2_normalize_matches_the_oracle(dev):
    counts = _ans2_counts()
    e = ans2_kernels.normalize_tables(torch.from_numpy(counts).to(dev))
    f, c = ans2_ops.entry_tables(e)
    assert torch.equal(e, ans2_ops.table_entries(f, c))
    for i, row in enumerate(counts):
        want = normalize_freqs(row, 14) if row.sum() else np.zeros(256)
        assert np.array_equal(f[i].cpu().numpy(), want), i
        assert np.array_equal(c[i].cpu().numpy(),
                              np.concatenate([[0], np.cumsum(want)[:-1]])), i


# (data, K, options): kennedy.xls's and grammar.lsp's shapes, a table every
# step (refresh_log2 0), every window a warm-up window (refresh_log2 past
# bitlen(steps)), a rescale at nearly every window (limit_log2 9), n < K,
# n not a multiple of K, a one-byte run, all 256 values, K = 1 and the top,
# K = 65,536
ANS2_CASES = {
    "kennedy.xls": (_corpus("kennedy.xls"), 256, {}),
    "grammar.lsp": (_corpus("grammar.lsp"), 2, {}),
    "refresh 0": (_textish(4000, 52).tobytes(), 4, dict(refresh_log2=0)),
    "refresh past steps": (_textish(6000, 53).tobytes(), 8,
                           dict(refresh_log2=40)),
    "limit 9": (_textish(9000, 54).tobytes(), 16,
                dict(limit_log2=9, inc=255)),
    "n < K": (b"abcde", 8, {}),
    "ragged": (_seeded(256 * 30 + 7, 55, 90), 256, dict(limit_log2=12)),
    "one-byte run": (b"\x61" * 20_000, 64, dict(inc=255, limit_log2=200)),
    "all 256 values": (bytes(range(256)) * 40, 32, dict(refresh_log2=2)),
    "K=1": (_seeded(6000, 56, 200), 1, {}),
    "K=65536": (b"\x05" * 70_000 + _seeded(70_000, 57), 65536, {}),
    # kernel Y's second design: more words than its ring of 8,192 holds,
    # every lane refilling at the same steps, a window every step at one
    # warp and past it, K = 32 and 64 around the one-warp cut, and the
    # states in shared memory (16,384 lanes) and in global scratch with the
    # ring (32,768)
    "more words than the ring": (_seeded(64 * 400, 59), 64, {}),
    "every lane refilling": (b"\x42" * (64 * 300), 64, dict(inc=1)),
    "a window every step, K=32": (_seeded(32 * 60, 60, 70), 32,
                                  dict(refresh_log2=0)),
    "a window every step, K=64": (_seeded(64 * 40, 61, 70), 64,
                                  dict(refresh_log2=0)),
    "K=32": (_corpus("fields.c")[:32 * 70 + 9], 32, {}),
    "K=64": (_corpus("fields.c")[:64 * 40 + 33], 64, {}),
    "K=16384": (_seeded(16384 * 5 + 77, 62, 100), 16384, {}),
    "K=32768": (_seeded(32768 * 3 + 5, 63, 100), 32768, {}),
    # kernel X's second design (tables staged from step 16 on where windows
    # are 16 steps or more, runs of 16; global reads below): window edges
    # inside a run of 16 (refresh_log2 3), lanes of steps - 1 steps at 16
    # and 32 steps a window, K = 1 staged and not, one staged step, K = 32
    "X: refresh 3, K=8": (_seeded(8 * 300 + 3, 81, 90), 8,
                          dict(refresh_log2=3)),
    "X: refresh 4, K=4": (_corpus("fields.c")[:4 * 400 + 1], 4,
                          dict(refresh_log2=4)),
    "X: refresh 5, lanes of steps - 1, K=32": (_seeded(32 * 120 - 5, 82, 60),
                                               32, dict(refresh_log2=5)),
    "X: K=1": (_seeded(3000, 83, 120), 1, {}),
    "X: K=1, refresh 3": (_corpus("xargs.1")[:1200], 1,
                          dict(refresh_log2=3, limit_log2=12)),
    "X: one staged step, K=64": (_seeded(64 * 17 - 3, 84), 64,
                                 dict(refresh_log2=5)),
    "X: K=32, 300 steps": (_seeded(32 * 300, 85, 200), 32, {}),
    # kernel W's second design: one step at 65,536 lanes (one table), n = 1,
    # no rescale (limit_log2 63), windows of 32 histogram rows, one walk
    # chunk each (65,536 lanes, windows of 8 steps), and the walk's chunks
    # of 32 windows crossed many times (refresh_log2 0 at 3,000 steps)
    "W: K=65536, one step": (_seeded(50_000, 86), 65536, {}),
    "W: n = 1": (b"q", 1, {}),
    "W: limit 63": (_textish(16 * 700, 87).tobytes(), 16,
                    dict(limit_log2=63)),
    "W: 32 rows a window, K=65536": (_seeded(65536 * 40, 88, 50), 65536,
                                     dict(refresh_log2=3)),
    "W: refresh 0, 3,000 windows": (_textish(3000, 89).tobytes(), 1,
                                    dict(refresh_log2=0)),
}


def _ans2_inputs(data, k, dev):
    n = len(data)
    steps = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    return (n, steps, layout.pad2d_interleaved(x, k, steps),
            layout.lane_lengths_interleaved(n, k, steps, dev))


def _ans2_params(k, n, opts):
    return (opts.get("inc", ans2_ref.ANS2_INC_DEFAULT),
            opts.get("limit_log2", ans2_ref.ANS2_LIMIT_LOG2_DEFAULT),
            opts.get("refresh_log2", ans2_ref.default_refresh_log2(k, n)))


@pytest.mark.parametrize("case", list(ANS2_CASES))
def test_ans2_kernels_match_plain_and_the_oracle(dev, case):
    data, k, opts = ANS2_CASES[case]
    n, steps, x2d, lens = _ans2_inputs(data, k, dev)
    inc, limit_log2, r_log2 = _ans2_params(k, n, opts)
    entries = ans2_kernels.window_tables(x2d, n, inc, limit_log2, r_log2)
    assert torch.equal(entries, ans2_ops.window_tables_plain(
        x2d, n, inc, limit_log2, r_log2))
    ev, states = ans2_kernels.encode_events(x2d, lens, entries, r_log2)
    ev_p, states_p = ans2_ops.encode_events_plain(x2d, lens, entries, r_log2)
    assert torch.equal(ev, ev_p) and torch.equal(states, states_p)
    words = ans2_ops.stream_words(ev).to(torch.int16)
    out = ans2_kernels.decode_symbols(words, states, n, inc, limit_log2,
                                      r_log2)
    if steps <= 4100:
        assert torch.equal(out, ans2_ops.decode_symbols_plain(
            words, states, n, inc, limit_log2, r_log2))
    assert out.cpu().numpy().tobytes() == data
    blob = ctt.compress(data, codec="adaptive_rans", device="cuda", lanes=k,
                        **opts)
    assert blob == ans2_ref.ans2_encode(data, lanes=k, **opts)
    assert ctt.decompress(blob, codec="adaptive_rans", device="cuda") == data


@pytest.mark.parametrize("limit_log2", [40, 33, 32])
def test_ans2_model_past_2_32(dev, limit_log2):
    """8,192 lanes of 4,100 steps of one byte at inc 255: the counts pass
    2^32 (at limit_log2 32 the model rescales there). W's tables equal the
    oracle's model pass, and X and Y round-trip."""
    k, steps, inc, r_log2 = 8192, 4100, 255, 13
    data = b"\x07" * (k * steps)
    n, steps, x2d, lens = _ans2_inputs(data, k, dev)
    entries = ans2_kernels.window_tables(x2d, n, inc, limit_log2, r_log2)
    freqs, cums = ans2_ops.entry_tables(entries)
    snaps = ans2_ref._snapshots_and_counts(
        np.frombuffer(data, np.uint8).reshape(steps, k), n, k, inc,
        1 << limit_log2, 1 << r_log2)
    assert freqs.shape[0] == len(snaps)
    for w, (f, c) in enumerate(snaps):
        assert np.array_equal(freqs[w].cpu().numpy(), f)
        assert np.array_equal(cums[w].cpu().numpy(), c)
    ev, states = ans2_kernels.encode_events(x2d, lens, entries, r_log2)
    out = ans2_kernels.decode_symbols(ans2_ops.stream_words(ev)
                                      .to(torch.int16), states, n, inc,
                                      limit_log2, r_log2)
    assert out.cpu().numpy().tobytes() == data


@pytest.mark.parametrize("cut", [0, 3, 1000])
def test_y_word_stream_cut_short(dev, cut):
    """Y on a word stream cut inside the last refilling step's words (and
    far before): the lanes that read past its end read 0, as in the plain
    decoder; the stream's length not a multiple of 8 words (the tail read
    from global memory), and a words tensor 2 bytes off 16-byte alignment
    (the wrapper copies it)."""
    data, k = _seeded(64 * 200, 64, 120), 64
    n, steps, x2d, lens = _ans2_inputs(data, k, dev)
    inc, limit_log2, r_log2 = _ans2_params(k, n, {})
    entries = ans2_kernels.window_tables(x2d, n, inc, limit_log2, r_log2)
    ev, states = ans2_kernels.encode_events(x2d, lens, entries, r_log2)
    words = ans2_ops.stream_words(ev).to(torch.int16)
    words = words[:words.numel() - cut]
    for w in (words, torch.cat([words[:1], words])[1:]):
        out = ans2_kernels.decode_symbols(w, states, n, inc, limit_log2,
                                          r_log2)
        assert torch.equal(out, ans2_ops.decode_symbols_plain(
            w.contiguous(), states, n, inc, limit_log2, r_log2))
        assert (out.cpu().numpy().tobytes() == data) == (cut == 0)


def test_ans2_kernels_refuse_past_65536_lanes(dev):
    data = b"abc" * 50_000
    with pytest.raises(ValueError, match="65536"):
        ctt.compress(data, codec="adaptive_rans", device="cuda", lanes=1 << 17)
    blob = ans2_ref.ans2_encode(data, lanes=1 << 17)
    with pytest.raises(ValueError, match="65536"):
        ctt.decompress(blob, codec="adaptive_rans", device="cuda")


def test_w_x_y_launch_counters_move(dev):
    counters = [(ans2_kernels, "model_launches"),
                (ans2_kernels, "encode_launches"),
                (ans2_kernels, "decode_launches")]
    before = [getattr(m, a) for m, a in counters]
    data = _textish(5000, 58).tobytes()
    blob = ctt.compress(data, codec="adaptive_rans")
    assert ctt.decompress(blob, codec="adaptive_rans") == data
    assert [getattr(m, a) - b for (m, a), b in zip(counters, before)] \
        == [1, 1, 1]


# ---------------------------------------------- the sharded paths' forms

def _shard_words(words, lane_n):
    k = words.shape[1]
    ko = k // lane_n
    return [words[:, r * ko:(r + 1) * ko].contiguous()[None]
            for r in range(lane_n)], ko


@pytest.mark.parametrize("k,cbits,lane_n,rank",
                         [(64, 4, 2, 1), (256, 8, 2, 0), (1024, 4, 2, 1),
                          (2048, 8, 4, 3), (4096, 4, 2, 0)])
def test_rcx_encode_range_matches_plain(dev, k, cbits, lane_n, rank):
    """Kernel A's lane-range form (one CTA, its global model, the cluster
    from 1,024 lanes) against its plain version and the one-shot events'
    columns."""
    n = 30 * k - k // 3
    x = torch.from_numpy(_textish(n, k + 1)).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_chunked(x, k, stride)
    lens = layout.lane_lengths(n, k, stride, dev)
    ko = k // lane_n
    cols = slice(rank * ko, (rank + 1) * ko)
    before = (rcx_kernels.range_launches, rcx_kernels.encode_launches)
    got = rcx_kernels.encode_events_range(x2d, lens, rank * ko, ko, 16,
                                          1 << 16, cbits, 0)
    torch.cuda.synchronize()
    # the form counts its own launch, apart from the one-shot kernel's
    assert (rcx_kernels.range_launches,
            rcx_kernels.encode_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, rcx_ops.encode_events_plain(
        x2d, lens, 16, 1 << 16, cbits, 0)[:, cols])
    assert torch.equal(got, rcx_kernels.encode_events(
        x2d, lens, 16, 1 << 16, cbits, 0)[:, cols])


@pytest.mark.parametrize("k,lane_n,rank", [(32, 2, 0), (2048, 2, 1),
                                           (8192, 4, 2)])
def test_rcq_and_rc2_encode_range_match_plain(dev, k, lane_n, rank):
    """Kernels D's and J's lane-range forms against their plain versions."""
    n = 25 * k - 5
    x = torch.from_numpy(_textish(n, k + 2)).to(dev)
    stride = -(-n // k)
    x2d = layout.pad2d_interleaved(x, k, stride)
    lens = layout.lane_lengths_interleaved(n, k, stride, dev)
    ko = k // lane_n
    cols = slice(rank * ko, (rank + 1) * ko)
    got = rcq_kernels.encode_events_range(x2d, lens, rank * ko, ko, 24,
                                          1 << 16)
    assert torch.equal(got, rcx_ops.encode_events_plain(
        x2d, lens, 24, 1 << 16, 0, 0, rcq_ops.ROUNDS)[:, cols])
    for limit in (16, 17):
        got = range_kernels.encode_events_range(x2d, lens, rank * ko, ko,
                                                None, 24, limit)
        assert torch.equal(got, range_ops.encode_events_plain(
            x2d, lens, None, 24, limit)[:, cols])


@pytest.mark.parametrize("codec,k,cbits,wlog,lane_n",
                         [("rcx", 64, 4, 0, 2), ("rcx", 256, 8, 2, 2),
                          ("rcx", 2048, 4, 1, 2), ("rcq", 128, 0, 0, 2),
                          ("rcq", 4096, 0, 0, 4)])
def test_stepped_decode_matches_plain(dev, codec, k, cbits, wlog, lane_n):
    """Kernels C's and E's stepped lane-range forms, lane_n ranks simulated:
    every launch's symbols and state (lane state, counts, contexts) against
    the plain version from the same state; the joined symbols are the
    input."""
    n = 20 * k - 3
    data = _textish(n, k + 3)
    x = torch.from_numpy(data).to(dev)
    stride = -(-n // k)
    if codec == "rcx":
        x2d = layout.pad2d_chunked(x, k, stride)
        lens = layout.lane_lengths(n, k, stride, dev)
        ev = rcx_kernels.encode_events(x2d, lens, 16, 1 << 16, cbits, wlog)
        inc, rounds = 16, 3
    else:
        x2d = layout.pad2d_interleaved(x, k, stride)
        lens = layout.lane_lengths_interleaved(n, k, stride, dev)
        ev = rcq_kernels.encode_events(x2d, lens, 24, 1 << 16)
        inc, rounds = 24, rcq_ops.ROUNDS
    words = layout.decode_words(*expand.materialize_rows(ev))
    ws, ko = _shard_words(words, lane_n)
    ll = lens[None].contiguous()
    states = [rcx_ops.decode_state(w, k, cbits) for w in ws]
    xs = torch.empty((1, 0, k), dtype=torch.uint8, device=dev)
    rows = []
    for t0 in range(0, stride, 1 << wlog):
        steps = min(1 << wlog, stride - t0)
        outs = []
        for r in range(lane_n):
            mirror = tuple(t.clone() for t in states[r])
            want = rcx_ops.decode_steps_plain(ws[r], ll, mirror, xs, r * ko,
                                              t0, steps, inc, 1 << 16, cbits,
                                              rounds)
            if codec == "rcx":
                got = rcx_kernels.decode_steps(ws[r], ll, states[r], xs,
                                               r * ko, t0, steps, inc,
                                               1 << 16, cbits, wlog)
            else:
                got = rcq_kernels.decode_steps(ws[r], ll, states[r], xs,
                                               r * ko, t0, inc, 1 << 16)
            assert torch.equal(got, want)
            for a, b in zip(states[r], mirror):
                assert torch.equal(a, b)
            outs.append(got)
        xs = torch.cat(outs, dim=2).contiguous()
        rows.append(xs[0])
    sym = torch.cat(rows)
    flat = (sym.T if codec == "rcx" else sym).reshape(-1)[:n]
    assert flat.cpu().numpy().tobytes() == data.tobytes()


def test_dryrun_multichip_world_of_one_over_nccl(dev):
    """dryrun_multichip(1) over NCCL on the card: every check passes in the
    rank, the one-shot kernels decode (no exchange), and the rank loads no
    JAX."""
    from cpprcoder_tpu_torch.parallel import dryrun

    res = dryrun.dryrun_multichip(1, backend="nccl", device="cuda")
    v = res[0].value[0]
    assert res[0].foreign == [] and v["backend"] == "nccl"
    assert v["rcx"]["exchanges"] == 0 and v["rcq"]["exchanges"] == 0
    assert res[0].launches["rcx_decode"] > 0
    assert res[0].launches["rc_exact_encode"] > 0
    assert all(res[0].launches[f] == 0 for f in dryrun.FORMS)
