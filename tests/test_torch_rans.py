"""CT-ANS1 v2 (rANS, the default codec) in the port, on the CPU (the plain
versions of kernels F and G), with exact equality throughout (integer
codec: tolerance 0).

At the kernel interface: the plain F and G, reached through the
rans_kernels wrappers on CPU tensors, against the interpret-mode Pallas
kernels rans_pallas._encode_call / _decode_call at K=128. The Pallas grid
pads the steps to bucket(stride); the port runs exactly stride steps, so
the Pallas pad rows must be zero and the final states equal.

For the codec: containers equal rans_ops.rans_encode_jax and the oracle
rans_ref.rans_encode, and the port decodes the JAX package's containers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.ops import rans_ops as jops
from cpprcoder_tpu.ops import rans_pallas
from cpprcoder_tpu.ops.huffman_pallas import _rows16_fn
from cpprcoder_tpu.reference import rans_ref
from cpprcoder_tpu.utils.shapes import bucket
from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError
from cpprcoder_tpu_torch.ops import layout, rans_kernels
from cpprcoder_tpu_torch.ops import rans_ops as tops
from cpprcoder_tpu_torch.ops.rc_common import i32_to_u32

rans_pallas._INTERPRET = True
K = 128


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


@pytest.mark.parametrize("n", [1500, 4096])
def test_encode_events_match_pallas(n):
    x = _textish(n, seed=11)
    stride = -(-n // K)
    steps = bucket(stride)
    pad = np.zeros(steps * K, np.uint8)
    pad[:n] = x
    states, words, pstart, n_words, counts, freqs = rans_pallas._encode_call(
        steps, K, K)(jnp.asarray(pad.reshape(steps, K)), n)
    xt = torch.from_numpy(x)
    f = tops.static_freqs(xt)
    assert np.array_equal(f, np.asarray(freqs))
    ev, st = rans_kernels.encode_events(
        layout.pad2d_interleaved(xt, K, stride),
        layout.lane_lengths_interleaved(n, K, stride, "cpu"),
        *tops.tables(f, "cpu"))
    assert ev.shape == (stride, K) and ev.dtype == torch.int32
    assert np.array_equal(i32_to_u32(st).numpy(), np.asarray(states))
    # the Pallas words are lane-major [K, steps]; a slot emits iff the next
    # slot's stream position advanced
    pstart = np.asarray(pstart)
    emits = np.append(pstart[1:], int(n_words)) > pstart
    jev = (emits.astype(np.int64) << 16 | np.asarray(words)).reshape(K, steps).T
    assert np.array_equal(ev.numpy(), jev[:stride])
    assert not jev[stride:].any()
    assert np.array_equal(((ev.numpy() >> 16) & 1).sum(axis=0),
                          np.asarray(counts))


@pytest.mark.parametrize("n", [1500, 4096])
def test_decode_symbols_match_pallas(n):
    x = _textish(n, seed=12)
    blob = rans_ref.rans_encode(x.tobytes(), lanes=K)
    _, k, freqs, states, counts, words = tops.read_container(blob)
    stride = -(-n // k)
    l2 = bucket(int(counts.max()) + 1)
    w_cap = bucket(len(words))
    padded = np.zeros(w_cap, np.uint16)
    padded[:len(words)] = words
    bases = (np.cumsum(counts) - counts).astype(np.int32)
    rowsT = np.asarray(_rows16_fn(k, l2, w_cap)(
        jnp.asarray(padded), jnp.asarray(bases),
        jnp.asarray(counts.astype(np.int32)))).T
    cums = np.concatenate(([0], np.cumsum(freqs[:255]))).astype(np.int32)
    jsym = np.asarray(rans_pallas._decode_call(bucket(stride), k, k, l2)(
        jnp.asarray(rowsT), jnp.asarray(states, jnp.uint32),
        jnp.asarray(freqs.astype(np.int32).reshape(16, 16)),
        jnp.asarray(cums.reshape(16, 16)), n))
    rows = tops.word_rows(torch.from_numpy(words.astype(np.int32)),
                          torch.from_numpy(counts), l2)
    assert np.array_equal(rows.numpy(), rowsT)
    sym = rans_kernels.decode_symbols(
        torch.from_numpy(states.astype(np.uint32).view(np.int32)), rows,
        layout.lane_lengths_interleaved(n, k, stride, "cpu"),
        *tops.tables(freqs, "cpu"), n, stride)
    assert np.array_equal(sym.numpy(), jsym[:stride].reshape(-1)[:n])
    assert np.array_equal(sym.numpy(), x)


def test_single_symbol_lane_at_ragged_k_matches_pallas():
    """One symbol over K = 48 lanes (not a multiple of 32, so a partial
    warp on the card): its table entry is f = 16,383 beside one of 1, the
    largest f the encoder writes. The port's plain F and G against the
    interpret-mode Pallas decoder (K padded to 128 lanes there)."""
    k = 48
    x = np.full(48 * 40 + 7, 0x42, np.uint8)
    n = len(x)
    stride = -(-n // k)
    xt = torch.from_numpy(x)
    f = tops.static_freqs(xt)
    assert sorted(f[f > 0].tolist()) == [1, (1 << 14) - 1]
    tables = tops.tables(f, "cpu")
    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    ev, st = rans_kernels.encode_events(layout.pad2d_interleaved(xt, k, stride),
                                        lens, *tables)
    rows = tops.word_rows(*tops.lane_words(ev))
    sym = rans_kernels.decode_symbols(st, rows, lens, *tables, n, stride)
    assert np.array_equal(sym.numpy(), x)
    l2 = bucket(rows.shape[0])
    rows_p = np.zeros((l2, k), np.int32)
    rows_p[:rows.shape[0]] = rows.numpy()
    cums = tables[1].numpy()
    jsym = np.asarray(rans_pallas._decode_call(bucket(stride), k, 128, l2)(
        jnp.asarray(rows_p), jnp.asarray(i32_to_u32(st).numpy(), jnp.uint32),
        jnp.asarray(f.astype(np.int32).reshape(16, 16)),
        jnp.asarray(cums.reshape(16, 16)), n))
    assert np.array_equal(sym.numpy(), jsym[:stride].reshape(-1)[:n])


def test_table_entry_of_all_slots_matches_the_oracle():
    """A hand-made container whose table gives one symbol all 2^14 slots
    (f = 2^14, which the decoder's entry must hold: 15 bits), over random
    final states and words: the port decodes it as the oracle's decode
    loop does (every step that symbol, the state unchanged)."""
    rng = np.random.default_rng(15)
    k, n = 4, 4 * 50 - 3
    freqs = np.zeros(256, np.int64)
    freqs[0x77] = 1 << 14
    states = rng.integers(1 << 16, 1 << 32, k, dtype=np.uint64)
    counts = rng.integers(0, 6, k)
    words = rng.integers(0, 1 << 16, int(counts.sum()))
    blob = tops.assemble(n, k, freqs, states, counts, words)
    want = rans_ref.rans_decode(blob)
    assert want == b"\x77" * n
    assert ctt.decompress(blob, codec="rans", device="cpu") == want


def _identity(data, **opts):
    blob = ctt.compress(data, codec="rans", device="cpu", **opts)
    assert blob == rans_ref.rans_encode(data, **opts)
    jblob = jops.rans_encode_jax(data, **opts)
    assert blob == jblob
    assert ctt.decompress(jblob, codec="rans", device="cpu") == data
    assert rans_ref.rans_decode(blob) == data


@pytest.mark.parametrize("i", range(len(std_cases())))
def test_std_cases_match_oracle_and_jax(i):
    _identity(std_cases()[i])


@pytest.mark.parametrize("name", ["grammar.lsp", "fields.c"])
def test_corpus_files_match_oracle_and_jax(name):
    _identity(corpus_file(name))


def test_single_symbol_run_ragged_lanes_and_empty_input():
    # one symbol: its frequency is capped at 2^14 - 1; the renorm test
    # (st >> 18) >= f must not wrap
    _identity(b"\x42" * 2000, lanes=64)
    _identity(_textish(1001, seed=13).tobytes(), lanes=16)   # n % K != 0
    empty = ctt.compress(b"", device="cpu")
    assert empty == rans_ref.rans_encode(b"") and len(empty) == 5
    assert ctt.decompress(empty, device="cpu") == b""


def test_wide_count_table_at_the_header_layer():
    """A lane with more than 0xFFFF words switches the count table to u32
    (lane_desc bit 7). The plain step loop over 131k+ steps is too slow
    here, so the oracle's container of 200 KB at lanes=1 goes through the
    port's header layer both ways, and synthetic counts straddle the
    threshold (tests/test_torch_gpu.py codes such a lane on the card)."""
    data = np.random.default_rng(7).integers(0, 256, 200_000, np.uint8)
    blob = rans_ref.rans_encode(data.tobytes(), lanes=1)
    assert blob[4] & 0x80
    n, k, freqs, states, counts, words = tops.read_container(blob)
    assert (n, k) == (200_000, 1) and counts[0] == len(words) > 0xFFFF
    assert tops.assemble(n, k, freqs, states, counts, words) == blob
    for big in (0xFFFF, 0x10000):
        cnt = np.array([big, 3])
        w = np.arange(big + 3) % 65536
        b = tops.assemble(9, 2, freqs, np.array([1 << 16, 1 << 17]), cnt, w)
        assert bool(b[4] & 0x80) == (big > 0xFFFF)
        got = tops.read_container(b)
        assert got[:2] == (9, 2) and np.array_equal(got[4], cnt)
        assert np.array_equal(got[5], w) and np.array_equal(got[2], freqs)


def _blob():
    return rans_ref.rans_encode(_textish(700, seed=14).tobytes(), lanes=4)


@pytest.mark.parametrize("mangle,err", [
    (lambda b: b[:-3], CorruptContainerError),              # words cut short
    (lambda b: b[:4] + bytes([0x11]) + b[5:], CorruptContainerError),  # 2^17 lanes
    (lambda b: b[:3], CorruptContainerError),               # truncated header
    (lambda b: b[:5] + bytes([b[5] ^ 0x01]) + b[6:], ValueError),  # freq sum
])
def test_malformed_containers_raise(mangle, err):
    with pytest.raises(err):
        ctt.decompress(mangle(_blob()), device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    x2d = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((8,), 4, dtype=torch.int32)
    f, c = tops.tables(np.full(256, 64), "cpu")
    with pytest.raises(ValueError):
        rans_kernels.encode_events(x2d.to(torch.int32), lens, f, c)
    with pytest.raises(ValueError):
        rans_kernels.encode_events(x2d, lens, f[:128], c)
    with pytest.raises(ValueError):    # not a CPU tensor: no silent plain path
        rans_kernels.encode_events(x2d.to("meta"), lens.to("meta"),
                                   f.to("meta"), c.to("meta"))
    rows = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        rans_kernels.decode_symbols(torch.zeros(8, dtype=torch.int32), rows,
                                    lens, f, c, 33, 4)
    with pytest.raises(ValueError):
        rans_kernels.decode_symbols(torch.zeros(4, dtype=torch.int32), rows,
                                    lens, f, c, 32, 4)
