"""CT-HUF1 (canonical Huffman) in the port, on the CPU (the plain versions of
kernels H and I), with exact equality throughout (integer codec:
tolerance 0).

At the kernel interface: the plain H and I, reached through the
huffman_kernels wrappers on CPU tensors, against the interpret-mode Pallas
kernels huffman_pallas._encode_call / _decode_call, at K=128 and at K < 128
(grammar.lsp, K=2, where Pallas pads the lanes to 128) and on skewed input
with codes near the 15-bit limit. The Pallas grid pads the steps to
bucket(stride) and the lanes to max(K, 128); the port runs exactly stride
steps and K lanes, so the Pallas pad slots must emit nothing. H's step
loop (`encode_events_plain`, half of its plain version) is held against
the Pallas events, and its wrapper (payload, word counts, bit counts)
against the Pallas call's compacted words; kernel H's launch geometry,
which its wrapper computes, is checked to cover every step of every lane.

For the codec: containers equal huffman_ops.huffman_encode_jax and the
JAX package's oracle huffman_ref.huffman_encode, and the port decodes the
JAX package's containers."""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.ops import huffman_ops as jops
from cpprcoder_tpu.ops import huffman_pallas
from cpprcoder_tpu.reference import huffman_ref
from cpprcoder_tpu.utils.shapes import bucket
from cpprcoder_tpu_torch.config import pick_lanes
from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError
from cpprcoder_tpu_torch.models.huffman import build_decoder_lut
from cpprcoder_tpu_torch.ops import huffman_kernels, layout, rans_ops
from cpprcoder_tpu_torch.ops import huffman_ops as tops

huffman_pallas._INTERPRET = True


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


def _skewed(n, seed):
    """Long codes, near the 15-bit limit (test_huffman_pallas.py's case)."""
    rng = np.random.default_rng(seed)
    probs = np.array([2.0 ** -min(i // 16 + 1, 14) for i in range(256)])
    return rng.choice(256, n, p=probs / probs.sum()).astype(np.uint8)


# (input, lanes): K=128 at n 1,500 and 4,096; grammar.lsp at its default
# K=2 (Pallas pads to 128 lanes); the skewed long-code case at K=64
KERNEL_CASES = {
    "k128-n1500": (lambda: _textish(1500, 11), 128),
    "k128-n4096": (lambda: _textish(4096, 12), 128),
    "grammar-k2": (lambda: np.frombuffer(corpus_file("grammar.lsp"),
                                         np.uint8), None),
    "skewed-k64": (lambda: _skewed(3000, 2), 64),
}


def _inputs(case):
    make, k = KERNEL_CASES[case]
    x = make()
    n = len(x)
    k = k or pick_lanes(n)
    return x, n, k, -(-n // k)


@lru_cache(maxsize=None)
def _pallas_encode(case):
    """The interpret-mode Pallas encode call at `case` -> (its words [K,
    steps+1], its emit flags [K, steps+1] (the last slot the flush), its bit
    counts): lane-major slots."""
    x, n, k, stride = _inputs(case)
    steps = bucket(stride)
    _, tab = tops.encoder_table(torch.from_numpy(x.copy()))
    jtab = np.zeros((8, 256), np.int32)
    jtab[0] = tab[0].numpy()
    jtab[1] = tab[1].numpy() & 255
    jtab[2] = tab[1].numpy() >> 8
    jwords, jpstart, jn, jbits = huffman_pallas._encode_call(
        steps, k, max(k, huffman_pallas.MIN_LANES))(
        jnp.asarray(jops._pad2d(x, steps, k)), jnp.uint32(n),
        jnp.asarray(jtab))
    jpstart = np.asarray(jpstart)
    jemit = (np.append(jpstart[1:], int(jn)) > jpstart).reshape(k, steps + 1)
    jwords = np.asarray(jwords).astype(np.int64).reshape(k, steps + 1)
    return jwords, jemit, np.asarray(jbits)


def _port_inputs(case):
    x, n, k, stride = _inputs(case)
    xt = torch.from_numpy(x.copy())
    _, tab = tops.encoder_table(xt)
    return (layout.pad2d_interleaved(xt, k, stride),
            layout.lane_lengths_interleaved(n, k, stride, "cpu"), tab)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_encode_events_match_pallas(case):
    x, n, k, stride = _inputs(case)
    steps = bucket(stride)
    jwords, jemit, jbits = _pallas_encode(case)
    x2d, lens, tab = _port_inputs(case)
    ev, flush, bits = tops.encode_events_plain(x2d, lens, tab)
    assert ev.shape == (stride, k) and ev.dtype == torch.int32
    assert np.array_equal(bits.numpy(), jbits)
    # every active slot: the same emit bit and word; the port's inactive
    # slots are 0 and the Pallas ones (pad steps included) emit nothing
    ev = ev.numpy().T                                  # lane-major [K, stride]
    active = np.arange(stride)[None, :] < lens.numpy()[:, None]
    assert np.array_equal(ev[active] >> 16, jemit[:, :stride][active])
    assert np.array_equal(ev[active] & 0xFFFF, jwords[:, :stride][active])
    assert not ev[~active].any()
    assert not jemit[:, :stride][~active].any() and not jemit[:, stride:steps].any()
    flush = flush.numpy()
    assert np.array_equal(flush >> 16, jemit[:, steps])
    assert np.array_equal(flush & 0xFFFF, np.where(jemit[:, steps],
                                                   jwords[:, steps], 0))
    # the compacted word stream, lane after lane
    words, counts = tops.lane_stream(torch.from_numpy(ev.T.copy()),
                                     torch.from_numpy(flush))
    assert np.array_equal(words.numpy(), jwords[jemit])
    assert np.array_equal(counts.numpy(), jemit.sum(axis=1))


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_encode_stream_match_pallas(case):
    """Kernel H's wrapper on CPU tensors (its plain version) against the
    Pallas call: the bit counts, the payload's u16 words (the Pallas call's
    emitted words, lane after lane, then zeros to the buffer's end) and the
    word counts."""
    _, _, k, stride = _inputs(case)
    jwords, jemit, jbits = _pallas_encode(case)
    payload, counts, bits = huffman_kernels.encode_stream(*_port_inputs(case))
    assert payload.dtype == counts.dtype == bits.dtype == torch.int32
    assert payload.shape == (tops.payload_words(stride, k),)
    assert np.array_equal(bits.numpy(), jbits)
    assert np.array_equal(counts.numpy(), jemit.sum(axis=1))
    w16 = payload.numpy().view(np.uint16)
    p = int(jemit.sum())
    assert np.array_equal(w16[:p], jwords[jemit])
    assert not w16[p:].any()
    assert np.array_equal(tops.stream_words(payload, counts).numpy(),
                          jwords[jemit])


@pytest.mark.parametrize("k", [1, 2, 3, 64, 65536])
def test_encode_geometry_covers_every_step(k):
    """Kernel H's launch geometry, as its wrapper computes it, at a stride
    that is not a multiple of CHUNK: each (chunk, lane) has one thread of
    one block; a block's chunks lie in its tile of TILE bytes; the tiles
    cover the stride; the scan blocks cover the lanes. K = 3 is refused
    (not a power of two)."""
    c, stride = huffman_kernels.CHUNK, 3 * huffman_kernels.CHUNK + 5
    if k == 3:
        with pytest.raises(ValueError, match="power of two"):
            huffman_kernels.encode_geometry(stride, k)
        return
    g = huffman_kernels.encode_geometry(stride, k)
    kb, steps = g.lanes_a_block, g.steps_a_tile
    assert kb * steps == huffman_kernels.TILE and steps % c == 0
    assert k % kb == 0 and (kb == k or kb % 16 == 0)
    assert (g.chunks - 1) * c < stride <= g.chunks * c
    assert (g.tiles - 1) * steps < stride <= g.tiles * steps
    assert (g.scan_blocks - 1) * g.scan_lanes < k <= g.scan_blocks * g.scan_lanes
    assert g.scan_lanes == 1 or g.scan_lanes * g.chunks <= huffman_kernels.SCAN_ROUND
    # the thread mapping: thread t of block (r, grp) codes chunk
    # (r * steps + (t // kb) * c) // c of lane grp * kb + t % kb
    t = np.arange(huffman_kernels.TILE // c)
    r, grp = np.meshgrid(np.arange(g.tiles), np.arange(k // kb), indexing="ij")
    s0 = (r[..., None] * steps + (t // kb) * c).ravel()
    lane = (grp[..., None] * kb + t % kb).ravel()
    assert ((t // kb) * c + c <= steps).all()
    keep = s0 < stride
    hits = np.zeros((g.chunks, k), np.int64)
    np.add.at(hits, (s0[keep] // c, lane[keep]), 1)
    assert (hits == 1).all()


def test_payload_bound_holds_for_15_bit_codes():
    """Every symbol a 15-bit code (the most the format has) and every step
    active: the word counts fit the wrapper's payload buffer, at strides
    around multiples of 16 and at K = 1, 4 and 64."""
    tab = torch.zeros((2, 256), dtype=torch.int32)
    tab[0] = 15
    tab[1] = torch.arange(256) * 97 % (1 << 15)
    rng = np.random.default_rng(16)
    for k in (1, 4, 64):
        for stride in (1, 15, 16, 17, 33):
            x2d = torch.from_numpy(rng.integers(0, 256, (stride, k),
                                                dtype=np.uint8))
            lens = torch.full((k,), stride, dtype=torch.int32)
            payload, counts, bits = huffman_kernels.encode_stream(x2d, lens,
                                                                  tab)
            assert (bits == 15 * stride).all()
            assert 2 * payload.numel() >= int(counts.sum()) \
                == k * -(-15 * stride // 16)
            assert payload.numel() == tops.payload_words(stride, k)


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_decode_symbols_match_pallas(case):
    x, n, k, stride = _inputs(case)
    blob = huffman_ref.huffman_encode(x.tobytes(), lanes=k)
    _, k2, lengths, _, counts, words = tops.read_container(blob)
    assert k2 == k
    l2 = bucket(int(counts.max()) + 1)
    rows = rans_ops.word_rows(torch.from_numpy(words.astype(np.int32)),
                              torch.from_numpy(counts), l2)
    limits, bases, perm = tops.decoder_tables(lengths, "cpu")
    lim16 = limits.numpy().copy()
    lim16[0] = 0
    bas16 = bases.numpy().copy()
    bas16[0] = 0
    perm8 = np.zeros((8, 256), np.int32)
    perm8[0] = perm.numpy()
    kp = max(k, huffman_pallas.MIN_LANES)
    jsym = np.asarray(huffman_pallas._decode_call(bucket(stride), k, kp, l2)(
        jnp.asarray(rows.numpy()), jnp.asarray(lim16), jnp.asarray(bas16),
        jnp.asarray(perm8), n))
    sym = huffman_kernels.decode_symbols(
        rows, layout.lane_lengths_interleaved(n, k, stride, "cpu"),
        limits, bases, perm, n, stride)
    assert np.array_equal(sym.numpy(), jsym[:stride].reshape(-1)[:n])
    assert np.array_equal(sym.numpy(), x)


def _identity(data, **opts):
    blob = ctt.compress(data, codec="huffman", device="cpu", **opts)
    assert blob == huffman_ref.huffman_encode(data, **opts)
    jblob = jops.huffman_encode_jax(data, **opts)
    assert blob == jblob
    assert ctt.decompress(jblob, codec="huffman", device="cpu") == data
    assert huffman_ref.huffman_decode(blob) == data


@pytest.mark.parametrize("lanes", [1, 8, None])
@pytest.mark.parametrize("i", range(len(std_cases())))
def test_std_cases_match_oracle_and_jax(i, lanes):
    _identity(std_cases()[i], **({"lanes": lanes} if lanes else {}))


@pytest.mark.parametrize("name", ["grammar.lsp", "fields.c"])
def test_corpus_files_match_oracle_and_jax(name):
    _identity(corpus_file(name))


def test_single_symbol_and_empty_input():
    # one symbol: a single code of length 1 whose bits are all 0
    _identity(b"\x42" * 2001, lanes=64)
    empty = ctt.compress(b"", codec="huffman", device="cpu")
    assert empty == huffman_ref.huffman_encode(b"") and len(empty) == 5
    assert ctt.decompress(empty, codec="huffman", device="cpu") == b""


def test_unmatched_windows_have_one_defined_decode():
    """An incomplete code (here two codes, lengths 2 and 3, as a corrupt
    container may carry) leaves windows that no code matches. On random
    word rows the plain I decodes those as perm[0] and consumes 16 bits
    (NO_CODE), and every other window as the oracle's LUT says: checked
    against a scalar walk over build_decoder_lut."""
    rng = np.random.default_rng(5)
    lengths = np.zeros(256, np.uint8)
    lengths[[5, 9]] = [2, 3]
    lut = build_decoder_lut(lengths)
    limits, bases, perm = tops.decoder_tables(lengths, "cpu")
    k, stride, l2 = 3, 40, 7
    rows = torch.from_numpy(rng.integers(0, 1 << 16, (l2, k), dtype=np.int32))
    lens = torch.tensor([40, 39, 0], dtype=torch.int32)
    n = k * 39 + 1
    sym = huffman_kernels.decode_symbols(rows, lens, limits, bases, perm, n,
                                         stride)
    unmatched = 0
    for lane in range(k):
        win = nb = cur = 0
        for j in range(int(lens[lane])):
            if nb <= 16:
                win |= (int(rows[cur, lane]) if cur < l2 else 0) << nb
                nb, cur = nb + 16, cur + 1
            v = int(lut[win & 0x7FFF])
            l, s = (v >> 8, v & 0xFF) if v >> 8 else (tops.NO_CODE, 5)
            unmatched += l == tops.NO_CODE
            assert int(sym[j * k + lane]) == s
            win, nb = win >> l, nb - l
    assert unmatched > 0


def test_truncated_containers_raise():
    blob = huffman_ref.huffman_encode(_textish(700, 14).tobytes(), lanes=4)
    for cut in (blob[:-3], blob[:3], blob[:100]):
        with pytest.raises(CorruptContainerError):
            ctt.decompress(cut, codec="huffman", device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    x2d = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((8,), 4, dtype=torch.int32)
    tab = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_kernels.encode_stream(x2d.to(torch.int32), lens, tab)
    with pytest.raises(ValueError):
        huffman_kernels.encode_stream(x2d, lens, tab[:, :128].contiguous())
    with pytest.raises(ValueError):    # not a CPU tensor: no silent plain path
        huffman_kernels.encode_stream(x2d.to("meta"), lens.to("meta"),
                                      tab.to("meta"))
    with pytest.raises(ValueError, match="power of two"):   # K = 6
        huffman_kernels.encode_stream(torch.zeros((4, 6), dtype=torch.uint8),
                                      torch.full((6,), 4, dtype=torch.int32),
                                      tab)
    with pytest.raises(ValueError):    # a lane length a lane short
        huffman_kernels.encode_stream(x2d, lens[:7], tab)
    rows = torch.zeros((3, 8), dtype=torch.int32)
    t16 = torch.zeros(16, dtype=torch.int32)
    perm = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_kernels.decode_symbols(rows, lens, t16, t16, perm, 33, 4)
    with pytest.raises(ValueError):
        huffman_kernels.decode_symbols(rows, lens, t16[:15], t16, perm, 32, 4)
