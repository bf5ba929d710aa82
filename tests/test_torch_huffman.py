"""CT-HUF1 (canonical Huffman) in the port, on the CPU (the plain versions of
kernels H and I), with exact equality throughout (integer codec:
tolerance 0).

At the kernel interface: the plain H and I, reached through the
huffman_kernels wrappers on CPU tensors, against the interpret-mode Pallas
kernels huffman_pallas._encode_call / _decode_call, at K=128 and at K < 128
(grammar.lsp, K=2, where Pallas pads the lanes to 128) and on skewed input
with codes near the 15-bit limit. The Pallas grid pads the steps to
bucket(stride) and the lanes to max(K, 128); the port runs exactly stride
steps and K lanes, so the Pallas pad slots must emit nothing.

For the codec: containers equal huffman_ops.huffman_encode_jax and the
JAX package's oracle huffman_ref.huffman_encode, and the port decodes the
JAX package's containers."""

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


@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_encode_events_match_pallas(case):
    x, n, k, stride = _inputs(case)
    steps = bucket(stride)
    xt = torch.from_numpy(x.copy())
    lengths, tab = tops.encoder_table(xt)
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

    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    ev, flush, bits = huffman_kernels.encode_events(
        layout.pad2d_interleaved(xt, k, stride), lens, tab)
    assert ev.shape == (stride, k) and ev.dtype == torch.int32
    assert np.array_equal(bits.numpy(), np.asarray(jbits))
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
        huffman_kernels.encode_events(x2d.to(torch.int32), lens, tab)
    with pytest.raises(ValueError):
        huffman_kernels.encode_events(x2d, lens, tab[:, :128].contiguous())
    with pytest.raises(ValueError):    # not a CPU tensor: no silent plain path
        huffman_kernels.encode_events(x2d.to("meta"), lens.to("meta"),
                                      tab.to("meta"))
    rows = torch.zeros((3, 8), dtype=torch.int32)
    t16 = torch.zeros(16, dtype=torch.int32)
    perm = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError):
        huffman_kernels.decode_symbols(rows, lens, t16, t16, perm, 33, 4)
    with pytest.raises(ValueError):
        huffman_kernels.decode_symbols(rows, lens, t16[:15], t16, perm, 32, 4)
