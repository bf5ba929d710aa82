"""CT-RCQ in the port, on the CPU (the plain versions of kernels D and E),
with exact equality throughout (integer codec: tolerance 0).

At the kernel interface: the plain D and E, reached through the
rcq_kernels wrappers on CPU tensors, against the interpret-mode Pallas
kernels rcq_pallas._encode_call / _decode_call at K=128. The Pallas grid
pads the steps to bucket(stride); the port runs exactly stride steps, so
the Pallas pad rows must be zero and the flush rows equal.

For the codec: containers equal rcq_ops.rcq_encode_jax and the oracle
rcq_ref.rcq_encode, and the port decodes the JAX package's containers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.core.bytesutil import ByteReader
from cpprcoder_tpu.models.qmodel import rcq_params
from cpprcoder_tpu.ops import rcq_ops as jops
from cpprcoder_tpu.ops import rcq_pallas
from cpprcoder_tpu.reference import rcq_ref
from cpprcoder_tpu.utils.shapes import bucket
from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError
from cpprcoder_tpu_torch.ops import compaction, layout, rcq_kernels
from cpprcoder_tpu_torch.ops import rcx_ops as tops

rcq_pallas._INTERPRET = True
K = 128
HEADER = 8   # u32 n, lane_desc, inc, climit_log2, qbits


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


@pytest.mark.parametrize("n", [1500, 4096])
def test_encode_events_match_pallas(n):
    x = _textish(n, seed=7)
    k, inc, cl = rcq_params(n, lanes=K)
    stride = -(-n // k)
    steps = bucket(stride)
    pad = np.zeros(steps * k, np.uint8)
    pad[:n] = x
    jev, jsizes, _ = rcq_pallas._encode_call(steps, k, k, inc, cl)(
        jnp.asarray(pad.reshape(steps, k)), n)
    jev = np.asarray(jev).view(np.int32)
    ev = rcq_kernels.encode_events(
        layout.pad2d_interleaved(torch.from_numpy(x), k, stride),
        layout.lane_lengths_interleaved(n, k, stride, "cpu"), inc, 1 << cl)
    assert ev.shape == (2 * stride + 2, k) and ev.dtype == torch.int32
    ev = ev.numpy()
    assert np.array_equal(ev[:2 * stride], jev[:2 * stride])
    assert not jev[2 * stride:2 * steps].any()
    assert np.array_equal(ev[2 * stride:], jev[2 * steps:])
    sizes = compaction.payload_layout_t(torch.from_numpy(ev))[3]
    assert np.array_equal(sizes.numpy(), np.asarray(jsizes))


@pytest.mark.parametrize("n", [1500, 4096])
def test_decode_symbols_match_pallas(n):
    x = _textish(n, seed=8)
    blob = rcq_ref.rcq_encode(x.tobytes(), lanes=K)
    k, inc, cl = rcq_params(n, lanes=K)
    r = ByteReader(blob, pos=HEADER)
    sizes = r.u16s(k).astype(np.int32)
    payload = r.rest()
    stride = -(-n // k)
    l4 = bucket(-(-int(sizes.max()) // 4) + 1)
    p_cap = bucket(len(payload))
    padded = np.zeros(p_cap, np.uint8)
    padded[:len(payload)] = payload
    rows_wT = jops._rows_fn(k, l4, p_cap)(jnp.asarray(padded),
                                          jnp.asarray(sizes)).T
    jsym = np.asarray(rcq_pallas._decode_call(
        bucket(stride), k, k, l4, inc, cl)(rows_wT, n))
    words = layout.word_rows(torch.from_numpy(payload.copy()),
                             torch.from_numpy(sizes), l4)
    assert np.array_equal(words.numpy(), np.asarray(rows_wT).view(np.int32))
    sym = rcq_kernels.decode_symbols(
        words, layout.lane_lengths_interleaved(n, k, stride, "cpu"), n, stride,
        inc, 1 << cl)
    assert np.array_equal(sym.numpy(), jsym[:stride].reshape(-1)[:n])
    assert np.array_equal(sym.numpy(), x)


def test_single_halving_matches_jax():
    """K*inc > climit: one halving leaves the total above climit (the
    oracle asserts there); CT-RCQ halves once all the same, where CT-RCX
    would halve again, and the port must follow the JAX package."""
    data = _textish(4096, seed=9).tobytes()
    opts = dict(lanes=128, inc=24, climit_log2=10)
    blob = ctt.compress(data, codec="rcq", device="cpu", **opts)
    assert blob == jops.rcq_encode_jax(data, **opts)
    assert ctt.decompress(blob, codec="rcq", device="cpu") == data
    # three halvings (the CT-RCX rule) give other tables, so other bytes
    k, stride = 128, 32
    args = (layout.pad2d_interleaved(torch.frombuffer(bytearray(data),
                                                    dtype=torch.uint8),
                                   k, stride),
            layout.lane_lengths_interleaved(4096, k, stride, "cpu"), 24, 1024,
            0, 0)
    assert not torch.equal(tops.encode_events_plain(*args, rounds=1),
                           tops.encode_events_plain(*args, rounds=3))


def _identity(data, **opts):
    blob = ctt.compress(data, codec="rcq", device="cpu", **opts)
    assert blob == rcq_ref.rcq_encode(data, **opts)
    jblob = jops.rcq_encode_jax(data, **opts)
    assert blob == jblob
    assert ctt.decompress(jblob, codec="rcq", device="cpu") == data
    assert rcq_ref.rcq_decode(blob) == data


@pytest.mark.parametrize("i", range(len(std_cases())))
def test_std_cases_match_oracle_and_jax(i):
    _identity(std_cases()[i])


@pytest.mark.parametrize("name", ["grammar.lsp", "fields.c"])
def test_corpus_files_match_oracle_and_jax(name):
    _identity(corpus_file(name))


def test_single_symbol_run_and_empty_input():
    data = b"\x42" * 2000
    blob = ctt.compress(data, codec="rcq", device="cpu", lanes=64)
    assert blob == rcq_ref.rcq_encode(data, lanes=64)
    assert ctt.decompress(blob, codec="rcq", device="cpu") == data
    empty = ctt.compress(b"", codec="rcq", device="cpu")
    assert empty == rcq_ref.rcq_encode(b"") and len(empty) == HEADER
    assert ctt.decompress(empty, codec="rcq", device="cpu") == b""


def _blob():
    return rcq_ref.rcq_encode(_textish(700, seed=10).tobytes())


@pytest.mark.parametrize("mangle", [
    lambda b: b[:7] + bytes([14]) + b[8:],   # qbits != 15
    lambda b: b[:-3],                        # size table claims more payload
    lambda b: b[:6],                         # truncated header
    lambda b: b[:4] + bytes([0x1F]) + b[5:],  # lane count 2^31
])
def test_malformed_containers_raise(mangle):
    with pytest.raises(CorruptContainerError):
        ctt.decompress(mangle(_blob()), codec="rcq", device="cpu")


def test_wrappers_reject_what_the_kernels_do_not_take():
    x2d = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((8,), 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        rcq_kernels.encode_events(x2d.to(torch.int32), lens, 24, 1 << 16)
    with pytest.raises(ValueError):
        rcq_kernels.encode_events(x2d, lens[:4], 24, 1 << 16)
    with pytest.raises(ValueError):    # not a CPU tensor: no silent plain path
        rcq_kernels.encode_events(x2d.to("meta"), lens.to("meta"), 24,
                                  1 << 16)
    with pytest.raises(ValueError):
        rcq_kernels.decode_symbols(torch.zeros((3, 8), dtype=torch.int32),
                                   lens, 33, 4, 24, 1 << 16)
