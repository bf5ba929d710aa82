"""CT-RC1 (static_range) and CT-RC2 (adaptive_range) in the port, on the
CPU (the plain versions of kernels J and L, and kernel B's), with exact
equality throughout (integer codec: tolerance 0).

The same seeded inputs go through the JAX package's
range_ops.static_encode_jax / adaptive_encode_jax (XLA scans on the CPU,
no Pallas kernel) and through the port's `backend="torch"`: the containers
must be byte-identical, equal to the oracle (the port's copy of
reference/rc_ref.py), and decode on both sides."""

import numpy as np
import pytest
import torch

from conftest import corpus_file

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.ops import range_ops as jops
from cpprcoder_tpu.reference import rc_ref as jref
from cpprcoder_tpu_torch.config import adaptive_params_for
from cpprcoder_tpu_torch.ops import expand, layout, range_kernels, range_ops
from cpprcoder_tpu_torch.reference import rc_ref as tref


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(1, 9), dtype=np.uint8))
             for _ in range(200)]
    out = b" ".join(words[i] for i in rng.integers(0, 200, n // 3))
    return out[:n]


def _runs(n, seed):
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 256))]) * int(rng.integers(1, 300))
    return bytes(out[:n])


CASES = {
    "grammar.lsp": lambda: corpus_file("grammar.lsp"),
    "text 16 KB": lambda: _text(16_000, 1),
    "runs": lambda: _runs(6000, 2),
    "one repeated byte": lambda: b"\x42" * 5000,
    "n = 0": lambda: b"",
    "n = 1": lambda: b"\x07",
    "n not a multiple of K": lambda: _text(8 * 301 + 5, 3),
}
# lanes for each case (None: pick_lanes), so that no plain loop runs more
# than a few thousand steps
LANES = {"grammar.lsp": None, "text 16 KB": 32, "runs": 8,
         "one repeated byte": 8, "n = 0": None, "n = 1": None,
         "n not a multiple of K": 8}


@pytest.mark.parametrize("case", list(CASES))
def test_static_range_matches_jax_and_oracle(case):
    data = CASES[case]()
    lanes = LANES[case]
    blob = ctt.compress(data, codec="static_range", device="cpu", lanes=lanes)
    assert blob == jops.static_encode_jax(data, lanes=lanes)
    assert blob == tref.static_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="static_range", device="cpu") == data
    assert jops.static_decode_jax(blob) == data


@pytest.mark.parametrize("case", list(CASES))
def test_adaptive_range_matches_jax_and_oracle(case):
    data = CASES[case]()
    lanes = LANES[case]
    blob = ctt.compress(data, codec="adaptive_range", device="cpu",
                        lanes=lanes)
    assert blob == jops.adaptive_encode_jax(data, lanes=lanes)
    assert blob == tref.adaptive_encode(data, lanes=lanes)
    assert ctt.decompress(blob, codec="adaptive_range", device="cpu") == data
    assert jops.adaptive_decode_jax(blob) == data


@pytest.mark.parametrize("lanes,limit_log2", [(1, 16), (8, 16), (8, 18),
                                              (1024, None), (1024, 16)])
def test_adaptive_lanes_and_limits(lanes, limit_log2):
    """lanes 1, 8 and 1,024 (limit_log2 17 by adaptive_params_for: three
    shift_low slots a step), limit_log2 16 and 18; n not a multiple of K,
    so the last step has inactive lanes."""
    data = _text(2000 if lanes < 1024 else 1024 * 9 + 77, lanes)
    if lanes == 1024:
        assert adaptive_params_for(1024) == (24, 17)
    blob = ctt.compress(data, codec="adaptive_range", device="cpu",
                        lanes=lanes, limit_log2=limit_log2)
    assert blob == jops.adaptive_encode_jax(data, lanes=lanes,
                                            limit_log2=limit_log2)
    assert blob == tref.adaptive_encode(data, lanes=lanes,
                                        limit_log2=limit_log2)
    assert ctt.decompress(blob, codec="adaptive_range", device="cpu") == data


def test_three_slot_events_and_rescale():
    """At limit_log2 17 a step has three event rows, and the table rescales
    (total >= 2^17 after 2^17 / (24 * 1024) steps): the plain J writes
    [3*stride + 2, K], and kernel B's plain version turns that grid into
    the oracle's payload. Zipf-distributed bytes keep rare symbols at
    f = 1 while the total is near 2^17, so some lanes take the third
    slot."""
    k, n = 1024, 1024 * 12 + 5
    rng = np.random.default_rng(1)
    data = np.minimum(rng.zipf(1.3, n) - 1, 255).astype(np.uint8).tobytes()
    stride = -(-n // k)
    x = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    lens = layout.lane_lengths_interleaved(n, k, stride, "cpu")
    ev = range_kernels.encode_events(layout.pad2d_interleaved(x, k, stride),
                                     lens, None, 24, 17)
    assert ev.shape == (3 * stride + 2, k) and ev.dtype == torch.int32
    assert ev[2:3 * stride:3].any()   # the third slot of some step
    rows, sizes = expand.materialize_rows(ev)
    blob = jref.adaptive_encode(data, lanes=k)
    want = layout.assemble(
        lambda wide: range_ops.adaptive_header(n, k, wide, 24, 17),
        rows.numpy(), sizes.numpy())
    assert want == blob
    words = layout.decode_words(rows, sizes)
    out = range_kernels.decode_symbols(words, lens, n, stride, None, 24, 17)
    assert out.numpy().tobytes() == data


def test_port_decodes_the_oracles_containers():
    data = _text(3000, 5)
    for lanes in (2, 8, 32):
        assert ctt.decompress(jref.static_encode(data, lanes=lanes),
                              codec="static_range", device="cpu") == data
        assert ctt.decompress(jref.adaptive_encode(data, lanes=lanes),
                              codec="adaptive_range", device="cpu") == data


def test_lanes_zero_and_bad_lanes():
    """lanes=0 is the default lane count, as the oracle's `lanes or
    pick_lanes(n)`; a lane count that is not a power of two is refused."""
    data = _text(3000, 6)
    for codec, ref in (("static_range", tref.static_encode),
                       ("adaptive_range", tref.adaptive_encode)):
        assert ctt.compress(data, codec=codec, device="cpu", lanes=0) \
            == ref(data) == ctt.compress(data, codec=codec, backend="ref",
                                         lanes=0)
        with pytest.raises(ValueError, match="power of two"):
            ctt.compress(data, codec=codec, device="cpu", lanes=3)


def test_container_functions_need_a_device():
    data = b"explicit device " * 20
    for enc, dec in ((range_ops.static_encode, range_ops.static_decode),
                     (range_ops.adaptive_encode, range_ops.adaptive_decode)):
        with pytest.raises(TypeError, match="device"):
            enc(data)
        blob = enc(data, device="cpu")
        with pytest.raises(TypeError, match="device"):
            dec(blob)
        assert dec(blob, device="cpu") == data


def test_wrappers_check_their_arguments():
    x2d = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((8,), 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="freqs"):
        range_kernels.encode_events(x2d, lens, torch.ones(255, dtype=torch.int32),
                                    0, 16)
    with pytest.raises(ValueError, match="limit_log2"):
        range_kernels.encode_events(x2d, lens, None, 24, 40)
    with pytest.raises(ValueError, match="uint8"):
        range_kernels.encode_events(x2d.to(torch.int32), lens, None, 24, 16)
    words = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="does not fit"):
        range_kernels.decode_symbols(words, lens, 33, 4, None, 24, 16)
