"""The port's host library entry points (native/ctrc.py, built from the
repository's native/ctrc.cpp): tests/test_native.py's cases, held to the
port's own oracles (reference/), and equal to the JAX package's loader."""

import numpy as np
import pytest

from conftest import std_cases

from cpprcoder_tpu import native as jnative
from cpprcoder_tpu_torch.core.bytesutil import CorruptContainerError
from cpprcoder_tpu_torch.models.cxmodel import rcx_params
from cpprcoder_tpu_torch.models.qmodel import rcq_params
from cpprcoder_tpu_torch.native import ctrc
from cpprcoder_tpu_torch.reference import rc_ref, rcq_ref, rcx_ref, slz4_ref


@pytest.fixture(autouse=True)
def _toolchain():
    """Decided in the test, not at import: the library needs g++."""
    if not ctrc.available():
        pytest.skip("no C++ toolchain")


@pytest.mark.parametrize("lanes", [1, 8])
def test_native_static_identity(lanes):
    for data in [c for c in std_cases() if c][:6]:
        blob = ctrc.static_encode(data, lanes)
        assert blob == rc_ref.static_encode(data, lanes=lanes)
        assert ctrc.static_decode(blob) == data


@pytest.mark.parametrize("lanes", [1, 8])
def test_native_adaptive_identity(lanes):
    for data in [c for c in std_cases() if c][:6]:
        blob = ctrc.adaptive_encode(data, lanes, 24, 16)
        assert blob == rc_ref.adaptive_encode(data, lanes=lanes, inc=24,
                                              limit_log2=16)
        assert ctrc.adaptive_decode(blob) == data


@pytest.mark.slow
def test_adaptive_stress_128mib():
    # reference parity: test_adaptive (test/main.cpp:1201-1237) round-trips
    # 128 MiB of incompressible random bytes
    rng = np.random.default_rng(7)
    big = rng.integers(0, 256, 128 << 20, dtype=np.uint8)
    blob = ctrc.adaptive_encode(big, 1024, 4, 18)
    assert ctrc.adaptive_decode(blob) == big.tobytes()
    assert len(blob) / len(big) < 1.01


def test_native_rcq_identity_and_roundtrip():
    rng = np.random.default_rng(11)
    for data in (b"hello world " * 200,
                 rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
                 b"\x00" * 3000):
        k, inc, cl = rcq_params(len(data))
        nat = ctrc.rcq_encode(data, k, inc, cl)
        assert nat == rcq_ref.rcq_encode(data, lanes=k, inc=inc,
                                         climit_log2=cl)
        assert ctrc.rcq_decode(nat) == data


def test_native_rcx_identity_and_roundtrip():
    rng = np.random.default_rng(13)
    for data in (b"the quick brown fox " * 150,
                 rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
                 b"\xff" * 3000):
        k, inc, cl, cb = rcx_params(len(data))
        nat = ctrc.rcx_encode(data, k, inc, cl, cb)
        assert nat == rcx_ref.rcx_encode(data, lanes=k, inc=inc,
                                         climit_log2=cl, cbits=cb)
        assert ctrc.rcx_decode(nat) == data
    # cbits sweep incl. order-0 degenerate and full-byte context
    data = b"abracadabra alakazam " * 120
    for cb in (0, 3, 8):
        k, inc, cl, _ = rcx_params(len(data))
        nat = ctrc.rcx_encode(data, k, inc, cl, cb)
        assert nat == rcx_ref.rcx_encode(data, lanes=k, inc=inc,
                                         climit_log2=cl, cbits=cb)
        assert ctrc.rcx_decode(nat) == data


def test_native_slz4_identity_and_roundtrip():
    rng = np.random.default_rng(9)
    cases = [b"a" * 20, b"abcabcabcabc" * 50,
             rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
             b"\x00" * 70000,
             rng.integers(0, 16, 9000, dtype=np.uint8).tobytes(),
             b"", b"x", b"xy" * 3]
    for data in cases:
        for sl in (12, 17):
            ref = slz4_ref.slz4_encode(data, seg_log2=sl)
            assert ctrc.slz4_encode(data, seg_log2=sl) == ref
            assert ctrc.slz4_decode(ref) == data


def test_native_slz4_rejects_corrupt():
    blob = bytearray(slz4_ref.slz4_encode(b"hello world " * 40, seg_log2=12))
    with pytest.raises(CorruptContainerError):
        ctrc.slz4_decode(bytes(blob[: len(blob) // 2]))  # truncated
    bad = bytes(blob[:4]) + b"\x30" + bytes(blob[5:])      # seg_log2 > 24
    with pytest.raises(CorruptContainerError):
        ctrc.slz4_decode(bad)


@pytest.mark.parametrize("name", ["static", "adaptive", "rcq", "rcx",
                                  "slz4"])
def test_native_decoders_reject_a_container_without_its_header(name):
    """Every decoder raises CorruptContainerError (a ValueError) on a
    container shorter than its u32 byte count, before the library reads
    it."""
    with pytest.raises(CorruptContainerError):
        getattr(ctrc, f"{name}_decode")(b"\x05\x00\x00")


def test_entry_points_equal_the_jax_packages_loader():
    """The same library source, bound twice: every entry point of the
    port's copy writes the JAX package loader's containers."""
    if not jnative.available():
        pytest.skip("the JAX package's loader does not build here")
    data = np.random.default_rng(15).integers(0, 40, 6000, np.uint8).tobytes()
    k, inc, cl = rcq_params(len(data))
    kx, incx, clx, cb = rcx_params(len(data))
    for mine, theirs in (
            (ctrc.static_encode(data, 8), jnative.static_encode(data, 8)),
            (ctrc.adaptive_encode(data, 8, 32, 18),
             jnative.adaptive_encode(data, 8, 32, 18)),
            (ctrc.rcq_encode(data, k, inc, cl),
             jnative.rcq_encode(data, k, inc, cl)),
            (ctrc.rcx_encode(data, kx, incx, clx, cb),
             jnative.rcx_encode(data, kx, incx, clx, cb)),
            (ctrc.slz4_encode(data), jnative.slz4_encode(data))):
        assert mine == theirs
