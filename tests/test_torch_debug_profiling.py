"""The port's shadow decode (debug.py) and phase counters
(utils/profiling.py): tests/test_debug_profiling.py's cases for the port,
on the CPU, and the port's phases against the JAX package's on the same
calls."""

import numpy as np
import pytest

from cpprcoder_tpu import debug as jdebug
from cpprcoder_tpu.codecs import get_codec as jget_codec
from cpprcoder_tpu.utils import profiling as jprofiling
from cpprcoder_tpu_torch import debug
from cpprcoder_tpu_torch.codecs import get_codec
from cpprcoder_tpu_torch.utils import profiling

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean():
    yield
    for d in (debug, jdebug):
        d.set_shadow(False)
    for p in (profiling, jprofiling):
        p.disable()
        p.reset()


def test_shadow_passes_on_correct_codec():
    debug.set_shadow(True)
    data = bytes(np.random.default_rng(0).integers(0, 256, 5000, np.uint8))
    c = get_codec("rcq")
    blob = c.encode(data, **CPU)
    assert c.decode(blob, **CPU) == data


def test_shadow_catches_divergence():
    debug.set_shadow(True)
    c = get_codec("rcq")
    good = c._encode(b"hello shadow world " * 50, backend="ref")

    class Broken:
        name = "rcq"
        _decode = staticmethod(c._decode)

    # one payload byte corrupted (the container's last)
    bad = good[:-1] + bytes([good[-1] ^ 0xFF])
    for opts in ({"backend": "ref", **CPU}, CPU):
        with pytest.raises(debug.DivergenceError) as ei:
            debug.check_roundtrip(Broken(), b"hello shadow world " * 50, bad,
                                  opts)
        assert ei.value.total == 19 * 50


def test_shadow_catches_length_divergence():
    debug.set_shadow(True)
    c = get_codec("rcq")
    blob = c._encode(b"abc" * 100, backend="ref")
    with pytest.raises(debug.DivergenceError, match="length 300 != 303"):
        debug.check_roundtrip(c, b"abc" * 101, blob, {"backend": "ref", **CPU})


def test_shadow_via_codec_encode_hook():
    debug.set_shadow(True)
    c = get_codec("adaptive_range")
    data = b"the hook should run the shadow decode transparently" * 20
    blob = c.encode(data, **CPU)  # shadow-decoded by the oracle
    assert c.decode(blob, backend="ref") == data


def test_shadow_backend_is_independent():
    """A "cuda" or "torch" encode (or one the device picked) is decoded by
    the oracle; a "ref" or "native" one by the port's own path on the
    caller's device, the card unless it said otherwise (never the CPU
    quietly: with no device and no card that decode raises)."""
    for opts in ({}, CPU, {"backend": "cuda"}, {"backend": "torch", **CPU}):
        assert debug.shadow_options(opts) == {"backend": "ref"}
    for b in ("ref", "native"):
        assert debug.shadow_options({"backend": b}) == {"backend": None,
                                                        "device": None}
        assert debug.shadow_options({"backend": b, **CPU}) == {
            "backend": None, "device": "cpu"}
    seen = []

    class Spy:
        name = "spy"

        @staticmethod
        def _decode(blob, backend=None, device=None):
            seen.append((backend, device))
            return blob

    debug.check_roundtrip(Spy(), b"xy", b"xy", {"backend": "ref"})
    debug.check_roundtrip(Spy(), b"xy", b"xy", {})
    assert seen == [(None, None), ("ref", None)]


def test_shadow_keeps_a_decodes_type_error():
    """The signature check, not a caught TypeError, decides whether the
    decode takes a backend: one raised inside the decode propagates."""

    class Raises:
        name = "raises"

        @staticmethod
        def _decode(blob, backend=None, device=None):
            raise TypeError("inside the decode")

    with pytest.raises(TypeError, match="inside the decode"):
        debug.check_roundtrip(Raises(), b"a", b"a", CPU)

    class NoBackend:
        name = "plain"

        @staticmethod
        def _decode(blob):
            return blob

    debug.check_roundtrip(NoBackend(), b"ab", b"ab", {"backend": "ref"})


def test_profiling_counters_accumulate():
    profiling.enable()
    profiling.reset()
    c = get_codec("rcq")
    data = bytes(np.random.default_rng(1).integers(0, 256, 4096, np.uint8))
    blob = c.encode(data, **CPU)
    assert c.decode(blob, **CPU) == data
    rep = profiling.report()
    for name in ("enc.scan", "enc.materialize", "enc.assemble",
                 "dec.rows", "dec.scan", "dec.fetch"):
        assert name in rep, f"missing phase {name}: {sorted(rep)}"
        assert rep[name]["calls"] >= 1
        assert rep[name]["wall_s"] > 0
    assert rep["enc.scan"]["bytes"] == 4096
    table = profiling.format_report()
    assert "enc.scan" in table and "| phase |" in table


def test_profiling_disabled_is_noop():
    profiling.disable()
    profiling.reset()
    c = get_codec("rcq")
    c.encode(b"x" * 500, backend="ref")
    c.encode(b"x" * 500, **CPU)
    assert profiling.report() == {}
    with profiling.phase("never", 10, device="cpu") as rec:
        rec.nbytes = 5
    assert profiling.report() == {}


def test_profiling_add_and_mbps():
    profiling.enable()
    profiling.reset()
    profiling.add("kernel.slope", 0.5, 50_000_000)
    rep = profiling.report()["kernel.slope"]
    assert rep["MBps"] == pytest.approx(100.0)


@pytest.mark.parametrize("codec", ["rcq", "rcx", "adaptive_range"])
def test_phase_names_and_bytes_match_the_jax_package(codec):
    """The same call (encode, then decode, of one input) counts the same
    phases with the same calls and bytes in both packages."""
    data = bytes(np.random.default_rng(2).integers(0, 64, 3000, np.uint8))
    reports = []
    for prof, get, opts in ((jprofiling, jget_codec, {"backend": "jax"}),
                            (profiling, get_codec, CPU)):
        prof.enable()
        prof.reset()
        c = get(codec)
        assert c.decode(c.encode(data, **opts), **opts) == data
        reports.append({name: (row["calls"], row["bytes"])
                        for name, row in prof.report().items()})
        prof.disable()
    assert reports[0] == reports[1]
    assert "enc.scan" in reports[1]


def test_device_trace_writes_a_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")):
        get_codec("rcq").encode(b"trace me " * 40, **CPU)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
