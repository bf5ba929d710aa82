"""Public API of the port: the registry, explicit devices and backends, and
that the package imports without jax and without nvcc."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu_torch.codecs import base

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cpprcoder_tpu_torch"


def _run(code, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


IDS = {"static_range": 0, "adaptive_range": 1, "rans": 2, "huffman": 3,
       "blocksort": 4, "mtf": 5, "slz4": 6, "ase": 7, "mtf1": 8, "pipeline": 9,
       "stream": 10, "adaptive_o1": 11, "rle0": 12, "adaptive_rans": 13,
       "rcq": 14, "rcx": 15}


def test_registry():
    assert ctt.list_codecs() == sorted(IDS)
    for name, cid in IDS.items():
        c = ctt.get_codec(name)
        assert (c.name, c.codec_id) == (name, cid)
        assert ctt.get_codec_by_id(cid) is c
    # adaptive_rans (CT-ANS2, id 13), the last codec ported, resolves by
    # name and by id and round-trips on the CPU
    assert ctt.get_codec_by_id(13) is ctt.get_codec("adaptive_rans")
    blob = ctt.compress(b"abc" * 40, codec="adaptive_rans", device="cpu")
    assert ctt.decompress(blob, codec="adaptive_rans",
                          device="cpu") == b"abc" * 40
    with pytest.raises(KeyError, match="unknown codec"):
        ctt.get_codec("nope")
    with pytest.raises(KeyError, match="unknown codec"):
        ctt.compress(b"abc", codec="adaptive_ranz")
    with pytest.raises(KeyError, match="unknown codec id"):
        ctt.get_codec_by_id(99)


def test_ids_and_names_are_the_jax_packages():
    """Every ported codec has its name and id in the JAX package, and
    every codec of the JAX package is ported."""
    import cpprcoder_tpu

    assert sorted(cpprcoder_tpu.list_codecs()) == sorted(IDS)
    for name in cpprcoder_tpu.list_codecs():
        assert IDS[name] == cpprcoder_tpu.get_codec(name).codec_id


@pytest.mark.parametrize("codec", ["huffman", "rans", "rcq", "rcx", "ase",
                                   "adaptive_o1"])
def test_lanes_must_be_a_power_of_two(codec):
    """A container stores log2(K) and its decoder reads back 1 << that, so
    lanes=3 would write a container that does not decode (the JAX package's
    oracles write one): every port codec refuses it, on every backend.
    lanes=0 is refused by rcq and rcx, whose oracles fail there too; rans
    and huffman read it as the default (test below)."""
    data = bytes(range(256)) * 4
    refused = (3, 6, -4) + ((0,) if codec in ("rcq", "rcx") else ())
    for opts in ({"device": "cpu"}, {"backend": "ref"}, {}):
        for lanes in refused:
            with pytest.raises(ValueError, match="power of two"):
                ctt.compress(data, codec=codec, lanes=lanes, **opts)
    blob = ctt.compress(data, codec=codec, device="cpu", lanes=4)
    assert ctt.decompress(blob, codec=codec, device="cpu") == data


@pytest.mark.parametrize("codec", ["huffman", "rans", "rcq", "rcx"])
def test_lanes_zero_as_in_the_oracle(codec):
    """rans and huffman take lanes=0 for the default lane count, as their
    oracles' `lanes or pick_lanes(n)` does: on fields.c the containers are
    the oracles' 7,194 (rans) and 7,179 (huffman) bytes, equal to
    lanes=None, on both backends. The rcq and rcx oracles fail at lanes=0
    (a division by the lane count), and the port refuses it."""
    import cpprcoder_tpu

    data = (ROOT / "data" / "fields.c").read_bytes()
    if codec in ("rcq", "rcx"):
        with pytest.raises(ZeroDivisionError):
            cpprcoder_tpu.compress(data, codec=codec, backend="ref", lanes=0)
        with pytest.raises(ValueError, match="power of two"):
            ctt.compress(data, codec=codec, device="cpu", lanes=0)
        return
    want = cpprcoder_tpu.compress(data, codec=codec, backend="ref", lanes=0)
    assert len(want) == {"rans": 7194, "huffman": 7179}[codec]
    for opts in ({"device": "cpu"}, {"backend": "ref"}):
        blob = ctt.compress(data, codec=codec, lanes=0, **opts)
        assert blob == want == ctt.compress(data, codec=codec, **opts)
    assert ctt.decompress(want, codec=codec, device="cpu") == data


@pytest.mark.parametrize("codec", ["huffman", "rans", "rcq", "rcx", "ase"])
def test_container_functions_need_a_device(codec):
    """The ops-level container functions take `device` with no default:
    codecs/base.resolve is the one place that picks the card."""
    import importlib

    ops = importlib.import_module(f"cpprcoder_tpu_torch.ops.{codec}_ops")
    encode, decode = (getattr(ops, f"{codec}_{d}") for d in ("encode",
                                                             "decode"))
    data = b"explicit device " * 20
    with pytest.raises(TypeError, match="device"):
        encode(data)
    blob = encode(data, device="cpu")
    with pytest.raises(TypeError, match="device"):
        decode(blob)
    assert decode(blob, device="cpu") == data


def test_docstring_names_every_codec():
    named = re.search(r"Codecs ported:(.*?)\n\n", ctt.__doc__, re.S).group(1)
    assert set(re.findall(r"\b([a-z0-9_]+) \(CT-", named)) \
        == set(ctt.list_codecs())


def test_default_codec_is_rans_as_in_the_jax_package():
    """compress()/decompress() with no codec named write and read CT-ANS1,
    as cpprcoder_tpu.compress does."""
    import cpprcoder_tpu

    data = bytes(range(256)) * 3 + b"default codec " * 40
    blob = ctt.compress(data, device="cpu")
    assert blob == cpprcoder_tpu.compress(data, backend="ref")
    assert blob == ctt.compress(data, codec="rans", backend="ref")
    assert ctt.decompress(cpprcoder_tpu.compress(data, backend="ref"),
                          device="cpu") == data
    assert cpprcoder_tpu.decompress(blob, backend="ref") == data


def test_round_trip_on_cpu():
    data = bytes(range(256)) * 7
    blob = ctt.compress(data, codec="rcx", device="cpu")
    assert blob == ctt.compress(data, codec="rcx", backend="ref")
    assert ctt.decompress(blob, codec="rcx", backend="torch") == data
    assert ctt.decompress(blob, codec="rcx", backend="ref") == data


def test_cuda_is_the_default_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kwargs in ({}, {"device": "cuda"}, {"backend": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ctt.compress(b"abc", **kwargs)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ctt.decompress(b"\0" * 10, **kwargs)


def test_backend_device_mismatch_and_unknowns_raise():
    with pytest.raises(ValueError):
        base.resolve("torch", "cuda")
    with pytest.raises(ValueError):
        base.resolve("cuda", "cpu")
    with pytest.raises(ValueError):
        base.resolve("jax")
    with pytest.raises(ValueError):
        ctt.compress(b"abc", codec="rcx", device="cpu", mode="fast")
    assert base.resolve(None, "cpu") == ("torch", torch.device("cpu"))
    assert base.resolve("ref") == ("ref", None)


def test_import_pulls_in_no_jax():
    code = ("import sys, cpprcoder_tpu_torch as c; "
            "b = c.compress(b'hello world' * 40, device='cpu'); "
            "assert c.decompress(b, device='cpu') == b'hello world' * 40; "
            "print('jax' in sys.modules, 'cpprcoder_tpu.ops' in sys.modules)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_sources_never_import_jax_or_jax_ops():
    pattern = re.compile(r"^\s*(from|import)\s+(jax\b|cpprcoder_tpu\.(ops|codecs|utils\.cache)\b)",
                         re.M)
    paths = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert {PKG / "codecs" / "stream.py", PKG / "codecs" / "resume.py",
            PKG / "bench" / "synth.py"} <= set(paths)
    for path in paths:
        assert not pattern.search(path.read_text()), path


def test_imports_and_runs_without_nvcc():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME="/nonexistent",
               CUDA_PATH="/nonexistent")
    code = ("import cpprcoder_tpu_torch as c\n"
            "assert c.decompress(c.compress(b'xyz' * 99, device='cpu'), device='cpu') == b'xyz' * 99\n"
            "print('ok')")
    out = _run(code, env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_build_without_nvcc_raises_clearly(monkeypatch, tmp_path):
    from cpprcoder_tpu_torch.native import build

    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert build.source_hash() == build.source_hash()
    assert {p.name for p in build.sources()} >= {
        "rcx_encode.cu", "rcx_decode.cu", "expand.cu", "rcx_model.cuh",
        "rcq_encode.cu", "rcq_decode.cu", "rans_encode.cu", "rans_decode.cu",
        "rc_encode.cuh", "rc_decode.cuh", "huffman_encode.cu",
        "huffman_decode.cu"}
    assert set(build.SIGNATURES) >= {"ct_rcq_encode", "ct_rcq_decode",
                                     "ct_rcq_encode_chunk",
                                     "ct_rans_encode", "ct_rans_decode",
                                     "ct_huffman_encode_stream",
                                     "ct_huffman_decode"}
