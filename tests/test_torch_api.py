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


def test_registry():
    assert ctt.list_codecs() == ["rcx"]
    c = ctt.get_codec("rcx")
    assert (c.name, c.codec_id) == ("rcx", 15)
    with pytest.raises(KeyError, match="A8"):
        ctt.get_codec("rans")
    with pytest.raises(KeyError, match="A5"):
        ctt.compress(b"abc", codec="rcq")
    with pytest.raises(KeyError, match="unknown codec"):
        ctt.get_codec("nope")


def test_round_trip_on_cpu():
    data = bytes(range(256)) * 7
    blob = ctt.compress(data, codec="rcx", device="cpu")
    assert blob == ctt.compress(data, codec="rcx", backend="ref")
    assert ctt.decompress(blob, backend="torch") == data
    assert ctt.decompress(blob, backend="ref") == data


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
        ctt.compress(b"abc", device="cpu", mode="fast")
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
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
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
        "rcx_encode.cu", "rcx_decode.cu", "expand.cu", "rcx_model.cuh"}
