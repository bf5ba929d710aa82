"""CT-RCX containers of the port (device="cpu": the plain versions of the
kernels) against the numpy oracle rcx_ref.rcx_encode and the JAX backend
rcx_ops.rcx_encode_jax: byte identity, cross decoding, the wlog / cbits /
lanes sweeps, the ratio preset, and malformed headers."""

import struct

import numpy as np
import pytest

from conftest import corpus_file, std_cases

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.core.bytesutil import CorruptContainerError
from cpprcoder_tpu.models.cxmodel import rcx_params
from cpprcoder_tpu.ops import rcx_ops
from cpprcoder_tpu.reference import rcx_ref

# each std case once, with options spread so that every wlog 0..3,
# cbits {0, 2, 4, 6, 8} and lanes {8, 32, 128, 256} meets the JAX backend
STD_OPTS = [{}, dict(wlog=0), dict(cbits=0), dict(wlog=1, cbits=2),
            dict(wlog=3, lanes=8), dict(cbits=4, lanes=32),
            dict(cbits=8, lanes=128), dict(lanes=256, wlog=0),
            dict(cbits=6), {}]


def _textish(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b]).tobytes()


def _identity(data, **opts):
    blob = ctt.compress(data, codec="rcx", device="cpu", **opts)
    assert blob == rcx_ref.rcx_encode(data, **opts)
    jblob = rcx_ops.rcx_encode_jax(data, **opts)
    assert blob == jblob
    assert ctt.decompress(jblob, codec="rcx", device="cpu") == data
    assert rcx_ref.rcx_decode(blob) == data


@pytest.mark.parametrize("i", range(len(STD_OPTS)))
def test_std_cases_match_oracle_and_jax(i):
    _identity(std_cases()[i], **STD_OPTS[i])


@pytest.mark.parametrize("name", ["grammar.lsp", "xargs.1"])
def test_corpus_files_match_oracle_and_jax(name):
    _identity(corpus_file(name))


def test_ratio_mode_matches_oracle_and_jax():
    data = corpus_file("grammar.lsp")
    blob = ctt.compress(data, codec="rcx", device="cpu", mode="ratio")
    k = rcx_params(len(data), mode="ratio")[0]
    assert blob == rcx_ref.rcx_encode(data, lanes=k, cbits=6, wlog=0)
    from cpprcoder_tpu.codecs import rcx as jrcx

    assert blob == jrcx.encode(data, mode="ratio")
    assert ctt.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("opts", [dict(wlog=w) for w in range(4)]
                         + [dict(cbits=c) for c in (0, 2, 4, 6, 8)]
                         + [dict(lanes=k) for k in (8, 32, 128, 256)])
def test_sweeps_match_oracle(opts):
    data = _textish(3000, seed=len(str(opts)))
    blob = ctt.compress(data, device="cpu", **opts)
    assert blob == rcx_ref.rcx_encode(data, **opts)
    assert ctt.decompress(blob, device="cpu") == data


def test_empty_trailing_lanes():
    # (k-1)*stride >= n leaves lanes inactive from step 0
    data = _textish(1000, seed=4)
    blob = ctt.compress(data, device="cpu", lanes=256)
    assert blob == rcx_ref.rcx_encode(data, lanes=256)
    assert ctt.decompress(blob, device="cpu") == data


@pytest.mark.parametrize("big", [65535, 65536])
def test_size_table_goes_wide_at_64k(big):
    """A lane payload of 64 KiB switches the size table to u32 (lane_desc
    bit 7); the parser reads it back. (A real coded 64 KiB lane needs 64K
    steps: tests/test_torch_gpu.py covers it on the card.)"""
    from cpprcoder_tpu.core.bytesutil import ByteReader
    from cpprcoder_tpu_torch.ops import rcx_ops as tops

    rng = np.random.default_rng(big)
    sizes = np.array([big, 3], np.int32)
    rows = rng.integers(0, 256, (2, big), dtype=np.uint8)
    blob = tops.assemble((10, 2, 16, 16, 4, 2), rows, sizes)
    r = ByteReader(blob)
    assert tops.parse_rcx_header(r) == (10, 2, big >= 1 << 16, 16, 16, 4, 2)
    got = r.u32s(2) if big >= 1 << 16 else r.u16s(2)
    assert got.tolist() == [big, 3]
    assert r.rest().tobytes() == rows[0].tobytes() + rows[1, :3].tobytes()


def _blob():
    return rcx_ref.rcx_encode(_textish(500, seed=1))


def _patch(blob, pos, value):
    return blob[:pos] + bytes([value]) + blob[pos + 1:]


@pytest.mark.parametrize("mangle", [
    lambda b: _patch(b, 7, 14),              # qbits != 15
    lambda b: _patch(b, 8, 9),               # cbits > 8
    lambda b: _patch(b, 9, 4),               # wlog > 3
    lambda b: _patch(b, 4, 0x1F),            # lane count 2^31
    lambda b: b[:6],                         # truncated header
    lambda b: b[:-3],                        # size table claims more payload
    lambda b: struct.pack("<I", 10**6) + b[4:12],  # truncated size table
])
def test_malformed_headers_raise(mangle):
    with pytest.raises(CorruptContainerError):
        ctt.decompress(mangle(_blob()), codec="rcx", device="cpu")


def test_stride_beyond_the_event_run_field_raises():
    # 3 * stride + 2 must stay below 2^22 (a pending 0xFF run's length)
    n = (1 << 22) // 3
    with pytest.raises(ValueError, match="split the input"):
        ctt.compress(bytes(n), device="cpu", lanes=1)


def test_empty_input_header_only():
    blob = ctt.compress(b"", device="cpu")
    assert blob == rcx_ref.rcx_encode(b"") and len(blob) == 10
    assert ctt.decompress(blob, device="cpu") == b""
