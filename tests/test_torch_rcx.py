"""CT-RCX at the kernel interface: the port's plain versions of kernels A and
C (cpprcoder_tpu_torch/ops/rcx_ops.py, reached through the rcx_kernels
wrappers on CPU tensors) against the interpret-mode Pallas kernels
rcx_pallas._encode_call / _decode_call, at K=128. Exact equality.

The Pallas grid pads the steps to bucket(stride); the port runs exactly
stride steps, so the Pallas pad rows must be zero and the flush rows equal."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.core.bytesutil import ByteReader
from cpprcoder_tpu.models.cxmodel import rcx_params
from cpprcoder_tpu.ops import rcx_ops as jops
from cpprcoder_tpu.ops import rcx_pallas
from cpprcoder_tpu.ops.rcq_ops import _rows_fn
from cpprcoder_tpu.reference import rcx_ref
from cpprcoder_tpu.utils.shapes import bucket
from cpprcoder_tpu_torch.ops import compaction, layout, rcx_kernels

rcx_pallas._INTERPRET = True
K = 128


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


@pytest.mark.parametrize("n,wlog", [(1500, 2), (4096, 0)])
def test_encode_events_match_pallas(n, wlog):
    x = _textish(n, seed=5)
    k, inc, cl, cbits = rcx_params(n, lanes=K)
    stride = -(-n // k)
    steps = bucket(stride)
    fn = rcx_pallas._encode_call(steps, k, k, inc, cl, cbits, stride, wlog)
    jev, jsizes, _ = fn(jnp.asarray(jops._pad2d_chunked(x, steps, k, stride)), n)
    jev = np.asarray(jev).view(np.int32)
    ev = rcx_kernels.encode_events(
        layout.pad2d_chunked(torch.from_numpy(x), k, stride),
        layout.lane_lengths(n, k, stride, "cpu"), inc, 1 << cl, cbits, wlog)
    assert ev.shape == (2 * stride + 2, k) and ev.dtype == torch.int32
    ev = ev.numpy()
    assert np.array_equal(ev[:2 * stride], jev[:2 * stride])
    assert not jev[2 * stride:2 * steps].any()
    assert np.array_equal(ev[2 * stride:], jev[2 * steps:])
    sizes = compaction.payload_layout_t(torch.from_numpy(ev))[3]
    assert np.array_equal(sizes.numpy(), np.asarray(jsizes))


@pytest.mark.parametrize("n,wlog", [(1500, 2), (4096, 0)])
def test_decode_symbols_match_pallas(n, wlog):
    x = _textish(n, seed=6)
    blob = rcx_ref.rcx_encode(x.tobytes(), lanes=K, wlog=wlog)
    k, inc, cl, cbits = rcx_params(n, lanes=K)
    r = ByteReader(blob, pos=10)                  # past the 10-byte header
    sizes = r.u16s(k).astype(np.int32)
    payload = r.rest()
    stride = -(-n // k)
    l4 = bucket(-(-int(sizes.max()) // 4) + 1)
    p_cap = bucket(len(payload))
    padded = np.zeros(p_cap, np.uint8)
    padded[:len(payload)] = payload
    rows_wT = _rows_fn(k, l4, p_cap)(jnp.asarray(padded), jnp.asarray(sizes)).T
    jsym = np.asarray(rcx_pallas._decode_call(
        bucket(stride), k, k, l4, inc, cl, cbits, stride, wlog)(rows_wT, n))
    words = layout.word_rows(torch.from_numpy(payload.copy()),
                             torch.from_numpy(sizes), l4)
    assert np.array_equal(words.numpy(), np.asarray(rows_wT).view(np.int32))
    sym = rcx_kernels.decode_symbols(
        words, layout.lane_lengths(n, k, stride, "cpu"), n, stride, inc,
        1 << cl, cbits, wlog)
    want = jsym[:stride].T.reshape(-1)[:n]
    assert np.array_equal(sym.numpy(), want.astype(np.uint8))
    assert np.array_equal(sym.numpy(), x)


def test_wrappers_reject_what_the_kernels_do_not_take():
    x2d = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.full((8,), 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        rcx_kernels.encode_events(x2d.to(torch.int32), lens, 1, 1 << 16, 4, 0)
    with pytest.raises(ValueError):
        rcx_kernels.encode_events(x2d, lens[:4], 1, 1 << 16, 4, 0)
    with pytest.raises(ValueError):
        rcx_kernels.encode_events(x2d, lens, 1, 1 << 16, 9, 0)
    with pytest.raises(ValueError):
        rcx_kernels.encode_events(torch.zeros((8, 4), dtype=torch.uint8).T,
                                  lens, 1, 1 << 16, 4, 0)
    with pytest.raises(ValueError):    # not a CPU tensor: no silent plain path
        rcx_kernels.encode_events(x2d.to("meta"), lens.to("meta"), 1,
                                  1 << 16, 4, 0)
    words = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        rcx_kernels.decode_symbols(words, lens, 33, 4, 1, 1 << 16, 4, 0)


def test_model_bytes_matches_kernel_layout():
    # csrc/rcx_model.cuh, whose ct::scratch_bytes the wrappers ask for: a
    # block's model fits shared memory up to cbits = 7 and takes global
    # scratch at cbits = 8; a block of kernel C's 4-block cluster, holding a
    # quarter of the counts and every cum row, fits at cbits = 8
    hdr = (Path(__file__).resolve().parent.parent / "cpprcoder_tpu_torch"
           / "csrc" / "rcx_model.cuh").read_text()
    stride = int(re.search(r"CUM_STRIDE = (\d+);", hdr).group(1))
    limit = int(re.search(r"SMEM_LIMIT = (\d+);", hdr).group(1))

    def model_bytes(count_rows, cum_rows):
        return count_rows * 256 * 4 + ((cum_rows * stride * 2 + 15) & ~15)

    assert model_bytes(128, 128) <= limit < model_bytes(256, 256)
    assert model_bytes(64, 256) <= limit
    assert model_bytes(1, 1) == 256 * 4 + 528
