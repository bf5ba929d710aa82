"""The CUDA kernels against their plain versions, on the card. Marked `gpu`:
they skip where no CUDA device is present. On a GPU machine without JAX
(tests/conftest.py imports it) and without pytest-xdist, run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q --noconftest -o addopts=
"""

import numpy as np
import pytest
import torch

import cpprcoder_tpu_torch as ctt
from cpprcoder_tpu.reference import rcx_ref
from cpprcoder_tpu_torch.ops import compaction, expand, rcx_kernels, rcx_ops

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _textish(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(97, 123, n // 2, dtype=np.uint8)
    b = rng.integers(0, 256, n - n // 2, dtype=np.uint8)
    return np.concatenate([a, b])


@pytest.mark.parametrize("k,cbits,wlog", [(8, 0, 3), (32, 6, 2), (256, 8, 0),
                                          (1024, 5, 1), (3000, 4, 2)])
def test_coder_kernels_match_plain(dev, k, cbits, wlog):
    n = 40 * k + 7
    x = torch.from_numpy(_textish(n, k)).to(dev)
    stride = -(-n // k)
    x2d = rcx_ops.pad2d_chunked(x, k, stride)
    lens = rcx_ops.lane_lengths(n, k, stride, dev)
    args = (16, 1 << 16, cbits, wlog)
    ev = rcx_kernels.encode_events(x2d, lens, *args)
    assert torch.equal(ev, rcx_ops.encode_events_plain(x2d, lens, *args))
    rows, sizes = expand.materialize_rows(ev)
    prow, psizes = compaction.materialize_rows_t(ev, rows.shape[1])
    assert torch.equal(rows, prow) and torch.equal(sizes, psizes)
    payload = rows[torch.arange(rows.shape[1], device=dev)[None, :]
                   < sizes[:, None].long()]
    words = rcx_ops.word_rows(payload, sizes, -(-int(sizes.max()) // 4) + 1)
    sym = rcx_kernels.decode_symbols(words, lens, n, stride, *args)
    assert torch.equal(sym, rcx_ops.decode_symbols_plain(words, lens, n,
                                                         stride, *args))
    assert torch.equal(sym, x)


def test_wide_lane_round_trip(dev):
    """One lane past 64 KiB of payload: u32 size table, oracle-identical."""
    data = np.random.default_rng(1).integers(0, 256, 140_000, np.uint8).tobytes()
    blob = ctt.compress(data, device="cuda", lanes=2)
    assert blob[4] & 0x80
    assert blob == rcx_ref.rcx_encode(data, lanes=2)
    assert ctt.decompress(blob, device="cuda") == data


def test_launch_counters_move(dev):
    before = (rcx_kernels.encode_launches, expand.launches,
              rcx_kernels.decode_launches)
    data = _textish(5000, 3).tobytes()
    assert ctt.decompress(ctt.compress(data), device="cuda") == data
    after = (rcx_kernels.encode_launches, expand.launches,
             rcx_kernels.decode_launches)
    assert all(a == b + 1 for a, b in zip(after, before))
