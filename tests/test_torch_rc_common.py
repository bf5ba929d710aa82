"""Port range-coder primitives (cpprcoder_tpu_torch/ops/rc_common.py) against
the JAX ones (cpprcoder_tpu/ops/rc_common.py) on random lane states,
including carries out of `low` and top-symbol lanes. Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.models.cxmodel import QBITS, QTOTAL
from cpprcoder_tpu.ops import rc_common as jrc
from cpprcoder_tpu_torch.ops import rc_common as trc

K = 257


def _states(seed):
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << 32, K, dtype=np.uint64)
    low[::4] = rng.integers(0xFF000000, 1 << 32, len(low[::4]))  # carry-prone
    carry = rng.integers(0, 2, K, dtype=np.uint64)
    rngv = rng.integers(1 << 24, 1 << 32, K, dtype=np.uint64)
    cache = rng.integers(0, 256, K, dtype=np.uint64)
    csize = rng.integers(1, 6, K, dtype=np.uint64)
    return [low, carry, rngv, cache, csize]


def _both(st):
    return (tuple(jnp.asarray(a.astype(np.uint32)) for a in st),
            tuple(torch.from_numpy(a.astype(np.int64)) for a in st))


def _eq(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64), t.numpy())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_encode_symbol_matches_jax(seed):
    st = _states(seed)
    rng = np.random.default_rng(100 + seed)
    t = st[2] >> QBITS
    freq = rng.integers(1, 2000, K, dtype=np.uint64)
    cum = rng.integers(0, QTOTAL - 2000, K, dtype=np.uint64)
    top = rng.random(K) < 0.25
    cum[top] = QTOTAL - freq[top]                        # is_top lanes
    small = rng.random(K) < 0.3
    freq[small] = 1                                      # force 2 renorms
    active = rng.random(K) < 0.8
    jst, tst = _both(st)
    jout, jev = jrc.encode_symbol(
        jst, jnp.asarray(t.astype(np.uint32)), jnp.asarray(cum.astype(np.uint32)),
        jnp.asarray(freq.astype(np.uint32)), jnp.asarray(top),
        jnp.asarray(active), 2)
    tout, tev = trc.encode_symbol(
        tst, torch.from_numpy(t.astype(np.int64)),
        torch.from_numpy(cum.astype(np.int64)),
        torch.from_numpy(freq.astype(np.int64)), torch.from_numpy(top),
        torch.from_numpy(active), 2)
    assert all(_eq(a, b) for a, b in zip(jout, tout))
    assert _eq(jev, tev)
    # the random states do exercise carries and both renorm slots
    assert int((tout[1] > torch.from_numpy(st[1].astype(np.int64))).sum()) > 0
    assert int((tev[1] != 0).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flush_matches_jax(seed):
    jst, tst = _both(_states(seed))
    assert _eq(jrc.flush(jst), trc.flush(tst))


def test_u32_i32_round_trip():
    v = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    i = trc.u32_to_i32(v)
    assert i.dtype == torch.int32
    assert i.tolist() == [0, 1, 0x7FFFFFFF, -(1 << 31), -1]
    assert torch.equal(trc.i32_to_u32(i), v)
