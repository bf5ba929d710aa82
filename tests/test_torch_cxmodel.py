"""Port context model (cpprcoder_tpu_torch/models/cxmodel.py) against the
JAX package's jnp and numpy twins: rescale (rows above climit, up to three
halvings) and quantize (first-argmax tie-break). Exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprcoder_tpu.models import cxmodel as jcx
from cpprcoder_tpu_torch.models import cxmodel as tcx

CLIMIT = 1 << 16


def _rows(seed):
    rng = np.random.default_rng(seed)
    C = rng.integers(1, 400, (12, 256)).astype(np.uint32)
    C[1] = 300                                  # total 76800: one halving
    C[2] = rng.integers(1500, 1800, 256)        # ~420k: three halvings
    C[3] = 1                                    # all tied
    C[4, [7, 100, 200]] = 5000                  # tie for the max, first wins
    C[5, 255] = 60000                           # max at the last symbol
    return C


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rescale_rows_matches(seed):
    C = _rows(seed)
    got = tcx.rescale_rows(torch.from_numpy(C.astype(np.int64)), CLIMIT).numpy()
    assert np.array_equal(got, np.asarray(jcx.rescale_rows_jnp(jnp.asarray(C), CLIMIT)))
    assert np.array_equal(got, jcx.rescale_rows_np(C, CLIMIT))
    assert (got.sum(axis=1) < CLIMIT).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_matches(seed):
    C = jcx.rescale_rows_np(_rows(seed), CLIMIT)    # quantize's domain
    got = tcx.quantize_rows(torch.from_numpy(C.astype(np.int64))).numpy()
    assert np.array_equal(got, np.asarray(jcx.quantize_rows_jnp(jnp.asarray(C))))
    assert np.array_equal(got, jcx.quantize_rows_np(C))
    assert (got.sum(axis=1) == jcx.QTOTAL).all() and (got >= 1).all()


def test_quantize_tie_goes_to_first_argmax():
    C = np.ones((2, 256), np.uint32)
    C[0, [9, 3, 200]] = 700
    C[1] = 5                                    # every symbol ties
    got = tcx.quantize_rows(torch.from_numpy(C.astype(np.int64))).numpy()
    base = jcx.QTOTAL - jcx.QRESERVE
    q0 = np.maximum(C.astype(np.int64) * base // C.sum(axis=1, keepdims=True), 1)
    assert got[0, 3] > got[0, 9] == got[0, 200] == q0[0, 9]
    assert got[1, 0] > got[1, 1] and (got[1, 1:] == q0[1, 1]).all()


def test_model_tables_exclusive_cumsum():
    C = torch.from_numpy(_rows(4).astype(np.int64))
    C2, q, cum = tcx.model_tables(C, CLIMIT)
    assert torch.equal(C2, tcx.rescale_rows(C, CLIMIT))
    assert (cum[:, 0] == 0).all()
    assert torch.equal(cum[:, 1:], torch.cumsum(q, 1)[:, :-1])
