"""CT-RCX and CT-RCQ count models in plain PyTorch (counterpart of
cpprcoder_tpu/models/cxmodel.py `rescale_rows_jnp` / `quantize_rows_jnp`
and of models/qmodel.py `rescale_jnp` / `quantize_jnp`).

Counts C [2^cbits, 256] are int64 tensors holding u32 values. CT-RCQ's
model is the one-row case (cbits = 0) with a single conditional halving
(`rounds=1`). Constants and the parameter policies (`rcx_params`,
`rcq_params`) are the JAX package's own numpy definitions, so both
packages derive the same parameters.
"""

from __future__ import annotations

import torch

from cpprcoder_tpu.models.cxmodel import (  # noqa: F401  (shared policy)
    QBITS,
    QRESERVE,
    QTOTAL,
    RESCALE_ROUNDS,
    WLOG_DEFAULT,
    rcx_params,
)
from cpprcoder_tpu.models.qmodel import rcq_params  # noqa: F401


def rescale_rows(C: torch.Tensor, climit: int,
                 rounds: int = RESCALE_ROUNDS) -> torch.Tensor:
    """Up to `rounds` halvings `(c >> 1) | 1` of every row whose total is
    >= climit (CT-RCX: RESCALE_ROUNDS; CT-RCQ: 1)."""
    for _ in range(rounds):
        hot = C.sum(dim=1, keepdim=True) >= climit
        C = torch.where(hot, (C >> 1) | 1, C)
    return C


def quantize_rows(C: torch.Tensor) -> torch.Tensor:
    """C [B,256] -> q [B,256] with every row summing to QTOTAL:
    q = max(C * (QTOTAL - QRESERVE) // tot, 1), remainder to the row's
    FIRST argmax."""
    tot = C.sum(dim=1, keepdim=True)
    q = torch.clamp((C * (QTOTAL - QRESERVE)) // tot, min=1)
    rem = QTOTAL - q.sum(dim=1, keepdim=True)
    cols = torch.arange(256, device=C.device).expand_as(q)
    is_max = q == q.max(dim=1, keepdim=True).values
    first = torch.where(is_max, cols, 256).min(dim=1, keepdim=True).values
    return q + rem * (cols == first)


def model_tables(C: torch.Tensor, climit: int, rounds: int = RESCALE_ROUNDS):
    """Window requant: (rescaled C, q, exclusive row cumsum of q)."""
    C = rescale_rows(C, climit, rounds)
    q = quantize_rows(C)
    return C, q, torch.cumsum(q, dim=1) - q
