"""CT-RCX context model in plain PyTorch (counterpart of
cpprcoder_tpu/models/cxmodel.py `rescale_rows_jnp` / `quantize_rows_jnp`).

Counts C [2^cbits, 256] are int64 tensors holding u32 values. Constants and
the parameter policy (`rcx_params`) are the JAX package's own numpy
definitions, so both packages derive the same (k, inc, climit, cbits).
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


def rescale_rows(C: torch.Tensor, climit: int) -> torch.Tensor:
    """Up to RESCALE_ROUNDS halvings `(c >> 1) | 1` of every row whose
    total is >= climit."""
    for _ in range(RESCALE_ROUNDS):
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


def model_tables(C: torch.Tensor, climit: int):
    """Window requant: (rescaled C, q, exclusive row cumsum of q)."""
    C = rescale_rows(C, climit)
    q = quantize_rows(C)
    return C, q, torch.cumsum(q, dim=1) - q
