"""CT-RCX and CT-RCQ count models: in plain PyTorch (counterpart of
cpprcoder_tpu/models/cxmodel.py `rescale_rows_jnp` / `quantize_rows_jnp`
and of models/qmodel.py `rescale_jnp` / `quantize_jnp`), plus the port's
own copy of cxmodel.py's constants, parameter policy `rcx_params` and
numpy model (what the oracle reference/rcx_ref.py codes with).

Counts C [2^cbits, 256] are int64 tensors holding u32 values. CT-RCQ's
model is the one-row case (cbits = 0) with a single conditional halving
(`rounds=1`).

CT-RCX conditions the table on a per-lane context: the top cbits bits of
the lane's previous symbol (0 at the first step). Each context row updates
every step and rescales and quantizes independently, once per window of
2^wlog steps:

    rescale:  row r halves ((c >> 1) | 1) when sum(C[r]) >= climit, up to
              RESCALE_ROUNDS times
    quantize: per row, q = max(C * (QTOTAL - QRESERVE) // tot, 1),
              remainder to the row's FIRST argmax  ->  sum(q[r]) == QTOTAL
"""

from __future__ import annotations

import numpy as np
import torch

from cpprcoder_tpu_torch.models.qmodel import (  # noqa: F401  (re-exported)
    MAX_K_TIMES_INC,
    QBITS,
    QRESERVE,
    QTOTAL,
    rcq_params,
)

# requant window 2^wlog steps (a header byte, 0..3); between requants a
# row can grow by W*K*inc on top of climit-1, and a halving maps
# tot -> <= tot/2 + 256, so three rounds always land below climit
WLOG_DEFAULT = 2
RESCALE_ROUNDS = 3

# context-width policy: wider contexts compress better but cost
# O(2^CBITS * 256) work per symbol
CBITS_SMALL, CBITS_MID, CBITS_BIG = 6, 5, 4
N_SMALL, N_MID = 1 << 16, 1 << 18


def rcx_params(n: int, lanes: int | None = None, inc: int | None = None,
               cbits: int | None = None,
               mode: str = "balanced") -> tuple[int, int, int, int]:
    """(k, inc, climit_log2, cbits) for an n-byte input.

    mode "balanced" (default) is throughput-optimal; mode "ratio" takes
    cbits=6 with half the lanes, which compresses better on every
    Canterbury file at a few times the time."""
    k, _, cl = rcq_params(n, lanes)
    if mode == "ratio" and lanes is None:
        k = max(8, k // 2)
    if cbits is None:
        cbits = 6 if mode == "ratio" else (
            CBITS_SMALL if n <= N_SMALL
            else CBITS_MID if n <= N_MID else CBITS_BIG)
    if inc is None:
        inc = min(32 if n <= N_SMALL else 16, max(1, MAX_K_TIMES_INC // k))
    assert k * inc <= MAX_K_TIMES_INC and 0 <= cbits <= 8
    return k, inc, cl, cbits


def ctx_of(prev: np.ndarray, cbits: int):
    """Context id of each lane from its previous symbol."""
    return (prev >> (8 - cbits)) if cbits else prev * 0


# ------------------------------------------------------------------ numpy

def rescale_rows_np(C: np.ndarray, climit: int) -> np.ndarray:
    for _ in range(RESCALE_ROUNDS):
        tot = C.sum(axis=1, dtype=np.uint32)
        hot = tot >= climit
        if not hot.any():
            break
        C = C.copy()
        C[hot] = (C[hot] >> 1) | 1
    return C


def quantize_rows_np(C: np.ndarray) -> np.ndarray:
    """C [B,256] u32 -> Q [B,256] with every row summing to QTOTAL."""
    C64 = C.astype(np.uint64)
    tot = C64.sum(axis=1, keepdims=True)
    q = np.maximum((C64 * (QTOTAL - QRESERVE)) // tot, 1).astype(np.uint32)
    rem = QTOTAL - q.sum(axis=1)
    am = np.argmax(q, axis=1)            # first argmax per row
    q[np.arange(len(q)), am] += rem.astype(np.uint32)
    return q


def update_rows_np(C: np.ndarray, ctx: np.ndarray, syms: np.ndarray,
                   inc: int) -> np.ndarray:
    C = C.copy()
    np.add.at(C, (ctx, syms), np.uint32(inc))
    return C


# ------------------------------------------------------------------ torch

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
