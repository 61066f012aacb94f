"""BLAST matrix: parameterization and multiplication (Alg. 1) in PyTorch.

Counterpart of ``repro/core/blast.py``.  A BLAST matrix ``A ∈ R^{m×n}`` is
partitioned into ``b×b`` blocks of size ``p×q`` (``m = b·p``, ``n = b·q``);
block ``(i, j)`` is ``U_i · diag(s_ij) · V_jᵀ`` with

    U: (b, p, r)   left factors, one per block-row
    S: (b, b, r)   diagonal coupling vectors
    V: (b, q, r)   right factors, one per block-column

Layers consume it as ``y = x @ Aᵀ`` for ``x: (..., n)`` → ``(..., m)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class BlastParams(NamedTuple):
    U: torch.Tensor
    S: torch.Tensor
    V: torch.Tensor


def check_divisible(m: int, n: int, b: int) -> tuple[int, int]:
    if m % b or n % b:
        raise ValueError(f"block count b={b} must divide both m={m} and n={n}")
    return m // b, n // b


def num_params(m: int, n: int, b: int, r: int) -> int:
    """Exact BLAST parameter count (paper §2)."""
    return (m + n) * r + b * b * r


def rank_for_budget(m: int, n: int, b: int, budget_params: float,
                    align: int = 1) -> int:
    """Largest rank whose parameter count stays within ``budget_params``;
    ``align > 1`` rounds down to a multiple."""
    r = int(budget_params // (m + n + b * b))
    if align > 1 and r >= 2 * align:
        r = (r // align) * align
    return max(r, 1)


def rank_for_compression(m: int, n: int, b: int, keep_ratio: float,
                         align: int = 1) -> int:
    """Rank so that BLAST params ≈ ``keep_ratio`` · (m·n) dense params."""
    return rank_for_budget(m, n, b, keep_ratio * m * n, align=align)


def init(generator: torch.Generator, m: int, n: int, b: int, r: int, *,
         dtype=torch.float32, device=None, factor_std: float | None = None,
         s_max: float = 2.0) -> BlastParams:
    """Random init (paper App. C.2 shapes; variance-scaled like the
    reference when ``factor_std`` is None).  Draws on the generator's device
    (CPU generator → CPU draws, then moved), so a seed gives the same weights
    on every device."""
    p, q = check_divisible(m, n, b)
    if factor_std is None:
        s_rms = s_max / math.sqrt(3.0)
        factor_std = (1.0 / (n * r)) ** 0.25 / math.sqrt(s_rms)
    U = factor_std * torch.randn((b, p, r), generator=generator)
    V = factor_std * torch.randn((b, q, r), generator=generator)
    S = s_max * torch.rand((b, b, r), generator=generator)
    return BlastParams(*(a.to(device=device, dtype=dtype) for a in (U, S, V)))


def matmul(x: torch.Tensor, params: BlastParams) -> torch.Tensor:
    """Alg. 1 as three contractions: y = x @ Aᵀ for x (..., n) → (..., m).

      z_j = V_jᵀ x_j,   w_i = Σ_j s_ij ⊙ z_j,   y_i = U_i w_i
    """
    U, S, V = params
    b, q, r = V.shape
    p = U.shape[1]
    lead = x.shape[:-1]
    xb = x.reshape(*lead, b, q)
    z = torch.einsum("...jq,jqr->...jr", xb, V)
    w = torch.einsum("...jr,ijr->...ir", z, S)
    y = torch.einsum("...ir,ipr->...ip", w, U)
    return y.reshape(*lead, b * p)


def to_dense(params: BlastParams, dtype=None) -> torch.Tensor:
    """Materialize the full A ∈ R^{m×n} (tests, dense yardsticks)."""
    U, S, V = params
    blocks = torch.einsum("ipr,ijr,jqr->ijpq", U, S, V)
    b, _, p, q = blocks.shape
    dense = blocks.permute(0, 2, 1, 3).reshape(b * p, b * q)
    return dense if dtype is None else dense.to(dtype)
