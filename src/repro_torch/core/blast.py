"""BLAST matrix: parameterization and multiplication (Alg. 1) in PyTorch.

Counterpart of ``repro/core/blast.py``.  A BLAST matrix ``A ∈ R^{m×n}`` is
partitioned into ``b×b`` blocks of size ``p×q`` (``m = b·p``, ``n = b·q``);
block ``(i, j)`` is ``U_i · diag(s_ij) · V_jᵀ`` with

    U: (b, p, r)   left factors, one per block-row
    S: (b, b, r)   diagonal coupling vectors
    V: (b, q, r)   right factors, one per block-column

Layers consume it as ``y = x @ Aᵀ`` for ``x: (..., n)`` → ``(..., m)``.

The special cases of the paper (§2, App. A.1) embed exactly: low-rank,
block-diagonal and (exact) Monarch matrices are BLAST matrices, and a
dense matrix's truncated SVD gives a BLAST start (``from_*``).
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
    on every device; a CUDA generator draws on the card (other numbers)."""
    p, q = check_divisible(m, n, b)
    if factor_std is None:
        s_rms = s_max / math.sqrt(3.0)
        factor_std = (1.0 / (n * r)) ** 0.25 / math.sqrt(s_rms)
    on = generator.device
    U = factor_std * torch.randn((b, p, r), generator=generator, device=on)
    V = factor_std * torch.randn((b, q, r), generator=generator, device=on)
    S = s_max * torch.rand((b, b, r), generator=generator, device=on)
    return BlastParams(*(a.to(device=device, dtype=dtype) for a in (U, S, V)))


def init_paper(generator: torch.Generator, m: int, n: int, b: int, r: int, *,
               dtype=torch.float32, device=None) -> BlastParams:
    """The paper's App. C.2 initialization: U, V ~ N(0, 0.02), s ~ U(0, 2)."""
    return init(generator, m, n, b, r, dtype=dtype, device=device,
                factor_std=math.sqrt(0.02), s_max=2.0)


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


# ---------------------------------------------------------------------------
# Special cases (paper §2 and App. A.1): exact embeddings into BLAST.
# ---------------------------------------------------------------------------


def from_low_rank(w_down: torch.Tensor, w_up: torch.Tensor,
                  b: int) -> BlastParams:
    """Low-rank ``A = w_upᵀ w_downᵀ`` (``y = (x @ w_down) @ w_up``; w_down
    (n, t), w_up (t, m)) as BLAST of rank t with all-ones coupling."""
    n, t = w_down.shape
    m = w_up.shape[1]
    p, q = check_divisible(m, n, b)
    return BlastParams(U=w_up.T.reshape(b, p, t),
                       S=w_down.new_ones((b, b, t)),
                       V=w_down.reshape(b, q, t))


def from_block_diagonal(w_bd: torch.Tensor) -> BlastParams:
    """Block-diagonal ``y_i = x_i @ w_i`` (w_bd (b, q, p)) as BLAST of rank
    q: U_i = w_iᵀ, V_j = I, s_ij = [i == j]."""
    b, q, _ = w_bd.shape
    eye = torch.eye(q, dtype=w_bd.dtype, device=w_bd.device)
    S = torch.eye(b, dtype=w_bd.dtype, device=w_bd.device)[:, :, None]
    return BlastParams(U=w_bd.transpose(1, 2).contiguous(),
                       S=S.expand(b, b, q).contiguous(),
                       V=eye.expand(b, q, q).contiguous())


def from_monarch(L: torch.Tensor, R: torch.Tensor) -> BlastParams:
    """Exact Monarch (L (b, q, k), R (k, b, c) with c == b; output block i is
    the c index, M_ij[k0, q0] = L[j, q0, k0] · R[k0, j, i]) as BLAST of rank
    k: U_i = I_k, V_j = L[j], s_ij[ρ] = R[ρ, j, i].  The rectangular form
    has no such embedding and raises."""
    b, q, k = L.shape
    k2, b2, c = R.shape
    if k2 != k or b2 != b or c != b:
        raise ValueError("from_monarch requires R: (k, b, b) matching L: "
                         "(b, q, k)")
    eye = torch.eye(k, dtype=L.dtype, device=L.device)
    return BlastParams(U=eye.expand(b, k, k).contiguous(),
                       S=R.permute(2, 1, 0).contiguous(), V=L)


def from_dense_svd(w: torch.Tensor, b: int, r: int) -> BlastParams:
    """The global truncated SVD of ``A = wᵀ`` (w (n, m), ``y = x @ w``) in
    BLAST, its rank zero-padded to r: a spectral start for Algorithm 2 and a
    baseline."""
    u, s, vt = torch.linalg.svd(w.T.float(), full_matrices=False)
    t = min(r, s.shape[0])
    params = from_low_rank(vt[:t].T, (u[:, :t] * s[:t]).T, b)
    if t < r:
        params = BlastParams(*(torch.nn.functional.pad(a, (0, r - t))
                               for a in params))
    return BlastParams(*(a.to(w.dtype) for a in params))
