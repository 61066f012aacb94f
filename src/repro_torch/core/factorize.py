"""BLAST factorization of pre-trained dense weights (paper §3.2, Alg. 2), in
PyTorch (counterpart of ``repro/core/factorize.py``).

Given a dense ``A ∈ R^{m×n}``, find BLAST factors minimizing the blockwise
Frobenius loss (Eq. 4):

    ℓ(U, V, s) = Σ_ij ½‖A_ij − U_i diag(s_ij) V_jᵀ‖_F².

Three optimizers, one sweep of U, then V, then s a step:
  * ``precondition=True`` (the default) — Algorithm 2: preconditioned GD
    with P_U = (V̄ᵀV̄+δI)⁻¹, P_V = (ŪᵀŪ+δI)⁻¹, P_s = ((UᵀU)⊙(VᵀV)+δI)⁻¹
    and δ = δ₀·sqrt(max(ℓ, 1e-12‖A‖²));
  * ``precondition=False`` — plain alternating gradient descent (Eqs. 5–7);
  * ``spectral_steps=True`` — the Theorem-1 step sizes 1/σ₁ of each Gram
    matrix, which make the loss non-increasing.

The step size runs linearly from ``lr`` to ``lr_end`` over the steps.  All
Gram and solve work is O(n·r² + r³) a block; the m×n residual is formed
only for the loss after each sweep.  fp32 inside, on A's device; the s
update solves every block row's (b, r, r) systems in one batched
``torch.linalg.solve`` (b²·r² fp32 values: ~2.3 GB at b = 16, r = 1488).

The reference draws its start from a JAX key, which cannot be reproduced
here: ``factorize`` takes a start ``(U0, S0, V0)``, or draws one from a
``torch.Generator`` in the reference's distributions (U, V ~ eps·N(0, 1),
S ~ U(0, 1)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.blast import BlastParams, check_divisible, to_dense


class FactorizeResult(NamedTuple):
    params: BlastParams
    losses: torch.Tensor   # (steps,) the loss before each update
    final_loss: torch.Tensor


def _block_view(A: torch.Tensor, b: int) -> torch.Tensor:
    """(m, n) → (b_i, b_j, p, q)."""
    m, n = A.shape
    p, q = check_divisible(m, n, b)
    return A.reshape(b, p, b, q).permute(0, 2, 1, 3)


def _residual_loss(Ab, U, S, V) -> torch.Tensor:
    """The exact Eq. 4 loss Σ_ij ½‖A_ij − U_i diag(s_ij) V_jᵀ‖²."""
    approx = torch.einsum("ipr,ijr,jqr->ijpq", U, S, V)
    diff = Ab - approx
    return 0.5 * torch.sum(diff * diff)


def _top_eig(M: torch.Tensor) -> torch.Tensor:
    """σ₁ of each symmetric PSD matrix of a batch, floored at 1e-12."""
    return torch.clamp(torch.linalg.eigvalsh(M)[..., -1], min=1e-12)


def _start(b, p, q, r, eps, generator, device):
    gen = generator or torch.Generator().manual_seed(0)
    on = gen.device
    U0 = eps * torch.randn((b, p, r), generator=gen, device=on)
    V0 = eps * torch.randn((b, q, r), generator=gen, device=on)
    S0 = torch.rand((b, b, r), generator=gen, device=on)
    return tuple(a.to(device) for a in (U0, S0, V0))


def factorize(A: torch.Tensor, b: int, r: int, *, steps: int = 300,
              start: tuple | None = None,
              generator: torch.Generator | None = None,
              delta0: float = 0.1, eps: float = 1e-2, lr: float = 1.0,
              lr_end: float = 0.0, precondition: bool = True,
              spectral_steps: bool = False) -> FactorizeResult:
    """Factorize ``A`` (m, n) into BLAST(b, r), fp32 inside.  ``start``:
    (U0 (b, p, r), S0 (b, b, r), V0 (b, q, r)); else drawn from
    ``generator`` (default: a CPU generator seeded 0)."""
    A = A.float()
    m, n = A.shape
    p, q = check_divisible(m, n, b)
    dev = A.device
    Ab = _block_view(A, b)
    a_sq = torch.sum(A * A)
    if start is None:
        start = _start(b, p, q, r, eps, generator, dev)
    U, S, V = (a.to(device=dev, dtype=torch.float32) for a in start)
    eye = torch.eye(r, device=dev)
    loss = 0.5 * a_sq            # tiny start: ℓ ≈ ½‖A‖²
    losses = []

    def update(X, G, Gram, eta, delta):
        """One step of X (b, ·, r) along its gradient G = X·Gram − C."""
        if spectral_steps:
            return X - G / _top_eig(Gram)[:, None, None]
        if precondition:
            sol = torch.linalg.solve(Gram + delta * eye, G.transpose(-1, -2))
            return X - eta * sol.transpose(-1, -2)
        return X - eta * G

    for k in range(steps):
        losses.append(loss)
        eta = lr + (lr_end - lr) * (k / steps)
        # δ = δ₀·sqrt(ℓ) (Eq. 19), floored to keep the solves non-singular
        # once the residual is at fp32 noise level
        delta = delta0 * torch.sqrt(torch.maximum(loss, 1e-12 * a_sq))

        # U: G_i = U_i M_i − C_i, M_i = Σ_j diag(s_ij) V_jᵀV_j diag(s_ij),
        # C_i = Σ_j A_ij V_j diag(s_ij)
        VtV = torch.einsum("jqr,jqt->jrt", V, V)
        M = torch.einsum("ijr,jrt,ijt->irt", S, VtV, S)
        C = torch.einsum("ijpq,jqr,ijr->ipr", Ab, V, S)
        U = update(U, torch.einsum("ipr,irt->ipt", U, M) - C, M, eta, delta)

        # V (with the new U): N_j = Σ_i diag(s_ij) U_iᵀU_i diag(s_ij),
        # D_j = Σ_i A_ijᵀ U_i diag(s_ij)
        UtU = torch.einsum("ipr,ipt->irt", U, U)
        N = torch.einsum("ijr,irt,ijt->jrt", S, UtU, S)
        D = torch.einsum("ijpq,ipr,ijr->jqr", Ab, U, S)
        V = update(V, torch.einsum("jqr,jrt->jqt", V, N) - D, N, eta, delta)

        # s (with the new U, V): row i's systems W_ij = (U_iᵀU_i)⊙(V_jᵀV_j),
        # all b·b of them at once; T_ij = diag(U_iᵀ A_ij V_j)
        UtU = torch.einsum("ipr,ipt->irt", U, U)
        VtV = torch.einsum("jqr,jqt->jrt", V, V)
        T = torch.einsum("ipr,ijpq,jqr->ijr", U, Ab, V)
        W = UtU[:, None] * VtV[None]                     # (b, b, r, r)
        g = torch.einsum("ijrt,ijt->ijr", W, S) - T
        if spectral_steps:
            S = S - g / _top_eig(W)[..., None]
        elif precondition:
            sol = torch.linalg.solve(W + delta * eye, g[..., None])
            S = S - eta * sol[..., 0]
        else:
            S = S - eta * g
        del W

        loss = _residual_loss(Ab, U, S, V)
    return FactorizeResult(BlastParams(U=U, S=S, V=V), torch.stack(losses),
                           loss)


def normalized_error(A: torch.Tensor, params: BlastParams) -> torch.Tensor:
    """‖A − Â‖_F / ‖A‖_F."""
    A = A.float()
    diff = A - to_dense(params).float()
    return torch.linalg.norm(diff) / torch.linalg.norm(A)


def factorize_weight(w: torch.Tensor, b: int, r: int,
                     **kw) -> dict[str, torch.Tensor]:
    """Factorize a layer weight ``w`` (d_in, d_out) (A = wᵀ) → BLAST params
    in w's type."""
    res = factorize(w.T.float(), b, r, **kw)
    return {k: getattr(res.params, k).to(w.dtype) for k in ("U", "S", "V")}
