"""Plain PyTorch versions of the kernels on the serving path (counterparts of
``repro/kernels/ref.py``).  They are the CPU path of ``kernels/ops.py`` and
the oracle each CUDA kernel is held against on the card: fp32 accumulation,
the same masks, and the same "fully-masked row → 0" rule."""

from __future__ import annotations

import math

import torch


def blast_matmul_ref(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                     V: torch.Tensor) -> torch.Tensor:
    """Alg. 1: x (..., n) → (..., m); U (b,p,r), S (b,b,r), V (b,q,r)."""
    b, q, r = V.shape
    p = U.shape[1]
    lead = x.shape[:-1]
    xb = x.reshape(*lead, b, q).float()
    z = torch.einsum("...jq,jqr->...jr", xb, V.float())
    w = torch.einsum("...jr,ijr->...ir", z, S.float())
    y = torch.einsum("...ir,ipr->...ip", w, U.float())
    return y.reshape(*lead, b * p).to(x.dtype)


def blast_matmul_grouped_ref(x: torch.Tensor, U: torch.Tensor, S: torch.Tensor,
                             V: torch.Tensor) -> torch.Tensor:
    """Grouped oracle == the per-projection loop: x (..., n) shared;
    U (G,b,p,r), S (G,b,b,r), V (G,b,q,r) → y (G, ..., m)."""
    return torch.stack([blast_matmul_ref(x, U[g], S[g], V[g])
                        for g in range(U.shape[0])])


def attention_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offsets: torch.Tensor, *, causal: bool = True,
                          window: int | None = None,
                          kv_len: int | None = None) -> torch.Tensor:
    """Prefill-at-offset attention: q (B, Hq, C, D); k, v (B, Hkv, S, D)
    (any strides); q_offsets (B,).  Query (b, t) at absolute position
    ``q_offsets[b] + t`` attends to key j iff ``j <= q_offsets[b] + t``,
    ``j < kv_len`` and (with a window) ``j > q_offsets[b] + t - window``."""
    B, Hq, T, D = q.shape
    Hkv, S_len = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = S_len if kv_len is None else kv_len
    qf = q.reshape(B, Hkv, G, T, D).float()
    scores = torch.einsum("bhgtd,bhsd->bhgts", qf, k.float()) / math.sqrt(D)
    offs = q_offsets.to(device=q.device, dtype=torch.int64)
    qi = offs[:, None, None] + torch.arange(T, device=q.device)[None, :, None]
    kj = torch.arange(S_len, device=q.device)[None, None, :]
    mask = (kj < kv_len).expand(B, T, S_len)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)   # fully-masked rows → 0
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(B, Hq, T, D).to(q.dtype)
