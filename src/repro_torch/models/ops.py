"""Model-level numeric ops (counterpart of ``repro/models/ops.py``): RMSNorm,
LayerNorm, RoPE, softcap, ``chunked_attention`` (full-sequence attention:
the B4 kernel on the card, the chunked plain version on the CPU, both
through ``kernels/ops.flash_attention``'s autograd Function),
``cross_entropy``, ``causal_conv_chunk`` (the RG-LRU's depthwise causal
conv over [cached history ‖ chunk]), and ``cache_attention`` — the
reference's position-masked cache attention, kept as the semantics the
prefill-attention kernel is held against in the tests."""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops as kops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaling by ``(1 + scale)`` (zero-initialized scale)."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, computed in fp32 and cast back."""
    dtype = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding with split halves (not interleaved pairs).
    x: (B, T, H, D) even D; positions: (T,) or (B, T)."""
    dtype = x.dtype
    d_half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(d_half, dtype=torch.float32,
                                     device=x.device) / d_half)
    pos = positions.to(device=x.device, dtype=torch.float32)
    if pos.ndim == 1:
        ang = (pos[:, None] * freqs[None, :])[None, :, None, :]
    else:
        ang = (pos[..., None] * freqs)[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().split(d_half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dtype)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, k_pos: torch.Tensor,
                    q_pos: torch.Tensor, *,
                    window: int | None = None) -> torch.Tensor:
    """Attention over a position-tagged cache.

    q: (B, Hq, T, D); k_cache/v_cache: (B, S, Hkv, D); k_pos: (B, S)
    absolute position of each slot (-1 = empty); q_pos: (B,) or (B, T)."""
    B, Hq, T, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    q_pos = q_pos.to(device=q.device, dtype=torch.int64)
    if q_pos.ndim == 1:
        q_pos = q_pos[:, None]
    q_pos = q_pos.expand(B, T)
    k_pos = k_pos.to(device=q.device, dtype=torch.int64)
    qf = q.reshape(B, Hkv, G, T, D).float()
    s = torch.einsum("bhgtd,bshd->bhgts", qf, k_cache.float()) * scale
    valid = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        valid = valid & (k_pos[:, None, :] > q_pos[:, :, None] - window)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # a row whose every slot is masked sees a uniform softmax over NEG_INF
    # scores in the reference too (its nan guard never fires): keep that
    p = torch.nan_to_num(p, nan=0.0)
    o = torch.einsum("bhgts,bshe->bhgte", p, v_cache.float())
    return o.reshape(B, Hq, T, o.shape[-1]).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      q_offset: int = 0, q_chunk: int = 512) -> torch.Tensor:
    """q (B, Hq, T, D); k, v (B, Hkv, S, D) → (B, Hq, T, D).

    The model-level full-sequence attention.  On CUDA it runs the B4
    kernel over the whole sequence; on the CPU the plain version processes
    ``q_chunk``-row query chunks (the reference's rule: at most 8 chunks),
    each against only its reachable keys, so no T×S score matrix is held.
    The backward pass is chunked the same way."""
    return kops.flash_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, q_chunk=q_chunk)


def causal_conv_chunk(cache_conv: torch.Tensor, x: torch.Tensor,
                      w: torch.Tensor, b: torch.Tensor, n_tokens: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over [cached history ‖ chunk], ragged rows.

    cache_conv: (B, K-1, ch) — each row's last K-1 pre-conv inputs; x: (B,
    C, ch) — the chunk's pre-conv inputs, live prefix per row given by
    ``n_tokens`` (B,) (dead tail columns produce outputs the caller
    discards, and never enter the returned history); w: (K, ch); b: (ch,).
    Returns (y (B, C, ch), the new history (B, K-1, ch)) — C sequential
    single-token conv steps, computed position-parallel, in the
    reference's order of sums (``y = b + Σ_k hist[k:k+C]·w[k]``)."""
    K, C = w.shape[0], x.shape[1]
    hist = torch.cat([cache_conv.to(x.dtype), x], dim=1)   # (B, K-1+C, ch)
    y = b
    for k in range(K):
        y = y + hist[:, k:k + C] * w[k]
    # hist index i holds the input at position i-(K-1) of the chunk: each
    # row's last K-1 live inputs end at index n + K - 2
    idx = (n_tokens.to(torch.int64)[:, None]
           + torch.arange(K - 1, device=x.device)[None, :])
    tail = torch.gather(hist, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return y, tail.to(cache_conv.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def cross_entropy(logits: torch.Tensor,
                  labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean token cross-entropy and accuracy; logits (..., V) taken in
    fp32, labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = torch.mean(lse - ll)
    acc = torch.mean((logits.argmax(dim=-1) == labels).float())
    return loss, acc
