"""Mamba-2 SSD (state-space duality) mixer of the ssm family [arXiv:2405.21060]
(counterpart of ``repro/models/ssd.py``).

One projection ``in_proj`` of the block input gives the gate z, the conv
input xBC (x, B, C) and the per-head step dt; a causal depthwise conv and
SiLU over xBC; the selective state-space recurrence per head h (P × N)

    a_t = exp(dt_t · A),   A = -exp(A_log)
    h_t = a_t · h_{t-1} + dt_t · x_t ⊗ B_t
    y_t = h_t C_t + D · x_t

in fp32; then the gated norm ``rms_norm(y · silu(z))`` in the compute dtype
and ``out_proj`` back to d_model.  ``in_proj`` and ``out_proj`` are the
structured (BLAST) linears; the recurrence has no weight matrix.  A_log, D
and dt_bias stay fp32.

``ssd_apply`` runs a whole sequence in the chunked dual form
(``ssd_chunked``: quadratic attention-like products inside each chunk, the
recurrence across chunks); training differentiates it with plain autograd
(every op PyTorch's), its projections through the BLAST Functions.  A
cached step carries (conv history, h): O(1) per row, float or, with the
int8 cache, int8 codes with per-row scales (``qt.pack_state_cache``).  ``ssd_prefill`` runs the
projections, conv and gates over the whole chunk and the state update token
by token (plain PyTorch on both devices, as the reference leaves it to
XLA), writes the cache in place, and, for a speculative verify, collects
per-token snapshots that ``ssd_cache_rollback`` rewinds to.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.structures import LinearSpec, make_linear
from repro_torch.models import layers as L
from repro_torch.models import ops
from repro_torch.models.rglru import _conv1d, _store, rglru_cache_rollback
from repro_torch.quant import qarray as qt

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    cfg: ArchConfig
    d_inner: int
    n_heads: int
    head_dim: int
    d_state: int
    chunk: int
    conv_width: int
    n_groups: int
    in_proj: LinearSpec   # d -> 2·d_inner + 2·G·N + H   (z, x, B, C, dt)
    out_proj: LinearSpec  # d_inner -> d

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def make_ssd(cfg: ArchConfig) -> SSDSpec:
    s = cfg.ssd
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    G = 1
    d_in_proj = 2 * d_inner + 2 * G * s.d_state + n_heads
    return SSDSpec(
        cfg=cfg, d_inner=d_inner, n_heads=n_heads, head_dim=s.head_dim,
        d_state=s.d_state, chunk=s.chunk, conv_width=s.conv_width,
        n_groups=G,
        in_proj=make_linear(cfg.d_model, d_in_proj, cfg.structure),
        out_proj=make_linear(d_inner, cfg.d_model, cfg.structure))


def ssd_init(spec: SSDSpec, generator: torch.Generator, dtype,
             device) -> Params:
    """Seeded random weights: dt_bias = softplus⁻¹(dt), dt log-uniform in
    (1e-3, 1e-1); A = -1, D = 1, an identity conv, a zero norm scale."""
    H = spec.n_heads
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * torch.rand(
        (H,), generator=generator, device=generator.device).cpu())
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    conv_w = torch.zeros((spec.conv_width, spec.conv_channels))
    conv_w[-1] = 1.0
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.linear_init(spec.in_proj, generator, dtype, device),
        "out_proj": L.linear_init(spec.out_proj, generator, dtype, device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros((spec.conv_channels,), dtype=dtype,
                              device=device),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": dt_bias.to(**f32),
        "norm": {"scale": torch.zeros((spec.d_inner,), dtype=dtype,
                                      device=device)}}


def ssd_quantize(spec: SSDSpec, params: Params, bits: int = 8) -> Params:
    """Quantize the structured in/out projections; the conv, the gates and
    the norm stay float (O(d_inner) vectors)."""
    qp = dict(params)
    qp["in_proj"] = L.linear_quantize(spec.in_proj, params["in_proj"], bits)
    qp["out_proj"] = L.linear_quantize(spec.out_proj, params["out_proj"],
                                       bits)
    return qp


def _split_in_proj(spec: SSDSpec, zxbcdt: torch.Tensor):
    d_inner, G, N = spec.d_inner, spec.n_groups, spec.d_state
    xbc_end = 2 * d_inner + 2 * G * N
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:xbc_end],
            zxbcdt[..., xbc_end:])


def _split_xbc(spec: SSDSpec, xBC: torch.Tensor):
    d_inner, G, N = spec.d_inner, spec.n_groups, spec.d_state
    return (xBC[..., :d_inner], xBC[..., d_inner:d_inner + G * N],
            xBC[..., d_inner + G * N:])


def _heads(spec: SSDSpec, xBC: torch.Tensor):
    """The conv output (B, T, ch) → x (B, T, H, P), B and C (B, T, H, N),
    fp32, each group's B and C repeated over its heads."""
    Bsz, T = xBC.shape[:2]
    H, P, N, G = spec.n_heads, spec.head_dim, spec.d_state, spec.n_groups
    x, Bm, Cm = _split_xbc(spec, xBC)
    rep = H // G

    def per_head(m):
        return m.reshape(Bsz, T, G, N).float().repeat_interleave(rep, dim=2)
    return x.reshape(Bsz, T, H, P).float(), per_head(Bm), per_head(Cm)


def _gated_out(spec: SSDSpec, params: Params, y: torch.Tensor,
               x: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    """y (B, T, H, P) fp32 plus the skip D·x, in ``dtype``, through the
    gated norm ``rms_norm(y · silu(z))`` and ``out_proj``."""
    y = y + params["D"][None, None, :, None] * x
    y = y.reshape(*y.shape[:2], spec.d_inner).to(dtype)
    y = ops.rms_norm(y * F.silu(z), params["norm"]["scale"])
    return L.linear_apply(spec.out_proj, params["out_proj"], y)


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """da (..., L) → (..., L, L): entry (i, j) is Σ_{j<k≤i} da_k below the
    diagonal and on it, -inf above."""
    Ln = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Ln, Ln), dtype=torch.bool,
                                 device=da.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan in its dual form, fp32, from a zero state.

    x (B, T, H, P); dt (B, T, H); A (H,); Bm, Cm (B, T, H, N) → y (B, T, H,
    P) and the last state (B, H, P, N).  Inside a chunk of L tokens the
    output is the quadratic form (C·Bᵀ masked by the decays) times dt·x;
    across chunks the states S_c of each chunk run through the recurrence
    h_c = exp(Σ da_c)·h_{c-1} + S_c.  A padded tail (dt = 0: decay 1, x̄ =
    0) moves no state."""
    Bsz, T, H, Pd = x.shape
    N = Bm.shape[-1]
    Ln = min(chunk, T)
    pad = (-T) % Ln
    if pad:
        def z(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, Bm, Cm = z(x), z(dt), z(Bm), z(Cm)
    nc = (T + pad) // Ln
    xc = x.reshape(Bsz, nc, Ln, H, Pd)
    dtc = dt.reshape(Bsz, nc, Ln, H)
    Bc = Bm.reshape(Bsz, nc, Ln, H, N)
    Cc = Cm.reshape(Bsz, nc, Ln, H, N)
    da = dtc * A
    xdt = xc * dtc[..., None]                                  # x̄ = dt·x

    # inside each chunk: the dual quadratic form
    Lmat = torch.exp(_segsum(da.transpose(2, 3)))              # (B,nc,H,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)
    y = torch.einsum("bchls,bcshp->bclhp", scores * Lmat, xdt)

    # each chunk's state  S_c = Σ_l exp(Σ_{k>l} da) · x̄_l ⊗ B_l
    da_cum = torch.cumsum(da, dim=2)                           # (B,nc,L,H)
    decay = torch.exp(da_cum[:, :, -1:] - da_cum)
    S = torch.einsum("bclh,bclhn,bclhp->bchpn", decay, Bc, xdt)

    # across chunks: h_c = exp(Σ da_c) · h_{c-1} + S_c
    chunk_decay = torch.exp(da_cum[:, :, -1])                  # (B,nc,H)
    h = torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(entering, dim=1)                      # (B,nc,H,P,N)
    y = y + torch.einsum("bclh,bclhn,bchpn->bclhp", torch.exp(da_cum), Cc,
                         h_prev)
    y = y.reshape(Bsz, nc * Ln, H, Pd)
    return y[:, :T], h


def ssd_apply(spec: SSDSpec, params: Params, x: torch.Tensor,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full sequence: x (B, T, d_model) → (B, T, d_model) from a zero
    state, through the chunked dual form (differentiable: the training
    path).  ``positions`` is unused (no positional state), kept for the
    mixers' common signature."""
    zxbcdt = L.linear_apply(spec.in_proj, params["in_proj"], x)
    z, xBC_pre, dt_raw = _split_in_proj(spec, zxbcdt)
    xBC = F.silu(_conv1d(xBC_pre, params["conv_w"], params["conv_b"]))
    xin, Bm, Cm = _heads(spec, xBC)
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    y, _ = ssd_chunked(xin, dt, -torch.exp(params["A_log"]), Bm, Cm,
                       spec.chunk)
    return _gated_out(spec, params, y, xin, z, x.dtype)


def ssd_cache_init(spec: SSDSpec, batch: int, max_len: int, dtype,
                   device) -> Params:
    """The recurrent state of ``batch`` rows: ``conv`` (B, K-1, ch), each
    row's last K-1 pre-conv inputs, in the model's dtype, and ``h`` (B, H,
    P, N) in fp32.  With ``cfg.cache_quant`` both are int8 codes with
    per-row scales (``qt.pack_state_cache``): ``conv_scale`` (B, K-1)
    bf16, ``h_scale`` (B, H, P) fp32.  O(1) in ``max_len``."""
    K1, ch = spec.conv_width - 1, spec.conv_channels
    h_shape = (spec.n_heads, spec.head_dim, spec.d_state)

    def zeros(*shape, dtype_=dtype):
        return torch.zeros((batch, *shape), dtype=dtype_, device=device)

    if spec.cfg.cache_quant:
        return {"conv": zeros(K1, ch, dtype_=torch.int8),
                "conv_scale": zeros(K1, dtype_=torch.bfloat16),
                "h": zeros(*h_shape, dtype_=torch.int8),
                "h_scale": zeros(*h_shape[:-1], dtype_=torch.float32)}
    return {"conv": zeros(K1, ch), "h": zeros(*h_shape, dtype_=torch.float32)}


def ssd_cache_axes(spec: SSDSpec) -> dict[str, tuple]:
    """Logical axis names of ``ssd_cache_init``'s leaves: no ``kv_seq``
    axis, so the paged cache keeps them slot-resident (state leaves)."""
    a = {"conv": ("batch", None, "ffn"), "h": ("batch", None, None, None)}
    if spec.cfg.cache_quant:
        a.update(conv_scale=("batch", None), h_scale=("batch", None, None))
    return a


def _scan(a: torch.Tensor, xdt: torch.Tensor, Bm: torch.Tensor,
          Cm: torch.Tensor, h: torch.Tensor, keep: bool = False):
    """The state update token by token, fp32: h_t = a_t·h_{t-1} + x̄_t ⊗
    B_t and y_t = h_t C_t over the T axis of a (B, T, H), x̄ = dt·x (B, T,
    H, P), Bm and Cm (B, T, H, N), from h (B, H, P, N) → (every y_t (B, T,
    H, P), the last h, every h_t if ``keep`` else [])."""
    ys, hs = [], []
    for t in range(a.shape[1]):
        h = torch.addcmul(a[:, t, :, None, None] * h, xdt[:, t, :, :, None],
                          Bm[:, t, :, None, :])
        ys.append(torch.matmul(h, Cm[:, t, :, :, None])[..., 0])
        if keep:
            hs.append(h)
    return torch.stack(ys, dim=1), h, hs


def ssd_prefill(spec: SSDSpec, params: Params, cache: Params,
                x: torch.Tensor, steps, n_tokens: torch.Tensor, *,
                collect: dict | None = None) -> tuple[torch.Tensor, Params]:
    """Multi-token cached step: x (B, C, d_model); n_tokens (B,) live tokens
    per row, on x's device.  The projections, the conv and the gates run
    over the whole chunk; the state update token by token, y_t read off
    each new state, each dead column with dt = 0 (a = 1, nothing added), so
    a dead column leaves (conv, h) as it was (the reference's per-token
    ``lax.scan``).  ``steps`` is unused (no positional state).  Reads the
    state through ``qt.unpack_state_cache`` and writes ``conv`` and ``h``
    (an int8 cache: packed again) in place.

    ``collect``: a dict that receives the chunk's per-token state snapshots
    for a speculative verify's rollback (``ssd_cache_rollback``), as the
    reference's ``collect=True`` adds them to its cache: ``h_snap`` (B,
    C+1, H, P, N) fp32, index 0 the incoming state, and ``conv_hist`` (B,
    K-1+C, ch), the conv history.  Without it no stack of states is
    kept."""
    del steps
    C = x.shape[1]
    n = n_tokens.to(device=x.device, dtype=torch.int64)
    live = torch.arange(C, device=x.device)[None, :] < n[:, None]
    conv_prev, h_prev = qt.unpack_state_cache(spec.cfg.cache_quant, cache,
                                              x.dtype)
    zxbcdt = L.linear_apply(spec.in_proj, params["in_proj"], x)
    z, xBC_pre, dt_raw = _split_in_proj(spec, zxbcdt)
    y_conv, conv = ops.causal_conv_chunk(conv_prev, xBC_pre,
                                         params["conv_w"], params["conv_b"], n)
    xin, Bm, Cm = _heads(spec, F.silu(y_conv))
    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    dt = torch.where(live[..., None], dt, 0.0)
    a = torch.exp(dt * -torch.exp(params["A_log"]))            # (B, C, H)
    y, h, hs = _scan(a, xin * dt[..., None], Bm, Cm, h_prev,
                     keep=collect is not None)
    out = _gated_out(spec, params, y, xin, z, x.dtype)
    if collect is not None:
        collect["h_snap"] = torch.stack([h_prev.float(), *hs], dim=1)
        collect["conv_hist"] = torch.cat(
            [conv_prev, xBC_pre.to(conv_prev.dtype)], dim=1)
    _store(spec, cache, conv, h)
    return out, cache


def ssd_cache_rollback(spec: SSDSpec, cache: Params, snaps: dict,
                       n_comm: torch.Tensor) -> Params:
    """Rewind, in place, a state written by a chunk that ``ssd_prefill``
    ran with ``collect=snaps`` to its first ``n_comm`` (B,) tokens: ``h``
    is ``h_snap[:, n_comm]`` exactly (dead and rejected columns set dt = 0:
    a = 1 and nothing added, so a snapshot at a draft boundary equals never
    having drafted), and the conv history's K-1 entries ending there,
    packed again.  The leaves are the RG-LRU's, and so is the rewind
    (``rglru.rglru_cache_rollback``)."""
    return rglru_cache_rollback(spec, cache, snaps, n_comm)


def ssd_decode(spec: SSDSpec, params: Params, cache: Params,
               x: torch.Tensor, step) -> tuple[torch.Tensor, Params]:
    """Single-token decode: ``ssd_prefill`` with C = 1."""
    B = x.shape[0]
    return ssd_prefill(spec, params, cache, x, step,
                       torch.ones((B,), dtype=torch.int64, device=x.device))
