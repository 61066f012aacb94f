"""RG-LRU recurrent block of the hybrid family (Griffin / RecurrentGemma;
counterpart of ``repro/models/rglru.py``).

Two parallel branches from the block input — a GELU gate branch and a
(causal depthwise conv → RG-LRU) branch — merged by an elementwise product
and projected back to d_model.  ``in_x``, ``in_gate`` and ``out`` are
structured linears (BLAST: ``in_gate`` + ``in_x`` share the input and run
as one grouped launch, B2, and ``out`` as B1); the gates ``gate_a`` and
``gate_x`` are block-diagonal (one block per head) and share the conv's
output, so they run as one batched product; the per-channel decay Λ
(``lam``) is an fp32 vector.

RG-LRU recurrence, in fp32:

    r_t = σ(W_a u_t + b_a)          recurrence gate
    i_t = σ(W_x u_t + b_x)          input gate
    a_t = exp(-c · softplus(Λ) · r_t)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t)

A cached step carries (conv history, h): O(1) per row, float or, with the
int8 cache, int8 codes with per-row scales (``qt.pack_state_cache``).  The
recurrence is plain PyTorch, as the reference leaves it to XLA:
``rglru_apply`` and ``rglru_prefill`` loop over the tokens of a chunk (two
elementwise kernels a token on the card).  The cache is updated in place;
a speculative verify collects per-token snapshots and rolls back to any
draft boundary (``rglru_cache_rollback``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, StructureConfig
from repro_torch.core.structures import LinearSpec, make_linear
from repro_torch.models import layers as L
from repro_torch.models import ops
from repro_torch.quant import qarray as qt

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    cfg: ArchConfig
    width: int
    conv_width: int
    c: float
    in_x: LinearSpec      # d_model -> width   (recurrence branch)
    in_gate: LinearSpec   # d_model -> width   (GELU gate branch)
    out: LinearSpec       # width -> d_model
    gate_a: LinearSpec    # width -> width, block-diagonal (per head)
    gate_x: LinearSpec


def make_rglru(cfg: ArchConfig) -> RGLRUSpec:
    r = cfg.rglru
    width = r.lru_width or cfg.d_model
    bd = StructureConfig(kind="block_diag", b=max(cfg.n_heads, 1),
                         keep_ratio=1.0)
    return RGLRUSpec(
        cfg=cfg, width=width, conv_width=r.conv_width, c=r.c,
        in_x=make_linear(cfg.d_model, width, cfg.structure),
        in_gate=make_linear(cfg.d_model, width, cfg.structure),
        out=make_linear(width, cfg.d_model, cfg.structure),
        gate_a=make_linear(width, width, bd),
        gate_x=make_linear(width, width, bd))


def rglru_init(spec: RGLRUSpec, generator: torch.Generator, dtype,
               device) -> Params:
    """Seeded random weights; Λ so that the decay a = exp(-c·softplus(Λ))
    at r = 1 is uniform in a² ∈ (0.9², 0.999²) (Griffin A.2), kept fp32."""
    w = spec.width
    p = {name: L.linear_init(getattr(spec, name), generator, dtype, device,
                             bias=name.startswith("gate"))
         for name in ("in_x", "in_gate", "out", "gate_a", "gate_x")}
    u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * torch.rand(
        (w,), generator=generator, device=generator.device).cpu()
    lam = torch.log(torch.expm1(-torch.log(u) / spec.c))  # softplus⁻¹
    conv_w = torch.zeros((spec.conv_width, w))
    conv_w[-1] = 1.0   # identity-like: the current token passes through
    p.update(conv_w=conv_w.to(device=device, dtype=dtype),
             conv_b=torch.zeros((w,), dtype=dtype, device=device),
             lam=lam.to(device=device, dtype=torch.float32))
    return p


def rglru_quantize(spec: RGLRUSpec, params: Params, bits: int = 8) -> Params:
    """Quantize every structured linear, the block-diagonal gates included
    (conv and Λ stay float: O(width) vectors)."""
    qp = dict(params)
    for name in ("in_x", "in_gate", "out", "gate_a", "gate_x"):
        qp[name] = L.linear_quantize(getattr(spec, name), params[name], bits)
    return qp


def rglru_prestack(spec: RGLRUSpec, params: Params) -> Params:
    """Pre-stack the two grouped bundles once at load: in_gate + in_x on
    the block input, gate_a + gate_x on the conv output."""
    p = dict(params)
    for key, names in (("_bundle_in", ("in_gate", "in_x")),
                       ("_bundle_gate", ("gate_a", "gate_x"))):
        bundle = L.linear_group_prestack(
            tuple(getattr(spec, n) for n in names),
            tuple(params[n] for n in names))
        if bundle is not None:
            p[key] = bundle
    return p


def _branches(spec: RGLRUSpec, params: Params, x: torch.Tensor):
    """(GELU gate branch, pre-conv recurrence branch) of x, one grouped
    launch."""
    gate_pre, u = L.linear_group_apply(
        (spec.in_gate, spec.in_x), (params["in_gate"], params["in_x"]), x,
        bundle=params.get("_bundle_in"))
    return F.gelu(gate_pre, approximate="tanh"), u


def _gated_decay(spec: RGLRUSpec, params: Params, u: torch.Tensor,
                 live: torch.Tensor | None = None):
    """(a, gated input) in fp32 of the conv output u (B, T, W): a = exp(log
    a), gated = sqrt(1 − a²) ⊙ σ(i) ⊙ u.  ``live`` (B, T): dead columns get
    a = 1 and add 0, so they leave h as it was."""
    r, i = L.linear_group_apply(
        (spec.gate_a, spec.gate_x), (params["gate_a"], params["gate_x"]), u,
        bundle=params.get("_bundle_gate"))
    log_a = ((-spec.c * F.softplus(params["lam"]))[None, None, :]
             * torch.sigmoid(r.float()))
    if live is not None:
        log_a = torch.where(live[..., None], log_a, 0.0)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = beta * (torch.sigmoid(i.float()) * u.float())
    if live is not None:
        gated = torch.where(live[..., None], gated, 0.0)
    return a, gated


def _scan(a: torch.Tensor, gated: torch.Tensor,
          h: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + gated_t over the T axis of (B, T, W), from
    h (B, W) → every h_t (B, T, W), fp32.  The reference's
    ``associative_scan`` (full sequence) and ``lax.scan`` (cached steps)
    compute the same recurrence."""
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1)


def _conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv by static shifts, in the reference's order of
    sums: x (B, T, C); w (K, C)."""
    K = w.shape[0]
    y = x * w[-1]
    for k in range(1, K):
        shifted = F.pad(x[:, :-k], (0, 0, k, 0))
        y = y + shifted * w[-1 - k]
    return y + b


def rglru_apply(spec: RGLRUSpec, params: Params, x: torch.Tensor,
                positions: torch.Tensor | None = None) -> torch.Tensor:
    """Full sequence: x (B, T, d_model) → (B, T, d_model) from a zero
    state.  ``positions`` is unused (no positional state), kept for the
    mixers' common signature."""
    gate, u_pre = _branches(spec, params, x)
    u = _conv1d(u_pre, params["conv_w"], params["conv_b"])
    a, gated = _gated_decay(spec, params, u)
    h = _scan(a, gated, torch.zeros_like(gated[:, 0]))
    return L.linear_apply(spec.out, params["out"], h.to(x.dtype) * gate)


def rglru_cache_init(spec: RGLRUSpec, batch: int, max_len: int, dtype,
                     device) -> Params:
    """The recurrent state of ``batch`` rows: ``conv`` (B, K-1, W), each
    row's last K-1 pre-conv inputs, in the model's dtype, and ``h`` (B, W)
    in fp32.  With ``cfg.cache_quant`` both are int8 codes with per-row
    scales (``qt.pack_state_cache``): ``conv_scale`` (B, K-1) bf16,
    ``h_scale`` (B,) fp32.  O(1) in ``max_len``."""
    K1, W = spec.conv_width - 1, spec.width

    def zeros(*shape, dtype_=dtype):
        return torch.zeros((batch, *shape), dtype=dtype_, device=device)

    if spec.cfg.cache_quant:
        return {"conv": zeros(K1, W, dtype_=torch.int8),
                "conv_scale": zeros(K1, dtype_=torch.bfloat16),
                "h": zeros(W, dtype_=torch.int8),
                "h_scale": zeros(dtype_=torch.float32)}
    return {"conv": zeros(K1, W), "h": zeros(W, dtype_=torch.float32)}


def rglru_cache_axes(spec: RGLRUSpec) -> dict[str, tuple]:
    """Logical axis names of ``rglru_cache_init``'s leaves: no ``kv_seq``
    axis, so the paged cache keeps them slot-resident (state leaves)."""
    a = {"conv": ("batch", None, "ffn"), "h": ("batch", "ffn")}
    if spec.cfg.cache_quant:
        a.update(conv_scale=("batch", None), h_scale=("batch",))
    return a


def _store(spec: RGLRUSpec, cache: Params, conv: torch.Tensor,
           h: torch.Tensor) -> None:
    """Write (conv, h) into the cache in place, packed as it stores them."""
    for name, t in qt.pack_state_cache(spec.cfg.cache_quant, conv,
                                       h).items():
        cache[name].copy_(t)


def rglru_prefill(spec: RGLRUSpec, params: Params, cache: Params,
                  x: torch.Tensor, steps, n_tokens: torch.Tensor, *,
                  collect: dict | None = None
                  ) -> tuple[torch.Tensor, Params]:
    """Multi-token cached step: x (B, C, d_model); n_tokens (B,) live tokens
    per row, on x's device.  The projections, the conv and the gates run
    over the whole chunk; the recurrence token by token, each dead column
    with a = 1 and nothing added, so a dead column leaves (conv, h) as it
    was (the reference's per-token ``lax.scan``).  ``steps`` is unused (no
    positional state).  Reads the state through ``qt.unpack_state_cache``
    and writes ``conv`` and ``h`` (an int8 cache: packed again) in place.

    ``collect``: a dict that receives the chunk's per-token state snapshots
    for a speculative verify's rollback (``rglru_cache_rollback``), as the
    reference's ``collect=True`` adds them to its cache: ``h_snap`` (B,
    C+1, W) fp32, index 0 the incoming state, and ``conv_hist`` (B, K-1+C,
    W), the conv history.  They are the chunk's temporaries (a captured
    round keeps them in its graph's memory), not cache leaves."""
    del steps
    C = x.shape[1]
    n = n_tokens.to(device=x.device, dtype=torch.int64)
    live = torch.arange(C, device=x.device)[None, :] < n[:, None]
    conv_prev, h_prev = qt.unpack_state_cache(spec.cfg.cache_quant, cache,
                                              x.dtype)
    gate, u = _branches(spec, params, x)
    u_conv, conv = ops.causal_conv_chunk(conv_prev, u, params["conv_w"],
                                         params["conv_b"], n)
    a, gated = _gated_decay(spec, params, u_conv, live)
    hs = _scan(a, gated, h_prev)
    y = L.linear_apply(spec.out, params["out"], hs.to(x.dtype) * gate)
    if collect is not None:
        collect["h_snap"] = torch.cat([h_prev.float()[:, None], hs], dim=1)
        collect["conv_hist"] = torch.cat([conv_prev, u.to(conv_prev.dtype)],
                                         dim=1)
    _store(spec, cache, conv, hs[:, -1])
    return y, cache


def rglru_cache_rollback(spec: RGLRUSpec, cache: Params, snaps: dict,
                         n_comm: torch.Tensor) -> Params:
    """Rewind, in place, a state written by a chunk that ``rglru_prefill``
    ran with ``collect=snaps`` to its first ``n_comm`` (B,) tokens: ``h``
    is ``h_snap[:, n_comm]`` exactly (dead and rejected columns set a = 1
    and add 0, so a snapshot at a draft boundary equals never having
    drafted), and the conv history's K-1 entries ending there; packed
    again as the reference re-packs (``src/repro/models/rglru.py``:
    ``rglru_cache_rollback``)."""
    h_snap, hist = snaps["h_snap"], snaps["conv_hist"]
    n = n_comm.to(device=h_snap.device, dtype=torch.int64)
    K1 = spec.conv_width - 1
    idx = n[:, None] + torch.arange(K1, device=n.device)[None, :]
    conv = torch.take_along_dim(hist, idx[:, :, None], dim=1)
    h = h_snap[torch.arange(h_snap.shape[0], device=n.device), n]
    _store(spec, cache, conv, h)
    return cache


def rglru_decode(spec: RGLRUSpec, params: Params, cache: Params,
                 x: torch.Tensor, step) -> tuple[torch.Tensor, Params]:
    """Single-token decode: ``rglru_prefill`` with C = 1."""
    B = x.shape[0]
    return rglru_prefill(spec, params, cache, x, step,
                         torch.ones((B,), dtype=torch.int64,
                                    device=x.device))

