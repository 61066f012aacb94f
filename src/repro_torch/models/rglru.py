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

A cached step carries (conv history, h): O(1) per row.  The recurrence is
plain PyTorch, as the reference leaves it to XLA: ``rglru_apply`` and
``rglru_prefill`` loop over the tokens of a chunk (two elementwise kernels
a token on the card).  The cache is updated in place.
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
    u = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * torch.rand((w,),
                                                         generator=generator)
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
    in fp32.  O(1) in ``max_len``."""
    if spec.cfg.cache_quant:
        raise NotImplementedError("the int8 RG-LRU state cache is not ported "
                                  "yet (ROADMAP A7)")
    return {"conv": torch.zeros((batch, spec.conv_width - 1, spec.width),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, spec.width), dtype=torch.float32,
                             device=device)}


def rglru_cache_axes(spec: RGLRUSpec) -> dict[str, tuple]:
    """Logical axis names of ``rglru_cache_init``'s leaves: no ``kv_seq``
    axis (the paged cache refuses such a leaf)."""
    return {"conv": ("batch", None, "ffn"), "h": ("batch", "ffn")}


def rglru_prefill(spec: RGLRUSpec, params: Params, cache: Params,
                  x: torch.Tensor, steps, n_tokens: torch.Tensor
                  ) -> tuple[torch.Tensor, Params]:
    """Multi-token cached step: x (B, C, d_model); n_tokens (B,) live tokens
    per row, on x's device.  The projections, the conv and the gates run
    over the whole chunk; the recurrence token by token, each dead column
    with a = 1 and nothing added, so a dead column leaves (conv, h) as it
    was (the reference's per-token ``lax.scan``).  ``steps`` is unused (no
    positional state).  Writes ``conv`` and ``h`` in place."""
    del steps
    C = x.shape[1]
    n = n_tokens.to(device=x.device, dtype=torch.int64)
    live = torch.arange(C, device=x.device)[None, :] < n[:, None]
    gate, u = _branches(spec, params, x)
    u_conv, conv = ops.causal_conv_chunk(cache["conv"], u, params["conv_w"],
                                         params["conv_b"], n)
    a, gated = _gated_decay(spec, params, u_conv, live)
    hs = _scan(a, gated, cache["h"])
    y = L.linear_apply(spec.out, params["out"], hs.to(x.dtype) * gate)
    cache["conv"].copy_(conv)
    cache["h"].copy_(hs[:, -1])
    return y, cache


def rglru_decode(spec: RGLRUSpec, params: Params, cache: Params,
                 x: torch.Tensor, step) -> tuple[torch.Tensor, Params]:
    """Single-token decode: ``rglru_prefill`` with C = 1."""
    B = x.shape[0]
    return rglru_prefill(spec, params, cache, x, step,
                         torch.ones((B,), dtype=torch.int64,
                                    device=x.device))

