"""Mixture-of-Experts FFN of the moe family (counterpart of
``repro/models/moe.py``, its single-device path): top-k routing,
capacity-based dispatch into an (E, C, d) buffer, the experts as one
batched BLAST launch per projection, the gate-weighted combine, and
DeepSeek's shared expert added to it.

  * The router is a dense fp32 linear; softmax, top-k (ties to the lower
    expert id, as ``jax.lax.top_k``), the gates renormalized over the k
    chosen with a 1e-9 floor, then cast to the input's type.
  * Capacity ``C = max(1, ceil(Tl·k·cf / E))`` over every token of the
    call — a serving step's dead columns and idle rows included, as the
    reference routes them, so the port routes exactly the (B, C) tokens
    the reference's step routes.  A token's position in its expert is its
    rank among the expert's assignments in token order (a stable argsort
    and a searchsorted, no (Tl·k × E) one-hot); assignments at or past
    the capacity are dropped: they are written to a sink column of an
    (E, C + 1) table, which is sliced off (the reference's scatter with
    ``mode="drop"``), and they add nothing to their token's output.
  * The experts run as one ``structures.stacked_apply`` per projection —
    one batched launch each of ``wi`` (gate ‖ up fused) and ``wo``, every
    expert on its own C rows (``kernels/ops.blast_matmul_batched`` and its
    int8/int4/W8A8/W4A8 twins).
  * Every step here has a fixed shape and no host sync (no ``.item()``,
    no ``nonzero``), so a serving step or a training step that holds it is
    captured as one CUDA graph.
  * Training: gradients flow as in the reference — through the gates (the
    sorted probabilities, the renormalization) and ``aux``'s mean of
    probabilities to the router, through the gather and the combine to
    the tokens, through the batched launches (``BlastMatmulBatchedFn``) to
    the experts — and not through the expert ids, the counts or the
    dispatch indices; a dropped assignment gets zero gradient.

  * A shared expert (``n_shared · d_shared`` wide, DeepSeek's) is a SwiGLU
    FFN every token takes (``layers.ffn_apply``: gate+up as one grouped
    launch, then ``wo``), its ``wo`` drawn at 1/sqrt(2·n_layers·d_in),
    quantized and pre-stacked with the routed experts, its output added to
    the routed one.  The first dense layers are the model's
    (``transformer.LM``).

Expert parallelism over a mesh (the reference's ``shard_map`` with two
``all_to_all``) waits for ROADMAP A9.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoECfg
from repro_torch.core import structures
from repro_torch.core.structures import LinearSpec, make_linear
from repro_torch.models import layers as L

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    cfg: ArchConfig
    moe: MoECfg
    router: LinearSpec           # d -> E (dense, fp32)
    wi: LinearSpec               # per-expert d -> 2·d_expert (SwiGLU fused)
    wo: LinearSpec               # per-expert d_expert -> d
    shared: L.FFNSpec | None = None   # DeepSeek's shared expert(s)


def make_moe(cfg: ArchConfig) -> MoESpec:
    m = cfg.moe
    st = cfg.ffn_structure
    shared = None
    if m.n_shared:
        shared = L.make_ffn(cfg.d_model, m.n_shared * m.d_shared,
                            cfg.ffn_kind, st)
    return MoESpec(cfg=cfg, moe=m,
                   router=make_linear(cfg.d_model, m.n_experts,
                                      structured=False),
                   wi=make_linear(cfg.d_model, 2 * m.d_expert, st),
                   wo=make_linear(m.d_expert, cfg.d_model, st),
                   shared=shared)


def moe_init(spec: MoESpec, generator: torch.Generator, dtype,
             device) -> Params:
    """Seeded weights: the router in fp32, each expert's ``wi`` and ``wo``
    drawn in turn and stacked on a leading E axis, then the shared
    expert."""
    E = spec.moe.n_experts
    wo_scale = 1.0 / math.sqrt(2 * spec.cfg.n_layers * spec.wo.d_in)
    p = {
        "router": L.linear_init(spec.router, generator, torch.float32,
                                device),
        "wi": structures.stacked_init(spec.wi, generator, E, dtype, device),
        "wo": structures.stacked_init(spec.wo, generator, E, dtype, device,
                                      scale=wo_scale),
    }
    if spec.shared is not None:
        p["shared"] = L.ffn_init(spec.shared, generator, dtype, device,
                                 spec.cfg.n_layers)
    return p


def moe_quantize(spec: MoESpec, params: Params, bits: int = 8) -> Params:
    """Quantize the expert linears, each expert's blocks on their own (the
    reference's ``jax.vmap`` of ``linear_quantize``: equal codes and
    scales).  The router stays float: it is tiny and routing decisions
    are precision-sensitive.  A shared expert is quantized as an FFN."""
    qp = {**params,
          "wi": structures.stacked_quantize(spec.wi, params["wi"], bits),
          "wo": structures.stacked_quantize(spec.wo, params["wo"], bits)}
    if spec.shared is not None:
        qp["shared"] = L.ffn_quantize(spec.shared, params["shared"], bits)
    return qp


def moe_prestack(spec: MoESpec, params: Params) -> Params:
    """Pre-stack the shared expert's gate+up bundle, as the reference does
    (the routed experts have none): the identity without a shared
    expert."""
    if spec.shared is None:
        return params
    return {**params, "shared": L.ffn_prestack(spec.shared,
                                               params["shared"])}


# -- dispatch math -----------------------------------------------------------


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest probabilities of each row and their expert ids, in
    descending order, equal values in ascending id order (a stable sort:
    ``jax.lax.top_k``'s order; ``torch.topk`` does not promise one)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(spec: MoESpec, router_p: Params, x2d: torch.Tensor):
    """x2d (Tl, d) → gates (Tl, k) in x's type, expert ids (Tl, k) int64,
    the Switch-style load-balance loss ``E · Σ_e f_e · P_e`` (fp32)."""
    m = spec.moe
    logits = L.linear_apply(spec.router, router_p, x2d.float())
    probs = torch.softmax(logits, dim=-1)                      # (Tl, E)
    gates, eidx = _top_k(probs, m.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    f = torch.zeros((m.n_experts,), dtype=torch.float32,
                    device=x2d.device).index_add_(
        0, eidx.reshape(-1), torch.ones((eidx.numel(),),
                                        dtype=torch.float32,
                                        device=x2d.device))
    f = f / (x2d.shape[0] * m.top_k)
    aux = m.n_experts * torch.sum(f * probs.mean(dim=0))
    return gates.to(x2d.dtype), eidx, aux


def _positions_in_expert(eidx_flat: torch.Tensor,
                         n_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, in assignment order:
    eidx_flat (N,) → pos (N,) int64."""
    N = eidx_flat.shape[0]
    order = torch.argsort(eidx_flat, stable=True)              # by expert
    sorted_e = eidx_flat[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=eidx_flat.device))
    rank = torch.arange(N, device=eidx_flat.device) - seg_start[sorted_e]
    return torch.empty_like(rank).scatter_(0, order, rank)


def _dispatch_indices(eidx: torch.Tensor, n_experts: int, capacity: int):
    """→ slot_token (E, C) source row in the (Tl·k) assignment list (-1
    empty), pos (Tl, k) position in its expert, keep (Tl, k) within
    capacity.  An assignment past the capacity writes the sink column C of
    an (E, C + 1) table, which is dropped: no write lands on a live
    slot."""
    Tl, k = eidx.shape
    flat = eidx.reshape(-1)
    pos = _positions_in_expert(flat, n_experts)
    keep = pos < capacity
    table = torch.full((n_experts, capacity + 1), -1, dtype=torch.int64,
                       device=eidx.device)
    table[flat, torch.where(keep, pos, capacity)] = torch.arange(
        Tl * k, device=eidx.device)
    return table[:, :capacity], pos.reshape(Tl, k), keep.reshape(Tl, k)


def _gather(x2d: torch.Tensor, slot_token: torch.Tensor,
            top_k: int) -> torch.Tensor:
    """The dispatch buffer (E, C, d): slot (e, c) holds its assignment's
    token row, an empty slot a zero row."""
    valid = slot_token >= 0
    src = torch.where(valid, slot_token, 0) // top_k
    return x2d[src] * valid[..., None].to(x2d.dtype)


def _expert_ffn(spec: MoESpec, params: Params,
                xe: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) → (E, C, d): every expert's SwiGLU on its own rows, one
    batched launch per projection."""
    h = structures.stacked_apply(spec.wi, params["wi"], xe)
    gate, up = h.chunk(2, dim=-1)
    return structures.stacked_apply(spec.wo, params["wo"],
                                    F.silu(gate) * up)


def _combine(ye: torch.Tensor, gates: torch.Tensor, eidx: torch.Tensor,
             pos: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """y_t = Σ_k gate · ye[e_k, pos_k] over the kept assignments: (Tl, d)."""
    safe = pos.clamp(max=ye.shape[1] - 1)
    yk = ye[eidx, safe]                                        # (Tl, k, d)
    w = (gates * keep.to(gates.dtype))[..., None]
    return torch.sum(yk * w, dim=1)


def moe_apply(spec: MoESpec, params: Params, x: torch.Tensor,
              mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) → (y (B, T, d), aux loss (fp32 scalar)), every token of
    the call routed together (capacity over B·T); a shared expert's output
    added."""
    if mesh is not None:
        raise NotImplementedError("expert parallelism over a mesh is not "
                                  "ported yet (ROADMAP A9)")
    m = spec.moe
    B, T, d = x.shape
    Tl = B * T
    x2d = x.reshape(Tl, d)
    gates, eidx, aux = _route(spec, params["router"], x2d)
    capacity = max(1, int(math.ceil(Tl * m.top_k * m.capacity_factor
                                    / m.n_experts)))
    slot_token, pos, keep = _dispatch_indices(eidx, m.n_experts, capacity)
    ye = _expert_ffn(spec, params, _gather(x2d, slot_token, m.top_k))
    y = _combine(ye, gates, eidx, pos, keep).reshape(B, T, d)
    if spec.shared is not None:
        y = y + L.ffn_apply(spec.shared, params["shared"], x)
    return y, aux
