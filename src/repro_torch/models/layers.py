"""Model layers of the ported slices (counterpart of
``repro/models/layers.py``): linears over any ported structure, norms, the
tied embedding, GQA attention (full-sequence, and chunked prefill over a
slot-static cache), and the SwiGLU FFN.

Parameters are plain dicts of tensors with the reference's key names.
Caches are updated in place (the reference returns new immutable arrays);
every function that writes a cache also returns it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, StructureConfig
from repro_torch.core import structures
from repro_torch.core.structures import LinearSpec, make_linear
from repro_torch.kernels import ops as kops
from repro_torch.models import ops
from repro_torch.quant import qarray as qt

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# Linears, embeddings, norms.
# ---------------------------------------------------------------------------


def linear_init(spec: LinearSpec, generator: torch.Generator, dtype, device, *,
                scale=None, bias: bool = False) -> Params:
    p = spec.init(generator, dtype=dtype, device=device, scale=scale)
    if bias:
        p["bias"] = torch.zeros((spec.d_out,), dtype=dtype, device=device)
    return p


def linear_apply(spec: LinearSpec, params: Params,
                 x: torch.Tensor) -> torch.Tensor:
    """Storage-aware apply: int8 and int4 QArray params route to the
    structure's ``apply_q``, float params to ``apply``; mixed storage
    raises."""
    structures.record_dispatch(1)
    core = {k: v for k, v in params.items() if k != "bias"}
    if structures.check_storage(core) != "float":
        y = spec.apply_q(core, x)
    else:
        y = spec.apply(core, x)
    if "bias" in params:
        y = y + params["bias"]
    return y


def linear_group_apply(specs: Sequence[LinearSpec],
                       params_list: Sequence[Params], x: torch.Tensor,
                       bundle=None) -> list[torch.Tensor]:
    """Apply same-input linears, collapsing a congruent BLAST bundle into one
    grouped kernel launch; anything else loops per projection.  ``bundle``:
    an optional ``structures.GroupBundle`` from ``prestack``; a stale bundle
    (plan mismatch) is ignored."""
    plan = structures.group_plan(specs, params_list)
    if plan is None:
        return [linear_apply(s, p, x) for s, p in zip(specs, params_list)]
    core = [{k: v for k, v in p.items() if k != "bias"} for p in params_list]
    stacked = None
    if isinstance(bundle, structures.GroupBundle) and bundle.plan == plan:
        stacked = bundle.arrays
    ys = structures.group_apply(specs, core, x, plan=plan, stacked=stacked)
    return [y + p["bias"] if "bias" in p else y
            for y, p in zip(ys, params_list)]


def linear_group_prestack(specs: Sequence[LinearSpec],
                          params_list: Sequence[Params]):
    return structures.prestack(specs, params_list)


def linear_quantize(spec: LinearSpec, params: Params, bits: int = 8) -> Params:
    """Quantize a linear's structure params to per-block QArrays (a bias
    stays float: it is O(d_out) and added after the product)."""
    qp = spec.quantize({k: v for k, v in params.items() if k != "bias"}, bits)
    if "bias" in params:
        qp["bias"] = params["bias"]
    return qp


def embed_lookup(table, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token-embedding gather over a float or per-row int8/int4 table: a
    quantized table gathers the stored rows first (int4 rows still
    nibble-packed) and unpacks and dequantizes only those, never the
    whole table."""
    if not qt.is_qarray(table):
        structures.check_storage({"embed": table})
        return table[tokens].to(dtype)
    rows = table.q[tokens]
    if table.bits == 4:
        rows = qt.unpack_int4(rows, table.last_dim)
    return (rows.float() * table.scale[tokens]).to(dtype)


def tied_logits(table, x: torch.Tensor) -> torch.Tensor:
    """``x @ embedᵀ`` over a float or per-row int8/int4 table — a plain
    large product, left to torch.matmul as the reference leaves it to XLA.
    An int4 table is unpacked for the product and no unpacked copy is
    kept.  The per-row scales are constant along d_model, so they multiply
    the product (one multiply per logit)."""
    if not qt.is_qarray(table):
        return x @ table.T
    iv = qt.int_values(table)                        # (vocab, d)
    return ((x @ iv.T.to(x.dtype)) * table.scale[:, 0]).to(x.dtype)


def norm_init(d: int, kind: str, dtype, device) -> Params:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def norm_apply(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    return ops.rms_norm(x, params["scale"])


# ---------------------------------------------------------------------------
# Ragged chunk geometry (computed once per step, shared by every layer).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ragged:
    """Where a (B, C) chunk's live tokens go.  Column i of row b is live iff
    ``i < n_tokens[b]``; its absolute position (and cache slot) is
    ``steps[b] + i``.  All tensors are on the model's device."""
    steps: torch.Tensor     # (B,) int32 — the attention kernel's q_offsets
    q_pos: torch.Tensor     # (B, C) int64 — RoPE positions
    rows: torch.Tensor      # (L,) int64 — live (row, column, slot) triples
    cols: torch.Tensor      # (L,)
    slots: torch.Tensor     # (L,)
    last: torch.Tensor      # (B,) int64 — each row's last live column
    max_slot: int           # host copy: largest live slot (-1 if none)


def ragged(steps, n_tokens, B: int, C: int, device) -> Ragged:
    """Build the chunk geometry on the host (``steps``/``n_tokens`` come from
    the scheduler) and move it to ``device`` in one copy."""
    st = torch.as_tensor(steps, dtype=torch.int64).cpu().expand(B).contiguous()
    n = (torch.full((B,), C, dtype=torch.int64) if n_tokens is None else
         torch.as_tensor(n_tokens, dtype=torch.int64).cpu().expand(B))
    offs = torch.arange(C, dtype=torch.int64)
    rows, cols = (offs[None, :] < n[:, None]).nonzero(as_tuple=True)
    slots = st[rows] + cols
    q_pos = st[:, None] + offs[None, :]
    last = (n - 1).clamp(0, C - 1)
    L = rows.numel()
    packed = torch.cat([st, q_pos.reshape(-1), rows, cols, slots, last])
    dev = packed.to(device)
    parts = torch.split(dev, [B, B * C, L, L, L, B])
    return Ragged(steps=parts[0].to(torch.int32), q_pos=parts[1].view(B, C),
                  rows=parts[2], cols=parts[3], slots=parts[4], last=parts[5],
                  max_slot=int(slots.max()) if L else -1)


# ---------------------------------------------------------------------------
# GQA attention over a slot-static cache.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    cfg: ArchConfig
    window: int | None
    qkv: LinearSpec
    out: LinearSpec

    @property
    def dims(self) -> tuple[int, int, int]:
        c = self.cfg
        return c.n_heads, c.n_kv_heads, c.head_dim_


def make_attention(cfg: ArchConfig, *, window: int | None = None) -> AttnSpec:
    if window is not None:
        raise NotImplementedError("sliding-window ring caches are not ported "
                                  "yet (ROADMAP A13)")
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    # q/k/v stacked and modeled by ONE structured matrix (paper §C.2)
    qkv = make_linear(cfg.d_model, (hq + 2 * hkv) * hd, cfg.structure)
    out = make_linear(hq * hd, cfg.d_model, cfg.structure)
    return AttnSpec(cfg=cfg, window=window, qkv=qkv, out=out)


def attn_init(spec: AttnSpec, generator: torch.Generator, dtype,
              device) -> Params:
    return {
        "qkv": linear_init(spec.qkv, generator, dtype, device,
                           bias=spec.cfg.qkv_bias),
        "out": linear_init(spec.out, generator, dtype, device,
                           scale=1.0 / math.sqrt(2 * spec.cfg.n_layers
                                                 * spec.out.d_in)),
    }


def attn_quantize(spec: AttnSpec, params: Params, bits: int = 8) -> Params:
    return {"qkv": linear_quantize(spec.qkv, params["qkv"], bits),
            "out": linear_quantize(spec.out, params["out"], bits)}


def _split_qkv(spec: AttnSpec, qkv: torch.Tensor):
    """Feature order q | k | v."""
    hq, hkv, hd = spec.dims
    *lead, _ = qkv.shape
    q = qkv[..., : hq * hd].reshape(*lead, hq, hd)
    k = qkv[..., hq * hd: (hq + hkv) * hd].reshape(*lead, hkv, hd)
    v = qkv[..., (hq + hkv) * hd:].reshape(*lead, hkv, hd)
    return q, k, v


def attn_apply(spec: AttnSpec, params: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence self-attention (training / prefill): x (B, T, d),
    positions (T,) or (B, T) → (B, T, d).  q, k and v reach the kernel as
    strided (B, H, T, D) views of the RoPE outputs and of the projection's
    output (no transposed copy), and its token-major output reshapes for
    free into the out projection."""
    cfg = spec.cfg
    hq, hkv, hd = spec.dims
    B, T, _ = x.shape
    qkv = linear_apply(spec.qkv, params["qkv"], x)    # (B, T, (hq+2hkv)·hd)
    q, k, v = _split_qkv(spec, qkv)
    if cfg.pos_embed == "rope":
        q = ops.rope(q, positions, cfg.rope_theta)
        k = ops.rope(k, positions, cfg.rope_theta)
    o = ops.chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        window=spec.window, q_chunk=cfg.q_chunk)
    o = o.transpose(1, 2).reshape(B, T, hq * hd)
    return linear_apply(spec.out, params["out"], o)


def attn_cache_init(spec: AttnSpec, batch: int, max_len: int, dtype,
                    device) -> Params:
    """Slot-static float KV cache in the reference layout (B, S, Hkv, D);
    ``pos`` is each slot's absolute position, -1 for empty."""
    hq, hkv, hd = spec.dims
    return {"pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device),
            "k": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, hkv, hd), dtype=dtype,
                             device=device)}


def attn_prefill(spec: AttnSpec, params: Params, cache: Params,
                 x: torch.Tensor, steps, n_tokens, *,
                 rg: Ragged | None = None) -> tuple[torch.Tensor, Params]:
    """Multi-token prefill at per-row offsets (the chunked-prefill step).

    x: (B, C, d); steps: (B,) absolute position of each row's first token;
    n_tokens: (B,) live tokens per row.  Dead columns are dropped from the
    cache write and produce outputs the caller discards.  C=1 with
    n_tokens=1 is single-token decode.

    The attention kernel masks by slot index (slot == absolute position),
    while the reference masks by the cache's ``pos``.  The two agree on the
    live columns because the engine resets a slot's row (pos=-1, K=V=0) on
    admission and every row writes positions 0..pos contiguously."""
    cfg = spec.cfg
    hq, hkv, hd = spec.dims
    B, C, _ = x.shape
    if rg is None:
        rg = ragged(steps, n_tokens, B, C, x.device)
    S = cache["k"].shape[1]
    if rg.max_slot >= S:
        raise ValueError(f"position {rg.max_slot} exceeds the cache's {S} "
                         "slots")
    qkv = linear_apply(spec.qkv, params["qkv"], x)
    q, k, v = _split_qkv(spec, qkv)
    if cfg.pos_embed == "rope":
        q = ops.rope(q, rg.q_pos, cfg.rope_theta)
        k = ops.rope(k, rg.q_pos, cfg.rope_theta)
    # Ragged write: an in-place index_put_ on the live columns only — the
    # reference's out-of-bounds scatter with mode="drop" skips the dead ones.
    cache["k"][rg.rows, rg.slots] = k[rg.rows, rg.cols].to(cache["k"].dtype)
    cache["v"][rg.rows, rg.slots] = v[rg.rows, rg.cols].to(cache["v"].dtype)
    cache["pos"][rg.rows, rg.slots] = rg.slots.to(torch.int32)
    # the cache is read through strides as (B, Hkv, S, D): no copy.  No
    # live query sees a slot past the largest live one, so kv_len stops
    # there: the kernel's launch plan then sees the live key range from the
    # host (dead columns' outputs change; the caller discards them)
    o = kops.flash_attention_prefill(
        q.transpose(1, 2), cache["k"].permute(0, 2, 1, 3),
        cache["v"].permute(0, 2, 1, 3), rg.steps, causal=True,
        window=spec.window, kv_len=rg.max_slot + 1)
    y = linear_apply(spec.out, params["out"],
                     o.transpose(1, 2).reshape(B, C, hq * hd))
    return y, cache


def attn_decode(spec: AttnSpec, params: Params, cache: Params,
                x: torch.Tensor, step) -> tuple[torch.Tensor, Params]:
    """Single-token decode: ``attn_prefill`` with C=1."""
    B = x.shape[0]
    return attn_prefill(spec, params, cache, x, step,
                        torch.ones((B,), dtype=torch.int64))


# ---------------------------------------------------------------------------
# SwiGLU feed-forward.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    """gate and up are two congruent (d → ff) linears sharing the input:
    they dispatch as ONE grouped kernel launch."""
    kind: str
    wo: LinearSpec
    gate: LinearSpec
    up: LinearSpec

    @property
    def in_specs(self) -> tuple[LinearSpec, ...]:
        return (self.gate, self.up)


def make_ffn(d_model: int, d_ff: int, kind: str,
             structure: StructureConfig) -> FFNSpec:
    if kind != "swiglu":
        raise NotImplementedError(f"ffn {kind!r} is not ported yet")
    return FFNSpec(kind=kind, wo=make_linear(d_ff, d_model, structure),
                   gate=make_linear(d_model, d_ff, structure),
                   up=make_linear(d_model, d_ff, structure))


def ffn_init(spec: FFNSpec, generator: torch.Generator, dtype, device,
             n_layers: int = 1) -> Params:
    wo_scale = 1.0 / math.sqrt(2 * n_layers * spec.wo.d_in)
    return {"gate": linear_init(spec.gate, generator, dtype, device),
            "up": linear_init(spec.up, generator, dtype, device),
            "wo": linear_init(spec.wo, generator, dtype, device,
                              scale=wo_scale)}


def ffn_quantize(spec: FFNSpec, params: Params, bits: int = 8) -> Params:
    return {name: linear_quantize(getattr(spec, name), params[name], bits)
            for name in ("gate", "up", "wo")}


def ffn_prestack(spec: FFNSpec, params: Params) -> Params:
    """Pre-stack the gate+up bundle once at load."""
    b = linear_group_prestack((spec.gate, spec.up),
                              (params["gate"], params["up"]))
    return {**params, "_bundle_in": b} if b is not None else params


def ffn_apply(spec: FFNSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    gate, up = linear_group_apply((spec.gate, spec.up),
                                  (params["gate"], params["up"]), x,
                                  bundle=params.get("_bundle_in"))
    return linear_apply(spec.wo, params["wo"], F.silu(gate) * up)
