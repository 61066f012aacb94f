"""Model layers of the ported slices (counterpart of
``repro/models/layers.py``): linears over any ported structure, norms
(RMSNorm, LayerNorm), the tied embedding, GQA attention (full-sequence,
and chunked prefill over a slot-static float or int8 cache, or over the
ring cache of a sliding-window layer), and the SwiGLU and GELU FFNs.

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
from repro_torch.kernels.flash_attention import kv_bucket
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


def linear_dense_matrix(spec: LinearSpec, params: Params) -> torch.Tensor:
    """The (d_in, d_out) dense matrix of a structured linear: the linear
    applied to an identity of d_in rows in the params' type (a quantized
    linear's: its scales', fp32), as the reference builds it — so it runs
    the linear's own kernel at T = d_in in every storage (W8A8 / W4A8
    quantize the identity's rows as the reference's do).  MLA absorbs its
    up-projections through it every step."""
    p0 = params[next(iter(spec.shapes))]
    dtype, device = ((p0.scale.dtype, p0.q.device) if qt.is_qarray(p0)
                     else (p0.dtype, p0.device))
    eye = torch.eye(spec.d_in, dtype=dtype, device=device)
    return linear_apply(spec, {k: v for k, v in params.items()
                               if k != "bias"}, eye)


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
    """RMSNorm: a zero scale (it scales by 1 + scale); LayerNorm: scale 1,
    bias 0."""
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind != "layernorm":
        raise ValueError(f"unknown norm {kind!r}")
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def norm_apply(params: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return ops.rms_norm(x, params["scale"])
    return ops.layer_norm(x, params["scale"], params["bias"])


# ---------------------------------------------------------------------------
# Ragged chunk geometry (computed once per step, shared by every layer).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ragged:
    """Where a (B, C) chunk's tokens go in one layer's cache.  Column i of
    row b is live iff ``i < n[b]``; its absolute position is ``steps[b] +
    i``, and its cache slot that position (a ring: the position modulo the
    ring's S slots).  Every tensor has a fixed shape and lies on the
    model's device, so a step built on it can be captured as a CUDA graph;
    ``kv_len`` is the host int the attention kernel's launch plan reads
    (a bucket, ``flash_attention.kv_bucket``: a graph fixes it; a ring's is
    at most its S slots)."""
    steps: torch.Tensor     # (B,) int32 — the attention kernel's q_offsets
    n: torch.Tensor         # (B,) int64 — live tokens per row
    q_pos: torch.Tensor     # (B, C) int64 — RoPE positions
    live: torch.Tensor      # (B, C) bool — live columns
    slot: torch.Tensor      # (B, C) int64 — where each column writes
    last: torch.Tensor      # (B,) int64 — each row's last live column
    kv_len: int


def ragged(steps: torch.Tensor, n_tokens: torch.Tensor, C: int, S: int,
           kv_len: int, *, ring: bool = False) -> Ragged:
    """The chunk geometry from device tensors ``steps`` and ``n_tokens``
    (B,), on their device, with no host work, for a cache of ``S`` slots.
    A live column writes its position's slot; a dead one writes slot S,
    the spare slot past the cache's end that ``attn_cache_init`` allocates
    and nothing reads — the fixed-shape form of the reference's write
    (``src/repro/models/layers.py``: ``slot = where(valid, q_pos, S)``,
    whose out-of-bounds writes are dropped).  A live column at a position
    past the cache (a speculative round's verify near ``max_len``, whose
    extra columns are never committed) writes the spare slot too, as the
    reference drops its out-of-range write.  Every write of a step then has
    the shape (B, C), and the S slots end as the reference leaves them.

    ``ring``: a sliding-window layer's ring of S slots.  Column i writes
    slot ``position % S`` if no later live column of its row rewrites that
    slot in the same chunk (``i + S >= n``: the reference's "survives"
    rule), else the spare slot; its kv extent is ``min(kv_len, S)``."""
    st = steps.to(torch.int64)
    n = n_tokens.to(torch.int64)
    offs = torch.arange(C, dtype=torch.int64, device=st.device)
    q_pos = st[:, None] + offs[None, :]
    live = offs[None, :] < n[:, None]
    spare = torch.full_like(q_pos, S)
    if ring:
        survives = live & (offs[None, :] + S >= n[:, None])
        slot = torch.where(survives, q_pos % S, spare)
        kv_len = min(kv_len, S)
    else:
        slot = torch.where(live, q_pos.clamp(max=S), spare)
    return Ragged(steps=st.to(torch.int32), n=n, q_pos=q_pos, live=live,
                  slot=slot, last=(n - 1).clamp(0, C - 1), kv_len=kv_len)


def chunk_inputs(steps, n_tokens, B: int, C: int, max_len: int,
                 device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The host side of a step whose ``steps`` and ``n_tokens`` (default C)
    come as host values: (steps, n_tokens) on ``device`` in one copy, and
    the kv bucket of the largest live position.  Raises where a live
    position is past the ``max_len`` positions the cache was allocated for
    (the device step does not check: an index past a full-length cache
    would fault on the card).  A ring's S slots are no limit: its slots
    wrap."""
    st = torch.as_tensor(steps, dtype=torch.int64).cpu().expand(B)
    n = (torch.full((B,), C, dtype=torch.int64) if n_tokens is None else
         torch.as_tensor(n_tokens, dtype=torch.int64).cpu().expand(B))
    live = n > 0
    need = int((st + n)[live].max()) if bool(live.any()) else 0
    if need > max_len:
        raise ValueError(f"position {need - 1} exceeds the cache's "
                         f"{max_len} positions")
    dev = torch.cat([st, n]).to(device)
    return dev[:B], dev[B:], kv_bucket(need, max_len)


def _with_spare(leaf: torch.Tensor) -> torch.Tensor:
    """A (B, S, ...) cache leaf — the [:, :S] view ``attn_cache_init``
    returns — as (B, S + 1, ...) with its spare slot; a leaf without the
    spare slot makes ``as_strided`` raise (out of its storage's bounds)."""
    B, S = leaf.shape[:2]
    return leaf.as_strided((B, S + 1, *leaf.shape[2:]), leaf.stride(),
                           leaf.storage_offset())


def _put(leaf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """Write (B, C, ...) values into a (B, S, ...) cache leaf in place at
    ``slot`` (B, C); slot S is the spare slot."""
    rows = torch.arange(leaf.shape[0], device=leaf.device)[:, None]
    _with_spare(leaf)[rows, slot] = new.to(leaf.dtype)


def _write(leaf: torch.Tensor, rg: Ragged, new: torch.Tensor) -> None:
    """Write a chunk's (B, C, ...) values into a cache leaf in place, dead
    columns into its spare slot S."""
    _put(leaf, rg.slot, new)


def window_slots(steps: torch.Tensor, C: int, S: int, *,
                 ring: bool = False) -> torch.Tensor:
    """The slots (B, C) of a C-column write window at ``steps`` (B,) in a
    cache of S slots, as ``ragged`` sends a live column there: column i at
    position steps + i; a position past a full-length cache at the spare
    slot S, and in a ring at ``position % S`` (a ring that has wrapped
    writes there, not at a clamped slot)."""
    offs = torch.arange(C, dtype=torch.int64, device=steps.device)
    pos = steps.to(torch.int64)[:, None] + offs[None, :]
    return pos % S if ring else pos.clamp(max=S)


def kv_cache_window(cache: Params, slot: torch.Tensor) -> Params:
    """A copy of what every leaf of a layer's cache holds at ``slot``
    (B, C): what a chunk written there will overwrite."""
    rows = torch.arange(slot.shape[0], device=slot.device)[:, None]
    return {name: _with_spare(leaf)[rows, slot]
            for name, leaf in cache.items()}


def kv_cache_rollback(cache: Params, saved: Params, slot: torch.Tensor,
                      n_comm: torch.Tensor) -> Params:
    """Rewind a layer's cache, in place, to the first ``n_comm`` (B,)
    columns of a chunk written in the window ``slot`` (B, C): every later
    column gets back what ``kv_cache_window`` saved there before the
    chunk — bit-identical to having written only ``n_comm`` tokens.  The
    reference rebuilds its immutable cache instead
    (``src/repro/models/layers.py``: ``where(pos > steps + n_comm - 1, old,
    new)``); writing the pre-chunk values back is its in-place form, and
    stays exact for a ring cache, where a rejected column may have
    overwritten a live slot (a reset to the template would not).  Kept
    columns rewrite the spare slot S."""
    offs = torch.arange(slot.shape[1], device=slot.device)
    back = torch.where(offs[None, :] < n_comm.to(slot.device)[:, None],
                       torch.full_like(slot, cache["pos"].shape[1]), slot)
    for name, leaf in cache.items():
        _put(leaf, back, saved[name])
    return cache


# ---------------------------------------------------------------------------
# GQA attention over a slot-static cache.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    cfg: ArchConfig
    window: int | None
    qkv: LinearSpec
    out: LinearSpec
    # attend over a full-length cache by key position (its ``pos``), not by
    # slot index: a MoE layer routes a step's dead columns too, so their
    # outputs must be the reference's (``attn_prefill``)
    by_position: bool = False

    @property
    def dims(self) -> tuple[int, int, int]:
        c = self.cfg
        return c.n_heads, c.n_kv_heads, c.head_dim_


def make_attention(cfg: ArchConfig, *, window: int | None = None,
                   by_position: bool = False) -> AttnSpec:
    """GQA attention; ``window``: a sliding window of that many keys, whose
    cache is a ring (``attn_cache_init``); ``by_position``: see
    ``AttnSpec``."""
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    # q/k/v stacked and modeled by ONE structured matrix (paper §C.2)
    qkv = make_linear(cfg.d_model, (hq + 2 * hkv) * hd, cfg.structure)
    out = make_linear(hq * hd, cfg.d_model, cfg.structure)
    return AttnSpec(cfg=cfg, window=window, qkv=qkv, out=out,
                    by_position=by_position)


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
    """Slot-static KV cache in the reference layout (B, S, Hkv, D); ``pos``
    is each slot's absolute position, -1 for empty.  S = max_len, or for a
    sliding-window layer a ring of S = min(max_len, window) slots that
    position p writes at p % S.  With ``cfg.cache_quant`` K and V are int8
    codes with per-(slot, head) bf16 scales ``k_scale``, ``v_scale`` (B, S,
    Hkv) — half the bytes of a bf16 cache.  Each leaf is the [:, :S] view
    of a buffer with one spare slot, where a step's dead columns write
    (``ragged``); nothing reads it."""
    hq, hkv, hd = spec.dims
    S = min(max_len, spec.window) if spec.window else max_len

    def leaf(*shape, fill=0, dtype_=dtype):
        return torch.full((batch, S + 1, *shape), fill, dtype=dtype_,
                          device=device)[:, :S]

    c = {"pos": leaf(fill=-1, dtype_=torch.int32)}
    if spec.cfg.cache_quant:
        c.update(k=leaf(hkv, hd, dtype_=torch.int8),
                 v=leaf(hkv, hd, dtype_=torch.int8),
                 k_scale=leaf(hkv, dtype_=torch.bfloat16),
                 v_scale=leaf(hkv, dtype_=torch.bfloat16))
    else:
        c.update(k=leaf(hkv, hd), v=leaf(hkv, hd))
    return c


def attn_cache_axes(spec: AttnSpec) -> dict[str, tuple]:
    """Logical axis names of each leaf ``attn_cache_init`` allocates, as
    the reference names them: the paged cache pages the leaves with a
    ``kv_seq`` axis."""
    a = {"k": ("batch", "kv_seq", "kv_heads", None),
         "v": ("batch", "kv_seq", "kv_heads", None),
         "pos": ("batch", "kv_seq")}
    if spec.cfg.cache_quant:
        a["k_scale"] = ("batch", "kv_seq", "kv_heads")
        a["v_scale"] = ("batch", "kv_seq", "kv_heads")
    return a


def attn_prefill(spec: AttnSpec, params: Params, cache: Params,
                 x: torch.Tensor, steps, n_tokens, *,
                 rg: Ragged | None = None) -> tuple[torch.Tensor, Params]:
    """Multi-token prefill at per-row offsets (the chunked-prefill step).

    x: (B, C, d); steps: (B,) absolute position of each row's first token;
    n_tokens: (B,) live tokens per row (host values, read through
    ``chunk_inputs``, when no ``rg`` is given).  Dead columns leave the
    cache as it was and produce outputs the caller discards.  C=1 with
    n_tokens=1 is single-token decode.

    The full-length cache's attention kernel masks by slot index (slot ==
    absolute position), while the reference masks by the cache's ``pos``.
    The two agree on the live columns because the engine resets a slot's
    row (pos=-1, K=V=0) on admission and every row writes positions
    0..pos contiguously (an int8 cache's row is reset with its scales).

    Dead columns see other keys than the reference's: a dead query past its
    row's last written slot also sees the empty slots up to its own
    position.  A layer whose dead columns count — a MoE layer routes them,
    and they take expert capacity — is built ``by_position``: it attends
    over the cache it just wrote through the ring kernel, by ``pos``, as
    the reference does.  An empty row (an idle one) reads 0 on both sides:
    the kernel returns 0 for a row with no visible key, the reference the
    mean of the row's V, which is 0 since a row is reset when its request
    leaves (ROADMAP C3).

    A sliding-window layer's ring breaks slot == position once it wraps, so
    it attends through the ring kernel, which reads each key's position
    from ``pos`` (``kops.flash_attention_ring``, over int8 K/V
    ``flash_attention_ring_q8``), as the reference does
    (``src/repro/models/layers.py``: ``attn_prefill``).  A chunk (C > 1)
    attends over [the ring before its write ‖ the chunk's own keys], with
    [``pos`` ‖ the chunk's positions, -1 for dead columns] as key
    positions: a later column may overwrite a slot still inside an earlier
    column's window.  A decode step (C = 1) writes first, then attends
    over the ring."""
    cfg = spec.cfg
    hq, hkv, hd = spec.dims
    B, C, _ = x.shape
    if rg is None:
        if spec.window is not None:   # the ring's S slots are not max_len
            raise ValueError("a sliding-window layer's step needs the "
                             "model's max_len: step it through "
                             "LM.prefill_chunk")
        S = cache["pos"].shape[1]
        st, n, kv_len = chunk_inputs(steps, n_tokens, B, C, S, x.device)
        rg = ragged(st, n, C, S, kv_len)
    qkv = linear_apply(spec.qkv, params["qkv"], x)
    q, k, v = _split_qkv(spec, qkv)
    if cfg.pos_embed == "rope":
        q = ops.rope(q, rg.q_pos, cfg.rope_theta)
        k = ops.rope(k, rg.q_pos, cfg.rope_theta)
    if spec.window is not None:
        o = _ring_attention(spec, cache, q, k, v, rg)
        return linear_apply(spec.out, params["out"],
                            o.transpose(1, 2).reshape(B, C, hq * hd)), cache
    # fixed-shape in-place writes, dead columns into the spare slot
    _write(cache["pos"], rg, rg.q_pos)
    if cfg.cache_quant:
        # the chunk's rows quantized on the card; attention reads the
        # cache it just wrote through its codes and scales
        for name, t in (("k", k), ("v", v)):
            codes, scales = qt.quantize_rows(t)
            _write(cache[name], rg, codes)
            _write(cache[f"{name}_scale"], rg, scales)
    else:
        _write(cache["k"], rg, k)
        _write(cache["v"], rg, v)
    # the cache is read through strides as (B, Hkv, S, D): no copy.  No
    # live query sees a slot past the largest live one, so kv_len (a bucket
    # at or past it) only cuts the key range the launch plan splits (dead
    # columns' outputs change; the caller discards them)
    kv = (q.transpose(1, 2), cache["k"].permute(0, 2, 1, 3),
          cache["v"].permute(0, 2, 1, 3))
    if spec.by_position and cfg.cache_quant:
        o = kops.flash_attention_ring_q8(
            *kv, cache["k_scale"].transpose(1, 2),
            cache["v_scale"].transpose(1, 2), cache["pos"], rg.steps,
            window=None, kv_len=rg.kv_len)
    elif spec.by_position:
        o = kops.flash_attention_ring(*kv, cache["pos"], rg.steps,
                                      window=None, kv_len=rg.kv_len)
    elif cfg.cache_quant:
        o = kops.flash_attention_prefill_q8(
            *kv, cache["k_scale"].transpose(1, 2),
            cache["v_scale"].transpose(1, 2), rg.steps, causal=True,
            window=spec.window, kv_len=rg.kv_len)
    else:
        o = kops.flash_attention_prefill(
            *kv, rg.steps, causal=True, window=spec.window, kv_len=rg.kv_len)
    y = linear_apply(spec.out, params["out"],
                     o.transpose(1, 2).reshape(B, C, hq * hd))
    return y, cache


def _ring_attention(spec: AttnSpec, cache: Params, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor,
                    rg: Ragged) -> torch.Tensor:
    """Write a chunk's (B, C, H, D) K/V into a ring cache in place and
    attend (``attn_prefill``): (B, Hq, C, D).  Only the ring's first
    ``rg.kv_len`` slots can hold a key (before it wraps, slot ==
    position).  Over an int8 ring the chunk's rows are quantized first
    (``qt.quantize_rows``) and written as codes and scales; a chunk attends
    to its own keys through those codes, as the reference reads them
    through the same int8 round trip, and the kernel reads codes and scales
    (``kops.flash_attention_ring_q8``)."""
    ext = rg.kv_len
    C = q.shape[1]
    new = {"pos": rg.q_pos}
    if spec.cfg.cache_quant:
        for name, t in (("k", k), ("v", v)):
            new[name], new[f"{name}_scale"] = qt.quantize_rows(t)
    else:
        new.update(k=k, v=v)
    if C > 1:
        # [ring before the write ‖ chunk], copied before the write
        new_pos = torch.where(rg.live, rg.q_pos, -1)
        keys = {name: torch.cat([cache[name][:, :ext],
                                 (new_pos if name == "pos" else t).to(
                                     cache[name].dtype)], dim=1)
                for name, t in new.items()}
    for name, t in new.items():
        _write(cache[name], rg, t)
    if C == 1:
        keys = cache
    kv = (q.transpose(1, 2), keys["k"].permute(0, 2, 1, 3),
          keys["v"].permute(0, 2, 1, 3))
    opts = dict(window=spec.window, kv_len=ext + (C if C > 1 else 0))
    if spec.cfg.cache_quant:
        return kops.flash_attention_ring_q8(
            *kv, keys["k_scale"].transpose(1, 2),
            keys["v_scale"].transpose(1, 2), keys["pos"], rg.steps, **opts)
    return kops.flash_attention_ring(*kv, keys["pos"], rg.steps, **opts)


def attn_decode(spec: AttnSpec, params: Params, cache: Params,
                x: torch.Tensor, step) -> tuple[torch.Tensor, Params]:
    """Single-token decode: ``attn_prefill`` with C=1."""
    B = x.shape[0]
    return attn_prefill(spec, params, cache, x, step,
                        torch.ones((B,), dtype=torch.int64))


# ---------------------------------------------------------------------------
# Feed-forward: SwiGLU (gate, up, wo) or GELU (wi, wo).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    """SwiGLU: gate and up are two congruent (d → ff) linears sharing the
    input, dispatched as ONE grouped kernel launch.  GELU keeps the single
    ``wi`` (tanh approximation, as ``jax.nn.gelu``'s default)."""
    kind: str                        # swiglu | gelu
    wo: LinearSpec
    wi: LinearSpec | None = None
    gate: LinearSpec | None = None
    up: LinearSpec | None = None

    @property
    def in_specs(self) -> tuple[LinearSpec, ...]:
        return (self.gate, self.up) if self.kind == "swiglu" else (self.wi,)

    @property
    def names(self) -> tuple[str, ...]:
        return ("gate", "up", "wo") if self.kind == "swiglu" else ("wi", "wo")


def make_ffn(d_model: int, d_ff: int, kind: str,
             structure: StructureConfig) -> FFNSpec:
    wo = make_linear(d_ff, d_model, structure)
    if kind == "swiglu":
        return FFNSpec(kind=kind, wo=wo,
                       gate=make_linear(d_model, d_ff, structure),
                       up=make_linear(d_model, d_ff, structure))
    if kind != "gelu":
        raise NotImplementedError(f"ffn {kind!r} is not ported yet")
    return FFNSpec(kind=kind, wo=wo, wi=make_linear(d_model, d_ff, structure))


def ffn_init(spec: FFNSpec, generator: torch.Generator, dtype, device,
             n_layers: int = 1) -> Params:
    wo_scale = 1.0 / math.sqrt(2 * n_layers * spec.wo.d_in)
    return {name: linear_init(getattr(spec, name), generator, dtype, device,
                              scale=wo_scale if name == "wo" else None)
            for name in spec.names}


def ffn_quantize(spec: FFNSpec, params: Params, bits: int = 8) -> Params:
    return {name: linear_quantize(getattr(spec, name), params[name], bits)
            for name in spec.names}


def ffn_prestack(spec: FFNSpec, params: Params) -> Params:
    """Pre-stack the SwiGLU gate+up bundle once at load (GELU: none)."""
    if spec.kind != "swiglu":
        return params
    b = linear_group_prestack((spec.gate, spec.up),
                              (params["gate"], params["up"]))
    return {**params, "_bundle_in": b} if b is not None else params


def ffn_apply(spec: FFNSpec, params: Params, x: torch.Tensor) -> torch.Tensor:
    if spec.kind == "swiglu":
        gate, up = linear_group_apply((spec.gate, spec.up),
                                      (params["gate"], params["up"]), x,
                                      bundle=params.get("_bundle_in"))
        h = F.silu(gate) * up
    else:
        h = F.gelu(linear_apply(spec.wi, params["wi"], x), approximate="tanh")
    return linear_apply(spec.wo, params["wo"], h)
