"""Multi-head latent attention of DeepSeek-V3 (counterpart of the MLA part
of ``repro/models/layers.py``).

  * The q path is low-rank: ``wq_a`` (d → q_lora), RMSNorm, ``wq_b``
    (q_lora → H·(nope + rope)).  The kv path keeps one latent a token:
    ``wkv_a`` (d → kv_lora + rope) gives the latent (RMSNorm'd) and one
    RoPE key every head shares.  ``wq_a`` and ``wkv_a`` share their input
    and run as one grouped launch (B2), padded to the larger output.
  * ``mla_apply`` (``LM.apply``): the latent expanded by ``wkv_b`` to
    per-head K (nope ‖ the shared rope key, 192 dims) and V (128), then
    full-sequence attention (B4), V zero-padded to K's 192 dims and the pad
    sliced off (exact; B4's scale 1/sqrt(192) is the reference's).  Forward
    only: its backward comes with MLA training (ROADMAP A11).
  * ``mla_prefill`` (the serving step): the cache holds only the latent and
    the rope key a token (``{latent, k_rope, pos}``, or int8 codes with
    bf16 per-(row, slot) scales), written through the spare-slot
    convention (``layers.ragged``); the up-projections are absorbed — W_uk
    and W_uv come from ``layers.linear_dense_matrix`` of ``wkv_b`` every
    step, as the reference's do, q_lat = q_nope·W_uk and o = o_lat·W_uv
    are fp32 products left to ``torch.matmul`` (the reference leaves them
    to XLA), and the latent attention between them is the MLA kernel
    (``kernels/ops.mla_attention``).  An int8 cache is dequantized whole
    and read by the same kernel, as the reference dequantizes it in XLA.
    Every column is computed, dead ones too: a MoE model routes them.  A
    query that sees no slot (an idle row's) reads 0, the reference the mean
    of the row's latent slots: 0 too, as the engine resets an idle row
    (ROADMAP C3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, MLACfg
from repro_torch.core.structures import LinearSpec, make_linear
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import ops
from repro_torch.quant import qarray as qt

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MLASpec:
    cfg: ArchConfig
    mla: MLACfg
    wq_a: LinearSpec   # d_model -> q_lora
    wq_b: LinearSpec   # q_lora -> H·(nope+rope)
    wkv_a: LinearSpec  # d_model -> kv_lora + rope  (latent + shared k_rope)
    wkv_b: LinearSpec  # kv_lora -> H·(nope+v)
    out: LinearSpec    # H·v -> d_model

    @property
    def scale(self) -> float:
        """The score scale, 1/sqrt(nope + rope): the scores are those of
        the expanded per-head keys."""
        return 1.0 / math.sqrt(self.mla.nope_head_dim + self.mla.rope_head_dim)


def make_mla(cfg: ArchConfig) -> MLASpec:
    m, H, st = cfg.mla, cfg.n_heads, cfg.structure
    return MLASpec(
        cfg=cfg, mla=m,
        wq_a=make_linear(cfg.d_model, m.q_lora_rank, st),
        wq_b=make_linear(m.q_lora_rank,
                         H * (m.nope_head_dim + m.rope_head_dim), st),
        wkv_a=make_linear(cfg.d_model, m.kv_lora_rank + m.rope_head_dim, st),
        wkv_b=make_linear(m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim),
                          st),
        out=make_linear(H * m.v_head_dim, cfg.d_model, st))


def mla_init(spec: MLASpec, generator: torch.Generator, dtype,
             device) -> Params:
    """The reference's leaves in its order; ``out`` at 1/sqrt(2·n_layers·
    d_in) of the init scale, the norms at zero (RMSNorm scales by 1 +
    scale)."""
    m = spec.mla
    return {
        "wq_a": L.linear_init(spec.wq_a, generator, dtype, device),
        "q_norm": L.norm_init(m.q_lora_rank, "rmsnorm", dtype, device),
        "wq_b": L.linear_init(spec.wq_b, generator, dtype, device),
        "wkv_a": L.linear_init(spec.wkv_a, generator, dtype, device),
        "kv_norm": L.norm_init(m.kv_lora_rank, "rmsnorm", dtype, device),
        "wkv_b": L.linear_init(spec.wkv_b, generator, dtype, device),
        "out": L.linear_init(spec.out, generator, dtype, device,
                             scale=1.0 / math.sqrt(2 * spec.cfg.n_layers
                                                   * spec.out.d_in)),
    }


LINEARS = ("wq_a", "wq_b", "wkv_a", "wkv_b", "out")


def mla_quantize(spec: MLASpec, params: Params, bits: int = 8) -> Params:
    """The five linears per-block int8 or int4; the norms pass through."""
    return {**params, **{name: L.linear_quantize(getattr(spec, name),
                                                 params[name], bits)
                         for name in LINEARS}}


def mla_prestack(spec: MLASpec, params: Params) -> Params:
    """Pre-stack the a-projection bundle (``wq_a`` + ``wkv_a``) once at
    load."""
    b = L.linear_group_prestack((spec.wq_a, spec.wkv_a),
                                (params["wq_a"], params["wkv_a"]))
    return {**params, "_bundle_a": b} if b is not None else params


def _mla_qkv(spec: MLASpec, params: Params, x: torch.Tensor,
             positions: torch.Tensor):
    """x (B, T, d) → q_nope (B, T, H, nope), q_rope (B, T, H, rope), the
    normed latent (B, T, kv_lora) and the shared k_rope (B, T, rope), RoPE
    at ``positions`` ((T,) or (B, T)) on q_rope and k_rope."""
    m = spec.mla
    H = spec.cfg.n_heads
    *lead, _ = x.shape
    q_lat, kv = L.linear_group_apply(
        (spec.wq_a, spec.wkv_a), (params["wq_a"], params["wkv_a"]), x,
        bundle=params.get("_bundle_a"))
    q_lat = L.norm_apply(params["q_norm"], q_lat, "rmsnorm")
    q = L.linear_apply(spec.wq_b, params["wq_b"], q_lat)
    q = q.reshape(*lead, H, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    latent, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    latent = L.norm_apply(params["kv_norm"], latent, "rmsnorm")
    q_rope = ops.rope(q_rope, positions, spec.cfg.rope_theta)
    k_rope = ops.rope(k_rope[..., None, :], positions,
                      spec.cfg.rope_theta)[..., 0, :]
    return q_nope, q_rope, latent, k_rope


def mla_apply(spec: MLASpec, params: Params, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence MLA (training / prefill): the latent expanded to
    per-head K/V and causal attention through B4, v zero-padded to the
    192 dims of q and k (exact) and the pad sliced off.  x (B, T, d) →
    (B, T, d)."""
    m = spec.mla
    H = spec.cfg.n_heads
    B, T, _ = x.shape
    q_nope, q_rope, latent, k_rope = _mla_qkv(spec, params, x, positions)
    kv = L.linear_apply(spec.wkv_b, params["wkv_b"], latent)
    kv = kv.reshape(B, T, H, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, T, H, m.rope_head_dim)], dim=-1)
    d_qk = m.nope_head_dim + m.rope_head_dim
    v = torch.nn.functional.pad(v, (0, d_qk - m.v_head_dim))
    o = ops.chunked_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
        q_chunk=spec.cfg.q_chunk)
    o = o[..., :m.v_head_dim].transpose(1, 2).reshape(B, T, H * m.v_head_dim)
    return L.linear_apply(spec.out, params["out"], o)


def mla_cache_init(spec: MLASpec, batch: int, max_len: int, dtype,
                   device) -> Params:
    """The latent cache: ``latent`` (B, S, kv_lora), ``k_rope`` (B, S,
    rope) and ``pos`` (B, S) (-1 empty), S = max_len (not a ring); with
    ``cfg.cache_quant`` the latent and k_rope are int8 codes with bf16
    per-(row, slot) scales ``latent_scale``, ``k_rope_scale`` (B, S).  Each
    leaf is the [:, :S] view of a buffer with the spare slot S that a dead
    column writes (``layers.ragged``)."""
    m = spec.mla

    def leaf(*shape, fill=0, dtype_=dtype):
        return torch.full((batch, max_len + 1, *shape), fill, dtype=dtype_,
                          device=device)[:, :max_len]

    c = {"pos": leaf(fill=-1, dtype_=torch.int32)}
    if spec.cfg.cache_quant:
        c.update(latent=leaf(m.kv_lora_rank, dtype_=torch.int8),
                 k_rope=leaf(m.rope_head_dim, dtype_=torch.int8),
                 latent_scale=leaf(dtype_=torch.bfloat16),
                 k_rope_scale=leaf(dtype_=torch.bfloat16))
    else:
        c.update(latent=leaf(m.kv_lora_rank), k_rope=leaf(m.rope_head_dim))
    return c


def mla_cache_axes(spec: MLASpec) -> dict[str, tuple]:
    """Axis names of ``mla_cache_init``'s leaves, as the reference names
    them: every leaf is paged by its ``kv_seq`` axis."""
    a = {"latent": ("batch", "kv_seq", None),
         "k_rope": ("batch", "kv_seq", None),
         "pos": ("batch", "kv_seq")}
    if spec.cfg.cache_quant:
        a["latent_scale"] = ("batch", "kv_seq")
        a["k_rope_scale"] = ("batch", "kv_seq")
    return a


def _absorbed(spec: MLASpec, params: Params) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """W_uk (H, nope, kv_lora) and W_uv (H, kv_lora, v) in fp32, from the
    dense matrix of ``wkv_b`` (``layers.linear_dense_matrix``)."""
    m = spec.mla
    H = spec.cfg.n_heads
    w = L.linear_dense_matrix(spec.wkv_b, params["wkv_b"]).float()
    w = w.reshape(m.kv_lora_rank, H, m.nope_head_dim + m.v_head_dim)
    w_uk = w[..., :m.nope_head_dim].permute(1, 2, 0)      # (H, nope, c)
    w_uv = w[..., m.nope_head_dim:].permute(1, 0, 2)      # (H, c, v)
    return w_uk, w_uv


def mla_prefill(spec: MLASpec, params: Params, cache: Params,
                x: torch.Tensor, steps, n_tokens, *,
                rg: L.Ragged | None = None) -> tuple[torch.Tensor, Params]:
    """Latent-cache prefill / decode at per-row offsets (the reference's
    ``mla_prefill``): x (B, C, d); steps (B,), the position of each row's
    first token; n_tokens (B,) live tokens a row (host values, read through
    ``layers.chunk_inputs``, when no ``rg`` is given).  Writes the cache in
    place (dead columns into the spare slot) and returns (y (B, C, d),
    cache).  Each query sees the slots with 0 <= pos <= its position, as
    the reference's mask reads the cache's ``pos``."""
    m = spec.mla
    H = spec.cfg.n_heads
    B, C, _ = x.shape
    if rg is None:
        S = cache["pos"].shape[1]
        st, n, kv_len = L.chunk_inputs(steps, n_tokens, B, C, S, x.device)
        rg = L.ragged(st, n, C, S, kv_len)
    q_nope, q_rope, latent, k_rope = _mla_qkv(spec, params, x, rg.q_pos)
    L._write(cache["pos"], rg, rg.q_pos)
    if spec.cfg.cache_quant:
        for name, t in (("latent", latent), ("k_rope", k_rope)):
            codes, scales = qt.quantize_rows(t)
            L._write(cache[name], rg, codes)
            L._write(cache[f"{name}_scale"], rg, scales)
        lat_cache = qt.dequantize_rows(cache["latent"], cache["latent_scale"],
                                       x.dtype)
        rope_cache = qt.dequantize_rows(cache["k_rope"],
                                        cache["k_rope_scale"], x.dtype)
    else:
        L._write(cache["latent"], rg, latent)
        L._write(cache["k_rope"], rg, k_rope)
        lat_cache, rope_cache = cache["latent"], cache["k_rope"]
    w_uk, w_uv = _absorbed(spec, params)
    # q_lat = q_nope · W_uk, head by head: (H, B·C, nope) @ (H, nope, c)
    qn = q_nope.float().reshape(B * C, H, m.nope_head_dim).transpose(0, 1)
    q_lat = torch.matmul(qn, w_uk).transpose(0, 1).reshape(
        B, C, H, m.kv_lora_rank)
    o_lat = kops.mla_attention(q_lat, q_rope, lat_cache, rope_cache,
                               cache["pos"], rg.steps, scale=spec.scale,
                               kv_len=rg.kv_len)
    ol = o_lat.reshape(B * C, H, m.kv_lora_rank).transpose(0, 1)
    o = torch.matmul(ol, w_uv).transpose(0, 1).reshape(
        B, C, H * m.v_head_dim).to(x.dtype)
    return L.linear_apply(spec.out, params["out"], o), cache
