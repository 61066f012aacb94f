"""Decoder LM of the ported slices (counterpart of
``repro/models/transformer.py``): GQA attention blocks with a SwiGLU or GELU
FFN and RMSNorm or LayerNorm, RoPE or learned positions, a tied embedding
or an untied dense vocab head, the full-sequence forward ``apply``
(training, prefill) and the chunked cached step ``prefill_chunk`` the engine
drives, over a float or int8 KV cache.

The reference scans over layer params stacked on a leading axis; here the
params hold a list of per-layer dicts and each pass is a Python loop
(``cfg.remat`` checkpoints each layer, as the reference's ``jax.checkpoint``
does its scanned cycle).  Families, mixers and options outside the slices
raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.structures import make_linear
from repro_torch.models import layers as L
from repro_torch.models import ops
from repro_torch.quant import qarray as qt
from repro_torch.quant.qarray import QuantConfig

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Output(NamedTuple):
    logits: torch.Tensor
    aux: torch.Tensor                   # MoE load-balance loss (0 here)
    mtp_logits: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str
    mixer: L.AttnSpec
    ffn: L.FFNSpec
    norm: str


def make_block(cfg: ArchConfig, kind: str) -> BlockSpec:
    if kind != "attn":
        raise NotImplementedError(f"mixer {kind!r} is not ported yet "
                                  "(ROADMAP A7)")
    if not cfg.d_ff:
        raise NotImplementedError("blocks without an FFN are not ported yet")
    return BlockSpec(kind=kind, mixer=L.make_attention(cfg),
                     ffn=L.make_ffn(cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                    cfg.ffn_structure),
                     norm=cfg.norm)


def block_init(spec: BlockSpec, generator: torch.Generator, dtype, device,
               d_model: int) -> Params:
    return {"norm1": L.norm_init(d_model, spec.norm, dtype, device),
            "mixer": L.attn_init(spec.mixer, generator, dtype, device),
            "norm2": L.norm_init(d_model, spec.norm, dtype, device),
            "ffn": L.ffn_init(spec.ffn, generator, dtype, device)}


def block_apply(spec: BlockSpec, params: Params, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual block over a full sequence → (x, aux); aux is the MoE
    load-balance loss, zero for this block kind."""
    h = L.norm_apply(params["norm1"], x, spec.norm)
    x = x + L.attn_apply(spec.mixer, params["mixer"], h, positions)
    h = L.norm_apply(params["norm2"], x, spec.norm)
    x = x + L.ffn_apply(spec.ffn, params["ffn"], h)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_prefill(spec: BlockSpec, params: Params, cache: Params,
                  x: torch.Tensor, rg: L.Ragged) -> torch.Tensor:
    """One residual block over a ragged chunk; writes ``cache`` in place."""
    h = L.norm_apply(params["norm1"], x, spec.norm)
    m, _ = L.attn_prefill(spec.mixer, params["mixer"], cache, h, None, None,
                          rg=rg)
    x = x + m
    h = L.norm_apply(params["norm2"], x, spec.norm)
    return x + L.ffn_apply(spec.ffn, params["ffn"], h)


def block_quantize(spec: BlockSpec, params: Params, bits: int = 8) -> Params:
    """Quantize a block's structured linears to per-block QArrays (norms
    pass through)."""
    return {**params,
            "mixer": L.attn_quantize(spec.mixer, params["mixer"], bits),
            "ffn": L.ffn_quantize(spec.ffn, params["ffn"], bits)}


def block_prestack(spec: BlockSpec, params: Params) -> Params:
    return {**params, "ffn": L.ffn_prestack(spec.ffn, params["ffn"])}


class LM:
    """Decoder-only LM for the ``("attn",)`` pattern of the dense family."""

    def __init__(self, cfg: ArchConfig, device=None):
        unsupported = [
            (cfg.family not in ("dense",), f"family {cfg.family!r}"),
            (cfg.pos_embed not in ("rope", "learned"),
             f"pos_embed {cfg.pos_embed!r}"),
            (cfg.window != 0, "sliding-window attention"),
            (cfg.embed_scale, "embedding scaling"),
        ]
        for bad, what in unsupported:
            if bad:
                raise NotImplementedError(f"{what} is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.param_dtype]
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
        self.specs = [make_block(cfg, k) for k in cfg.layer_kinds()]
        # the untied vocab head: a dense linear, as the reference's
        self.head = make_linear(cfg.d_model, cfg.vocab, structured=False)

    # -- init -------------------------------------------------------------------

    def init(self, seed: int | torch.Generator = 0) -> Params:
        """Seeded random weights.  Draws on a CPU generator, so a seed gives
        the same weights on every device, one tensor at a time: each is
        drawn in fp32, cast and moved before the next, so the host never
        holds an fp32 copy of the model."""
        gen = (seed if isinstance(seed, torch.Generator)
               else torch.Generator().manual_seed(int(seed)))
        cfg, dev, dt = self.cfg, self.device, self.dtype

        def normal(*shape):
            return (0.02 * torch.randn(shape, generator=gen)).to(
                device=dev, dtype=dt)

        params = {"embed": normal(cfg.vocab, cfg.d_model),
                  "final_norm": L.norm_init(cfg.d_model, cfg.norm, dt, dev)}
        if cfg.pos_embed == "learned":
            params["pos"] = normal(cfg.max_seq, cfg.d_model)
        if not cfg.tie_embeddings:
            params["head"] = L.linear_init(self.head, gen, dt, dev, scale=0.02)
        params["layers"] = [block_init(spec, gen, dt, dev, cfg.d_model)
                            for spec in self.specs]
        return params

    def quantize_params(self, params: Params, quant: QuantConfig) -> Params:
        """Quantize-at-load: every structured linear becomes per-block int8
        or int4 QArrays, the embedding per-row int8 or int4 (its gather and
        a tied head both fuse the row scale) and an untied head per output
        channel; norms and learned positions stay float.  Run it before
        ``prestack_params``, as the reference orders them."""
        bits = quant.weight_bits
        if bits is None:
            return params
        qp = {**params,
              "embed": qt.quantize(params["embed"], bits=bits,
                                   block_axes=(1,)),
              "layers": [block_quantize(s, p, bits) for s, p in
                         zip(self.specs, params["layers"])]}
        if not self.cfg.tie_embeddings:
            qp["head"] = L.linear_quantize(self.head, params["head"], bits)
        return qp

    def prestack_params(self, params: Params) -> Params:
        """Pre-stack every grouped projection bundle (SwiGLU gate+up) once at
        load, so the per-step grouped launch skips its pad+stack."""
        return {**params, "layers": [block_prestack(s, p) for s, p in
                                     zip(self.specs, params["layers"])]}

    # -- full-sequence forward --------------------------------------------------

    def apply(self, params: Params, tokens=None, embeds=None, *,
              last_only: bool = False) -> Output:
        """Full-sequence forward (training / prefill).

        tokens: (B, T) int — or embeds: (B, T, d).  ``last_only`` projects
        logits for the final position only.  Differentiable: the BLAST and
        attention kernels run through their autograd Functions, and with
        ``cfg.remat`` each layer's activations are recomputed in the
        backward pass."""
        if embeds is None:
            tokens = torch.as_tensor(tokens).to(self.device)
            x = L.embed_lookup(params["embed"], tokens, self.dtype)
        else:
            x = torch.as_tensor(embeds).to(device=self.device,
                                           dtype=self.dtype)
        positions = torch.arange(x.shape[1], device=self.device)
        if self.cfg.pos_embed == "learned":
            x = x + params["pos"][:x.shape[1]][None]
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for spec, p in zip(self.specs, params["layers"]):
            if self.cfg.remat and torch.is_grad_enabled():
                # no random draws in a block, so no generator state to
                # keep (reading the CUDA generator's state is not allowed
                # while a training step is captured as a CUDA graph)
                x, a = torch.utils.checkpoint.checkpoint(
                    block_apply, spec, p, x, positions, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x, a = block_apply(spec, p, x, positions)
            aux = aux + a
        logits = self._head(params, x[:, -1:] if last_only else x)
        return Output(logits=logits, aux=aux, mtp_logits=None)

    # -- cached decode ----------------------------------------------------------

    def init_cache(self, batch: int, max_len: int) -> list[Params]:
        return [L.attn_cache_init(s.mixer, batch, max_len, self.compute_dtype,
                                  self.device) for s in self.specs]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(params["final_norm"], x, self.cfg.norm)
        if self.cfg.tie_embeddings:
            logits = L.tied_logits(params["embed"], x)
        else:   # a plain large product, left to torch.matmul (XLA there)
            logits = L.linear_apply(self.head, params["head"], x)
        return ops.softcap(logits, self.cfg.logit_softcap)

    @torch.no_grad()
    def prefill_chunk(self, params: Params, cache: list[Params], tokens,
                      steps, n_tokens=None, kv_len: int | None = None
                      ) -> tuple[torch.Tensor, list]:
        """Multi-token cached step — the serving entry point.

        tokens: (B, C) int; steps: (B,) absolute position of each row's first
        token; n_tokens: (B,) live tokens per row (default C).  Row b
        consumes tokens[b, :n_tokens[b]] and writes its cache at
        steps[b]..steps[b]+n_tokens[b]-1 (in place); trailing columns are
        padding.  Returns (logits (B, 1, V) of each row's last live column,
        cache).  C=1 with n_tokens=1 is a decode step.

        With ``kv_len`` (a host int, ``flash_attention.kv_bucket`` of the
        largest live position + 1) the three inputs are tensors on the
        model's device, and the step does no host work: no copy, no sync,
        no check of a position (the caller knows them), so it can be
        captured as a CUDA graph.  Without it they are host values, checked
        and moved in one copy (``layers.chunk_inputs``), as the reference's
        signature takes them."""
        S = cache[0]["k"].shape[1]
        if kv_len is None:
            tokens = torch.as_tensor(tokens)
            B, C = tokens.shape
            steps, n_tokens, kv_len = L.chunk_inputs(steps, n_tokens, B, C,
                                                     S, self.device)
            tokens = tokens.to(self.device)
        B, C = tokens.shape
        rg = L.ragged(steps, n_tokens, C, S, kv_len)
        x = L.embed_lookup(params["embed"], tokens, self.compute_dtype)
        if self.cfg.pos_embed == "learned":
            x = x + params["pos"][rg.q_pos.clamp(0, self.cfg.max_seq - 1)]
        for spec, p, c in zip(self.specs, params["layers"], cache):
            x = block_prefill(spec, p, c, x, rg)
        x = x[torch.arange(B, device=x.device), rg.last][:, None]  # (B, 1, d)
        return self._head(params, x), cache

    def decode_step(self, params: Params, cache: list[Params], tokens,
                    step) -> tuple[torch.Tensor, list]:
        """One decode step: tokens (B, 1); step scalar or (B,)."""
        B = torch.as_tensor(tokens).shape[0]
        return self.prefill_chunk(params, cache, tokens, step,
                                  torch.ones((B,), dtype=torch.int64))
