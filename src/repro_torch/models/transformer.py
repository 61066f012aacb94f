"""Decoder LM of the ported slices (counterpart of
``repro/models/transformer.py``): GQA attention blocks — full, or over a
sliding window with a ring cache —, RG-LRU blocks (the hybrid family) and
Mamba-2 SSD blocks (the ssm family), each with a SwiGLU or GELU FFN, a
routed-expert FFN (the moe family, ``models/moe.py``) or none, and RMSNorm or LayerNorm, RoPE, learned or no positions, a tied
embedding (optionally scaled by √d_model) or an untied
dense vocab head, a logit softcap, the full-sequence forward ``apply``
(training, prefill) and the chunked cached step ``prefill_chunk`` the engine
drives, over a float or int8 KV cache, and the nested-rank draft of
self-speculative decoding (``rank_spectra``, ``draft_plan``,
``truncate_params``, ``pad_ranks``) with the all-logits verify and its
in-place rollback (``cache_window``, ``rollback_cache``: KV windows by
position, RG-LRU and SSD state from the verify's per-token snapshots).

The reference scans over layer params stacked on a leading axis (one
``cycles.blk_j`` per position of the layer pattern, then unrolled
``tail_i`` layers); here the params hold a list of per-layer dicts, layer i
the reference's ``cycles.blk_{i % P}[i // P]`` and then its tails, and each
pass is a Python loop (``cfg.remat`` checkpoints each layer, as the
reference's ``jax.checkpoint`` does its scanned cycle).  Families, mixers
and options outside the slices raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import structures
from repro_torch.core.compress import calibrate_ranks
from repro_torch.core.structures import make_linear
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ops
from repro_torch.models import rglru as R
from repro_torch.models import ssd as S
from repro_torch.quant import qarray as qt
from repro_torch.quant.qarray import QuantConfig

Params = dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Output(NamedTuple):
    logits: torch.Tensor
    aux: torch.Tensor                   # MoE load-balance loss (0 without)
    mtp_logits: torch.Tensor | None = None


_ATTN_KINDS = ("attn", "local_attn")


class _Mixer(NamedTuple):
    """A mixer kind's functions that share one signature across kinds."""
    init: Any
    apply: Any
    cache_init: Any
    cache_axes: Any
    quantize: Any


_ATTN = _Mixer(L.attn_init, L.attn_apply, L.attn_cache_init,
               L.attn_cache_axes, L.attn_quantize)
_MIXERS = {
    "attn": _ATTN, "local_attn": _ATTN,
    "rglru": _Mixer(R.rglru_init, R.rglru_apply, R.rglru_cache_init,
                    R.rglru_cache_axes, R.rglru_quantize),
    "ssd": _Mixer(S.ssd_init, S.ssd_apply, S.ssd_cache_init,
                  S.ssd_cache_axes, S.ssd_quantize)}


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    kind: str                       # attn | local_attn | rglru | ssd
    mixer: L.AttnSpec | R.RGLRUSpec | S.SSDSpec
    ffn: L.FFNSpec | M.MoESpec | None   # None: the mixer is the whole block
    norm: str

    @property
    def moe(self) -> bool:
        return isinstance(self.ffn, M.MoESpec)


def make_block(cfg: ArchConfig, kind: str) -> BlockSpec:
    if kind in _ATTN_KINDS:
        # a MoE FFN routes dead columns too: they attend by key position
        mixer = L.make_attention(
            cfg, window=cfg.window if kind == "local_attn" else None,
            by_position=cfg.moe is not None)
    elif kind == "rglru":
        mixer = R.make_rglru(cfg)
    elif kind == "ssd":
        mixer = S.make_ssd(cfg)
    else:
        raise NotImplementedError(f"mixer {kind!r} is not ported yet "
                                  "(ROADMAP A7)")
    if cfg.moe is not None:
        ffn = M.make_moe(cfg)
    else:
        ffn = (L.make_ffn(cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                          cfg.ffn_structure) if cfg.d_ff else None)
    return BlockSpec(kind=kind, mixer=mixer, ffn=ffn, norm=cfg.norm)


def block_init(spec: BlockSpec, generator: torch.Generator, dtype, device,
               d_model: int) -> Params:
    p = {"norm1": L.norm_init(d_model, spec.norm, dtype, device),
         "mixer": _MIXERS[spec.kind].init(spec.mixer, generator, dtype,
                                          device)}
    if spec.ffn is not None:
        init = M.moe_init if spec.moe else L.ffn_init
        p.update(norm2=L.norm_init(d_model, spec.norm, dtype, device),
                 ffn=init(spec.ffn, generator, dtype, device))
    return p


def _ffn(spec: BlockSpec, params: Params,
         x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The block's FFN residual, if it has an FFN, and its MoE load-balance
    loss (fp32; 0 for a dense FFN or none)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn is None:
        return x, aux
    h = L.norm_apply(params["norm2"], x, spec.norm)
    if spec.moe:
        f, aux = M.moe_apply(spec.ffn, params["ffn"], h)
        return x + f, aux
    return x + L.ffn_apply(spec.ffn, params["ffn"], h), aux


def block_apply(spec: BlockSpec, params: Params, x: torch.Tensor,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One residual block over a full sequence → (x, aux); aux is the MoE
    load-balance loss (0 without routed experts)."""
    h = L.norm_apply(params["norm1"], x, spec.norm)
    x = x + _MIXERS[spec.kind].apply(spec.mixer, params["mixer"], h,
                                     positions)
    return _ffn(spec, params, x)


def block_prefill(spec: BlockSpec, params: Params, cache: Params,
                  x: torch.Tensor, rg: L.Ragged,
                  collect: dict | None = None) -> torch.Tensor:
    """One residual block over a ragged chunk; writes ``cache`` in place.
    ``rg``: the chunk's geometry in this layer's cache.  ``collect``: a
    dict that an RG-LRU or SSD layer fills with its per-token state
    snapshots (``rglru.rglru_prefill``, ``ssd.ssd_prefill``); a KV layer
    rewinds by position and needs none."""
    h = L.norm_apply(params["norm1"], x, spec.norm)
    if spec.kind in _ATTN_KINDS:
        m, _ = L.attn_prefill(spec.mixer, params["mixer"], cache, h, None,
                              None, rg=rg)
    else:
        prefill = R.rglru_prefill if spec.kind == "rglru" else S.ssd_prefill
        m, _ = prefill(spec.mixer, params["mixer"], cache, h, None, rg.n,
                       collect=collect)
    return _ffn(spec, params, x + m)[0]


def block_cache_rollback(spec: BlockSpec, cache: Params, saved: Params,
                         slot: torch.Tensor | None,
                         n_comm: torch.Tensor) -> Params:
    """Rewind one block's cache, in place, after a speculative verify chunk:
    keep its first ``n_comm`` tokens.  A KV layer (a ring too) gives the
    columns past them back what ``saved`` holds of its write window
    ``slot`` (``layers.kv_cache_rollback``); an RG-LRU or SSD layer takes
    the state after ``n_comm`` tokens from the snapshots the chunk collected
    into ``saved`` (``rglru.rglru_cache_rollback``,
    ``ssd.ssd_cache_rollback``)."""
    if spec.kind in _ATTN_KINDS:
        return L.kv_cache_rollback(cache, saved, slot, n_comm)
    rollback = (R.rglru_cache_rollback if spec.kind == "rglru"
                else S.ssd_cache_rollback)
    return rollback(spec.mixer, cache, saved, n_comm)


def block_cache_init(spec: BlockSpec, batch: int, max_len: int, dtype,
                     device) -> Params:
    """One layer's cache: its attention cache (a ring for a sliding window)
    or its RG-LRU or SSD state."""
    return _MIXERS[spec.kind].cache_init(spec.mixer, batch, max_len, dtype,
                                         device)


def block_cache_axes(spec: BlockSpec) -> dict[str, tuple]:
    """Axis names of one layer's cache leaves (attention: batch axis 0,
    ``kv_seq`` axis 1; RG-LRU and SSD state: batch axis 0, no
    ``kv_seq``)."""
    return _MIXERS[spec.kind].cache_axes(spec.mixer)


def block_quantize(spec: BlockSpec, params: Params, bits: int = 8) -> Params:
    """Quantize a block's structured linears to per-block QArrays (norms,
    the conv, Λ and the SSD's A_log, D and dt_bias pass through)."""
    p = {**params, "mixer": _MIXERS[spec.kind].quantize(
        spec.mixer, params["mixer"], bits)}
    if spec.ffn is not None:
        quantize = M.moe_quantize if spec.moe else L.ffn_quantize
        p["ffn"] = quantize(spec.ffn, params["ffn"], bits)
    return p


def block_prestack(spec: BlockSpec, params: Params) -> Params:
    p = dict(params)
    if spec.ffn is not None:
        prestack = M.moe_prestack if spec.moe else L.ffn_prestack
        p["ffn"] = prestack(spec.ffn, params["ffn"])
    if spec.kind == "rglru":
        p["mixer"] = R.rglru_prestack(spec.mixer, params["mixer"])
    return p


class LayerCaches(list):
    """``LM.init_cache``'s per-layer caches, and ``max_len``, the positions
    they were allocated for: a ring layer's S slots do not say it."""

    def __init__(self, layers, max_len: int):
        super().__init__(layers)
        self.max_len = max_len


def _map_linears(tree, fn, path: str = ""):
    """``tree`` with every rank-bearing linear ``lin`` replaced by
    ``fn(path, lin)``; a linear's path joins its keys with dots, and a list
    adds none.  Other leaves (a prestacked ``GroupBundle`` too) pass
    through."""
    if structures.rank_kind(tree) is not None:
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_linears(v, fn, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_linears(v, fn, path) for v in tree]
    return tree


class LM:
    """Decoder-only LM of the dense family (pattern ``("attn",)``), the
    hybrid family (RG-LRU and sliding-window attention layers), the ssm
    family (SSD layers, no FFN, no positions) and the moe family (routed
    experts in every layer's FFN, ``models/moe.py``)."""

    def __init__(self, cfg: ArchConfig, device=None):
        unsupported = [
            (cfg.family not in ("dense", "hybrid", "ssm", "moe"),
             f"family {cfg.family!r}"),
            ((cfg.family == "moe") != (cfg.moe is not None),
             "a moe family without MoECfg (or MoECfg outside it)"),
            (cfg.pos_embed not in ("rope", "learned", "none"),
             f"pos_embed {cfg.pos_embed!r}"),
            ("local_attn" in cfg.pattern and not cfg.window,
             "local attention without a window"),
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

    @property
    def slot_resident(self) -> bool:
        """Whether a layer keeps cache state that is not one slot a
        position: an RG-LRU or SSD state or a sliding-window ring."""
        return any(s.kind in ("rglru", "ssd", "local_attn")
                   for s in self.specs)

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

    # -- nested-rank drafts (self-speculative decoding) ------------------------

    def _layer_paths(self) -> list[str]:
        """Each layer's prefix in a linear's name, grouped as the reference
        groups its layers: with a one-position pattern every layer is a
        cycle of it, ``layers``; else ``layers.blk_j`` for position j of
        the whole cycles and ``layers.tail_t`` past them (the reference's
        ``cycles.blk_j`` and ``tail_t``, ``weights.plan_from_jax``)."""
        P = len(self.cfg.pattern)
        if P == 1:
            return ["layers"] * len(self.specs)
        whole = len(self.specs) // P * P
        return [f"layers.blk_{i % P}" if i < whole
                else f"layers.tail_{i - whole}"
                for i in range(len(self.specs))]

    def _map(self, params: Params, fn) -> Params:
        """``_map_linears`` over the params, each layer's linears named
        under its ``_layer_paths`` prefix."""
        out = {k: v if k == "layers" else _map_linears(v, fn, k)
               for k, v in params.items()}
        out["layers"] = [_map_linears(p, fn, path) for p, path in
                         zip(params["layers"], self._layer_paths())]
        return out

    def rank_spectra(self, params: Params) -> dict[str, torch.Tensor]:
        """Name → fp32 energy spectrum of every rank-bearing linear, a name
        for each linear of a layer group (``_layer_paths``: a dense model's
        ``layers.mixer.qkv``, ``layers.mixer.out``, ``layers.ffn.gate``,
        ``layers.ffn.up``, ``layers.ffn.wo``; the hybrid's
        ``layers.blk_0.mixer.in_x``, …, ``layers.tail_1.ffn.wo``; the
        reference's ``cycles.blk_j.…`` and ``tail_t.…``,
        ``weights.plan_from_jax``), its spectra averaged over the group's
        layers in fp32 as the reference's ``jnp.mean`` over its scan axis
        does: one rank serves every layer of a group.  A stack of experts
        (``layers.ffn.wi``, ``layers.ffn.wo``) is averaged over its layers,
        then over its experts, the reference's order: one rank serves every
        expert too."""
        found: dict[str, list] = {}

        def collect(path, lin):
            found.setdefault(path, []).append(structures.rank_spectrum(lin))
            return lin

        self._map(params, collect)
        out = {}
        for k, v in found.items():
            e = torch.stack(v)
            while e.ndim > 1:   # the layers, then a stack's experts
                e = e.mean(dim=0)
            out[k] = e
        return out

    def draft_plan(self, params: Params, frac: float) -> dict[str, int]:
        """Per-linear draft ranks: the globally highest-energy ~``frac`` of
        the pooled rank budget (``core/compress.py::calibrate_ranks``).  Run
        once at engine load."""
        spectra = self.rank_spectra(params)
        return calibrate_ranks(
            {k: v.cpu().numpy() for k, v in spectra.items()}, frac)

    def truncate_params(self, params: Params, plan: dict) -> Params:
        """The draft model: every planned linear truncated to its r' (each
        layer keeps its own highest-energy components).  The draft's
        factors are column subsets of the full ones (the paper's nesting
        property); the apply paths read ranks from the factors' shapes."""
        return self._map(params, lambda path, lin: (
            lin if path not in plan else
            structures.truncate_rank(lin, plan[path])))

    def pad_ranks(self, params: Params, granule: int) -> Params:
        """Every rank-bearing linear zero-padded to a multiple of ``granule``
        ranks (``structures.pad_rank``: exact)."""
        return self._map(params,
                         lambda _, lin: structures.pad_rank(lin, granule))

    def _window_slots(self, cache: list[Params], steps: torch.Tensor,
                      C: int) -> list:
        """Each layer's C-column write window at ``steps`` (B,): the slots
        (B, C) of a KV layer (``layers.window_slots``: a ring's at position
        % S), None for a state layer.  One tensor per cache geometry."""
        by_geometry: dict = {}
        out = []
        for spec, c in zip(self.specs, cache):
            if spec.kind not in _ATTN_KINDS:
                out.append(None)
                continue
            key = (c["pos"].shape[1], spec.kind == "local_attn")
            if key not in by_geometry:
                by_geometry[key] = L.window_slots(steps, C, key[0],
                                                  ring=key[1])
            out.append(by_geometry[key])
        return out

    def cache_window(self, cache: list[Params], steps: torch.Tensor,
                     C: int) -> list[Params]:
        """A copy of what every KV layer's cache (a ring too) holds in the
        C-column window at ``steps`` (B,), taken before a chunk that
        ``rollback_cache`` may rewind writes there; a state layer's entry
        is an empty dict that the chunk's ``prefill_chunk(collect_states=)``
        fills with its snapshots."""
        return [{} if slot is None else L.kv_cache_window(c, slot)
                for c, slot in zip(cache, self._window_slots(cache, steps,
                                                             C))]

    def save_state(self, cache: list[Params]) -> list[Params]:
        """A copy of every state layer's leaves (RG-LRU ``conv``, ``h`` and
        their scales), an empty dict for a KV layer (``cache_window`` saves
        its window)."""
        return [{name: leaf.clone() for name, leaf in c.items()}
                if spec.kind not in _ATTN_KINDS else {}
                for spec, c in zip(self.specs, cache)]

    def restore_cache(self, cache: list[Params], saved: list[Params],
                      state: list[Params], steps: torch.Tensor) -> list:
        """Undo, in place, every write made since ``cache_window`` (steps,
        C) gave ``saved`` and ``save_state`` gave ``state``, by steps of at
        most C tokens at ``steps``: each KV layer's window gets back what
        ``saved`` holds, each state layer its copied leaves."""
        C = next((sv["pos"].shape[1] for sv in saved if "pos" in sv), 1)
        none = torch.zeros_like(steps, dtype=torch.int64)
        for c, sv, st, slot in zip(cache, saved, state,
                                   self._window_slots(cache, steps, C)):
            if slot is None:
                for name, leaf in st.items():
                    c[name].copy_(leaf)
            else:
                L.kv_cache_rollback(c, sv, slot, none)
        return cache

    def rollback_cache(self, cache: list[Params], saved: list[Params],
                       steps: torch.Tensor, n_comm: torch.Tensor) -> list:
        """Rewind, in place, a chunk written at ``steps`` to its first
        ``n_comm[b]`` tokens per row — bit-identical to having fed exactly
        those tokens.  ``saved``: ``cache_window`` of the chunk's window,
        taken before it, its state layers' entries filled by the chunk's
        ``collect_states`` (the reference's ``rollback_cache(old, new,
        steps, n_comm)`` takes the whole pre-chunk cache and the chunk's
        collected one)."""
        C = next((sv["pos"].shape[1] for sv in saved if "pos" in sv), 1)
        for spec, c, sv, slot in zip(self.specs, cache, saved,
                                     self._window_slots(cache, steps, C)):
            block_cache_rollback(spec, c, sv, slot, n_comm)
        return cache

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
            x = self._embed(params, tokens, self.dtype)
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

    def init_cache(self, batch: int, max_len: int) -> LayerCaches:
        return LayerCaches([block_cache_init(s, batch, max_len,
                                             self.compute_dtype, self.device)
                            for s in self.specs], max_len)

    def cache_axes(self) -> list[dict[str, tuple]]:
        """Axis names of ``init_cache``'s leaves, one dict a layer."""
        return [block_cache_axes(s) for s in self.specs]

    def _cache_len(self, cache: list[Params]) -> int:
        """The positions a cache was allocated for: ``LayerCaches.max_len``
        (``init_cache``'s, and the paged view's), or else (a plain list)
        the slots of its full-length attention layers.  A ring's slots do
        not say it: a plain list of ring and state caches raises."""
        if isinstance(cache, LayerCaches):
            return cache.max_len
        full = [c["pos"].shape[1] for s, c in zip(self.specs, cache)
                if s.kind == "attn"]
        if not full:
            raise ValueError("a cache without full-length attention layers "
                             "must come from LM.init_cache (LayerCaches)")
        return min(full)

    def _embed(self, params: Params, tokens: torch.Tensor,
               dtype) -> torch.Tensor:
        """The token embedding; with ``embed_scale`` times √d_model cast to
        the embedding's dtype first, as the reference does (50.5 in bf16
        for d_model 2560, not 50.596)."""
        x = L.embed_lookup(params["embed"], tokens, dtype)
        if self.cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model),
                                 dtype=torch.float32).to(x.dtype)
        return x

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = L.norm_apply(params["final_norm"], x, self.cfg.norm)
        if self.cfg.tie_embeddings:
            logits = L.tied_logits(params["embed"], x)
        else:   # a plain large product, left to torch.matmul (XLA there)
            logits = L.linear_apply(self.head, params["head"], x)
        return ops.softcap(logits, self.cfg.logit_softcap)

    @torch.no_grad()
    def prefill_chunk(self, params: Params, cache: list[Params], tokens,
                      steps, n_tokens=None, kv_len: int | None = None, *,
                      all_logits: bool = False,
                      collect_states: list | None = None
                      ) -> tuple[torch.Tensor, list]:
        """Multi-token cached step — the serving entry point.

        tokens: (B, C) int; steps: (B,) absolute position of each row's first
        token; n_tokens: (B,) live tokens per row (default C).  Row b
        consumes tokens[b, :n_tokens[b]] and writes its cache at
        steps[b]..steps[b]+n_tokens[b]-1 (in place); trailing columns are
        padding.  Returns (logits (B, 1, V) of each row's last live column,
        cache).  C=1 with n_tokens=1 is a decode step.  With ``all_logits``
        the head runs on every column: logits (B, C, V), column i predicting
        the token at position steps + i + 1 (a speculative verify scores k
        drafts in one chunk).  ``collect_states``: a list of one dict a
        layer (``cache_window``'s) into which each RG-LRU layer puts its
        per-token state snapshots, for ``rollback_cache`` (the reference's
        ``collect_states=True``).

        With ``kv_len`` (a host int, ``flash_attention.kv_bucket`` of the
        largest live position + 1) the three inputs are tensors on the
        model's device, and the step does no host work: no copy, no sync,
        no check of a position (the caller knows them), so it can be
        captured as a CUDA graph.  Without it they are host values, checked
        and moved in one copy (``layers.chunk_inputs``), as the reference's
        signature takes them."""
        max_len = self._cache_len(cache)
        if kv_len is None:
            tokens = torch.as_tensor(tokens)
            B, C = tokens.shape
            steps, n_tokens, kv_len = L.chunk_inputs(steps, n_tokens, B, C,
                                                     max_len, self.device)
            tokens = tokens.to(self.device)
        B, C = tokens.shape
        # the chunk's geometry in a full-length cache (the RG-LRU layers
        # read only its live columns), and one per ring size
        rg = L.ragged(steps, n_tokens, C, max_len, kv_len)
        geometry = {(max_len, False): rg}
        x = self._embed(params, tokens, self.compute_dtype)
        if self.cfg.pos_embed == "learned":
            x = x + params["pos"][rg.q_pos.clamp(0, self.cfg.max_seq - 1)]
        for i, (spec, p, c) in enumerate(zip(self.specs, params["layers"],
                                             cache)):
            key = (max_len, False)
            if spec.kind in _ATTN_KINDS:
                key = (c["pos"].shape[1], spec.kind == "local_attn")
                if key not in geometry:
                    geometry[key] = L.ragged(steps, n_tokens, C, key[0],
                                             kv_len, ring=key[1])
            x = block_prefill(spec, p, c, x, geometry[key],
                              None if collect_states is None
                              else collect_states[i])
        if not all_logits:
            x = x[torch.arange(B, device=x.device), rg.last][:, None]
        return self._head(params, x), cache

    def decode_step(self, params: Params, cache: list[Params], tokens,
                    step) -> tuple[torch.Tensor, list]:
        """One decode step: tokens (B, 1); step scalar or (B,)."""
        B = torch.as_tensor(tokens).shape[0]
        return self.prefill_chunk(params, cache, tokens, step,
                                  torch.ones((B,), dtype=torch.int64))
