"""Architecture configuration schema (copy of ``repro/configs/base.py`` and
``repro/core/structures.py::StructureConfig``, kept jax-free).

Only the fields the ported serving and training slices read, plus every
field that changes numbers (``reduced()`` gives the same shapes, dtypes and
learned-position table as the reference).  ``MoECfg`` is carried whole;
``LM`` raises on the MoE fields the port does not run yet (shared experts,
first dense layers: ROADMAP A7.2).  Families and knobs the port does not
run yet (MLA, encoders) are not carried; ``LM`` raises on them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.quant.qarray import QuantConfig

STRUCTURES = ("dense", "blast", "low_rank", "monarch", "block_diag",
              "pixelfly")


@dataclasses.dataclass(frozen=True)
class StructureConfig:
    """How to structure the linear layers of a model.

    kind:        one of STRUCTURES (the port implements dense and blast)
    b:           number of blocks per axis
    keep_ratio:  target params / dense params; solves ranks when ``rank``
                 is not given
    rank:        explicit rank override
    """

    kind: str = "dense"
    b: int = 16
    keep_ratio: float = 0.5
    rank: int | None = None

    def __post_init__(self):
        if self.kind not in STRUCTURES:
            raise ValueError(f"unknown structure kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class MoECfg:
    """The routed-expert FFN of the moe family (top-k routing, capacity-
    based dispatch)."""
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSDCfg:
    """The Mamba-2 SSD mixer of the ssm family."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUCfg:
    """The RG-LRU mixer of the hybrid family (Griffin)."""
    lru_width: int = 0      # 0 → d_model
    conv_width: int = 4
    c: float = 8.0


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    ffn_kind: str = "swiglu"          # swiglu | gelu | none
    qkv_bias: bool = False
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    rope_theta: float = 10000.0
    pos_embed: str = "rope"           # rope | learned | sinusoidal | none
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embed_scale: bool = False
    # per-layer mixer pattern, cycled over n_layers: 'attn' | 'local_attn'
    # (sliding window of ``window`` keys over a ring cache) | 'rglru' | 'ssd'
    pattern: Sequence[str] = ("attn",)
    window: int = 0
    moe: MoECfg | None = None
    ssd: SSDCfg | None = None
    rglru: RGLRUCfg | None = None
    structure: StructureConfig = dataclasses.field(default_factory=StructureConfig)
    # per-role structure: ``structure`` covers the attention projections,
    # ``structure_ffn`` (if set) the FFN's (paper Table 9: r=1024 attention,
    # r=1488 MLP for Llama-7B at 50%)
    structure_ffn: StructureConfig | None = None
    max_seq: int = 8192               # learned-position table (pos_embed=learned)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # training: recompute each layer's activations in the backward pass
    # (``torch.utils.checkpoint``), and the chunked-attention tile sizes
    # (query rows per chunk; ``kv_chunk`` is carried as the reference
    # carries it — neither package's attention tiles by it)
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 1024
    # serving-time storage: ``quant.weights`` drives the engine's
    # quantize-at-load and ``LM.quantize_params``; ``quant.cache="int8"``
    # makes ``init_cache`` allocate int8 K/V with per-(slot, head) scales
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def cache_quant(self) -> bool:
        """int8 caches requested (``quant.cache``)."""
        return self.quant.cache != "none"

    @property
    def ffn_structure(self) -> StructureConfig:
        return self.structure_ffn or self.structure

    def layer_kinds(self) -> list[str]:
        pat = list(self.pattern)
        return [pat[i % len(pat)] for i in range(self.n_layers)]

    def reduced(self, **overrides) -> "ArchConfig":
        """Small same-family variant for CPU tests (the reference's
        ``ArchConfig.reduced`` restricted to the fields carried here)."""
        small: dict = dict(
            vocab=min(self.vocab, 512),
            d_model=min(self.d_model, 64),
            n_layers=min(self.n_layers, len(self.pattern) * 2),
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            q_chunk=32,
            kv_chunk=32,
        )
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        small.update(n_heads=n_heads, n_kv_heads=n_kv, head_dim=16)
        if self.window:
            small["window"] = 16
        if self.moe:
            small["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=32,
                d_shared=32 if self.moe.n_shared else 0,
                dense_d_ff=64 if self.moe.first_dense_layers else 0,
                first_dense_layers=min(self.moe.first_dense_layers, 1))
            small["n_layers"] = max(small["n_layers"],
                                    (self.moe.first_dense_layers and 1) + 2)
        if self.ssd:
            small["ssd"] = dataclasses.replace(self.ssd, d_state=16,
                                               head_dim=8, chunk=8)
        if self.rglru:
            small["rglru"] = dataclasses.replace(self.rglru, lru_width=0)

        def shrink(st):
            if st is not None and st.kind in ("blast", "monarch", "block_diag"):
                return dataclasses.replace(st, b=min(st.b, 4), rank=None)
            return st
        small["structure"] = shrink(self.structure)
        small["structure_ffn"] = shrink(self.structure_ffn)
        small["max_seq"] = 256
        small.update(overrides)
        return dataclasses.replace(self, **small)
