"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427 (Griffin); hf google/recurrentgemma-2b].

26L, d_model=2560, 10 heads (GQA kv=1, head_dim=256), d_ff=7680,
vocab=256000, sliding window 2048.  26 = 8 full (rec, rec, attn) cycles + a
2-layer recurrent tail.  The recurrent state is O(1) per row and the
attention layers keep a ring of ``window`` slots.
"""

from repro_torch.configs.base import ArchConfig, RGLRUCfg, StructureConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    vocab=256_000,
    d_model=2560,
    n_layers=26,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    ffn_kind="gelu",
    norm="rmsnorm",
    pos_embed="rope",
    tie_embeddings=True,
    embed_scale=True,
    logit_softcap=30.0,
    pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    rglru=RGLRUCfg(lru_width=2560, conv_width=4, c=8.0),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
