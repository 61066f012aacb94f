"""granite-moe-1b-a400m [moe] — 32 experts, top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24L, d_model=1024, 16 heads (GQA kv=8, head_dim=64), per-expert d_ff=512,
vocab=49155.  Every layer is MoE; the router stays dense and fp32."""

from repro_torch.configs.base import ArchConfig, MoECfg, StructureConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    vocab=49_155,
    d_model=1024,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,                 # per-expert width
    ffn_kind="swiglu",
    tie_embeddings=True,
    pattern=("attn",),
    moe=MoECfg(n_experts=32, top_k=8, d_expert=512, capacity_factor=1.25),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
