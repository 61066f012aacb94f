"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base].

40L, d_model=2048, 32 heads (GQA kv=8, head_dim=64), d_ff=8192, vocab=49155,
tied embeddings."""

from repro_torch.configs.base import ArchConfig, StructureConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    vocab=49_155,
    d_model=2048,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    ffn_kind="swiglu",
    tie_embeddings=True,
    pattern=("attn",),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
