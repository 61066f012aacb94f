"""smollm-135m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

30L, d_model=576, 9 heads (GQA kv=3, head_dim=64), d_ff=1536, vocab=49152,
tied embeddings."""

from repro_torch.configs.base import ArchConfig, StructureConfig

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    vocab=49_152,
    d_model=576,
    n_layers=30,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    ffn_kind="swiglu",
    tie_embeddings=True,
    pattern=("attn",),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
