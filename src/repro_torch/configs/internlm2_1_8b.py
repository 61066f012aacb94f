"""internlm2-1.8b [dense] — GQA [arXiv:2403.17297].

24L, d_model=2048, 16 heads (GQA kv=8, head_dim=128), d_ff=8192, vocab=92544,
untied head."""

from repro_torch.configs.base import ArchConfig, StructureConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    vocab=92_544,
    d_model=2048,
    n_layers=24,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    ffn_kind="swiglu",
    pattern=("attn",),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
