"""qwen1.5-32b [dense] — QKV bias [hf:Qwen/Qwen1.5-32B].

64L, d_model=5120, 40 heads (kv=40, head_dim=128), d_ff=27392, vocab=152064,
untied head."""

from repro_torch.configs.base import ArchConfig, StructureConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    vocab=152_064,
    d_model=5120,
    n_layers=64,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    ffn_kind="swiglu",
    qkv_bias=True,
    pattern=("attn",),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
