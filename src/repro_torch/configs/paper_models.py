"""The paper's own decoder LMs (§4): GPT-2 trained from scratch with BLAST_6
(Fig. 5) and Llama-7B compressed at 50% with the paper's exact Table-9
BLAST parameters — b=16, r=1024 for attention and r=1488 for the MLP,
through the per-role structure (``structure`` vs ``structure_ffn``).
Copies of ``repro/configs/paper_models.py``."""

from repro_torch.configs.base import ArchConfig, StructureConfig

GPT2_BLAST = ArchConfig(
    name="gpt2-blast",
    family="dense",
    vocab=50_257,
    d_model=768,
    n_layers=12,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    ffn_kind="gelu",
    norm="layernorm",
    pos_embed="learned",
    max_seq=4096,
    tie_embeddings=True,
    pattern=("attn",),
    # paper §4.1: GPT-2 trained from scratch with BLAST_6
    structure=StructureConfig(kind="blast", b=6, keep_ratio=0.5),
)

LLAMA7B_BLAST = ArchConfig(
    name="llama7b-blast",
    family="dense",
    vocab=32_000,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    ffn_kind="swiglu",
    pattern=("attn",),
    # paper Table 9: 50% CR → r=1024 (attn), r=1488 (MLP), b=16
    structure=StructureConfig(kind="blast", b=16, rank=1024),
    structure_ffn=StructureConfig(kind="blast", b=16, rank=1488),
)
