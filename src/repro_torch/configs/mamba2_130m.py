"""mamba2-130m [ssm] — Mamba-2 SSD (state-space duality) [arXiv:2405.21060;
hf state-spaces/mamba2-130m].

24L, d_model=768, attention-free (d_ff=0: the SSD mixer is the whole
block), vocab=50280 tied, d_state=128, head_dim=64, expand=2 (d_inner=1536,
24 SSD heads), conv width 4, chunk 128, no positions.  The state is O(1)
per row.  BLAST applies to in_proj and out_proj; the recurrence has no
weight matrix.
"""

from repro_torch.configs.base import ArchConfig, SSDCfg, StructureConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    vocab=50_280,
    d_model=768,
    n_layers=24,
    n_heads=24,
    n_kv_heads=24,
    d_ff=0,
    ffn_kind="none",
    tie_embeddings=True,
    pos_embed="none",
    pattern=("ssd",),
    ssd=SSDCfg(d_state=128, head_dim=64, expand=2, chunk=128, conv_width=4),
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
