"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed experts (top-8) + MTP
[arXiv:2412.19437].

61L, d_model=7168, 128 heads, per-expert d_ff=2048, vocab=129280.  The
first 3 layers take a dense 18432-wide SwiGLU FFN; the other 58 are MoE
(256 routed experts top-8 of 2048 and one shared expert of 2048).  MLA at
the published dims (q_lora=1536, kv_lora=512, nope=128, rope=64, v=128):
decode reads the latent cache with absorbed up-projections.  ``mtp`` marks
the multi-token-prediction head, which the port does not build (ROADMAP
A11)."""

from repro_torch.configs.base import (ArchConfig, MLACfg, MoECfg,
                                      StructureConfig)

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    vocab=129_280,
    d_model=7168,
    n_layers=61,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,                # per routed expert
    ffn_kind="swiglu",
    pattern=("mla",),
    mla=MLACfg(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
               nope_head_dim=128, v_head_dim=128),
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
               d_shared=2048, first_dense_layers=3, dense_d_ff=18432,
               capacity_factor=1.25),
    mtp=True,
    structure=StructureConfig(kind="blast", b=16, keep_ratio=0.5),
)
