"""Architecture registry of the port: the dense decoder LMs whose serving
path is ported — smollm-135m, granite-3-2b, internlm2-1.8b, qwen1.5-32b and
the paper's own gpt2-blast and llama7b-blast (RMSNorm or LayerNorm, RoPE or
learned positions, SwiGLU or GELU FFN, tied or untied head, QKV bias,
per-role BLAST ranks) — and the hybrid recurrentgemma-2b (RG-LRU and
sliding-window attention over a ring cache, embedding scaling, a logit
softcap), the ssm family's mamba2-130m (the SSD mixer, no FFN, no
positions), the moe family's granite-moe-1b-a400m (32 routed experts,
top-8) and deepseek-v3-671b (MLA over a latent cache, 256 routed experts
top-8 with a shared expert, three dense first layers).  The other families
follow with their slices.

Every config carries its default structure (BLAST for the assigned archs
at keep 0.5, b = 16, the paper's Llama-7B headline setting); ``variant(cfg,
name)`` and ``get(name, structure)`` swap the linears' structure for one of
``VARIANTS`` — BLAST at keep 0.5 or 0.8, dense, or the paper's baselines
low-rank, Monarch, block-diagonal and Pixelfly (§4) — without touching the
architecture, as the reference's ``configs.variant`` does."""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (ArchConfig, MLACfg,  # noqa: F401
                                      MoECfg, RGLRUCfg, SSDCfg,
                                      StructureConfig)
from repro_torch.configs.deepseek_v3_671b import CONFIG as deepseek_v3_671b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.granite_moe_1b import CONFIG as granite_moe_1b
from repro_torch.configs.internlm2_1_8b import CONFIG as internlm2_1_8b
from repro_torch.configs.mamba2_130m import CONFIG as mamba2_130m
from repro_torch.configs.paper_models import GPT2_BLAST, LLAMA7B_BLAST
from repro_torch.configs.qwen1_5_32b import CONFIG as qwen1_5_32b
from repro_torch.configs.recurrentgemma_2b import CONFIG as recurrentgemma_2b
from repro_torch.configs.smollm_135m import CONFIG as smollm_135m

ARCHS: dict[str, ArchConfig] = {
    "smollm-135m": smollm_135m,
    "internlm2-1.8b": internlm2_1_8b,
    "granite-3-2b": granite_3_2b,
    "qwen1.5-32b": qwen1_5_32b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "mamba2-130m": mamba2_130m,
    "granite-moe-1b-a400m": granite_moe_1b,
    "deepseek-v3-671b": deepseek_v3_671b,
    # the paper's own models
    "gpt2-blast": GPT2_BLAST,
    "llama7b-blast": LLAMA7B_BLAST,
}


VARIANTS = ("blast50", "blast80", "dense", "low_rank50", "monarch50",
            "block_diag", "pixelfly50")


def variant(cfg: ArchConfig, name: str) -> ArchConfig:
    """``cfg`` with every structured linear of the variant ``name`` (one of
    ``VARIANTS``) and no per-role FFN structure; the block count b is kept
    from a BLAST or Monarch config, else 16."""
    b = cfg.structure.b if cfg.structure.kind in ("blast", "monarch") else 16
    table = {
        "dense": StructureConfig(kind="dense"),
        "blast50": StructureConfig(kind="blast", b=b, keep_ratio=0.5),
        "blast80": StructureConfig(kind="blast", b=b, keep_ratio=0.8),
        "low_rank50": StructureConfig(kind="low_rank", keep_ratio=0.5),
        "monarch50": StructureConfig(kind="monarch", b=b, keep_ratio=0.5),
        "block_diag": StructureConfig(kind="block_diag", b=b, keep_ratio=0.5),
        "pixelfly50": StructureConfig(kind="pixelfly", b=b, keep_ratio=0.5),
    }
    if name not in table:
        raise KeyError(f"unknown variant {name!r} (have {list(VARIANTS)})")
    return dataclasses.replace(cfg, structure=table[name], structure_ffn=None)


def get(name: str, structure: str | None = None) -> ArchConfig:
    """The config ``name``, as the variant ``structure`` if one is given."""
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (have {sorted(ARCHS)})")
    return variant(ARCHS[name], structure) if structure else ARCHS[name]
