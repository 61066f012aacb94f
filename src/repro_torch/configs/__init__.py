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
follow with their slices."""

from __future__ import annotations

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


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported yet (have {sorted(ARCHS)})")
    return ARCHS[name]
