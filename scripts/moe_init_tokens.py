#!/usr/bin/env python3
"""Why granite-moe-1b-a400m at its seeded init repeats one token, and which
weight scale lets its experts decide the tokens (``chip_smoke.py``'s
``MOE_ATTN_OUT_SCALE``), on one card:

    python3 scripts/moe_init_tokens.py

1. The residual stream at ``LM.init(0)``, full width, 24 layers, bf16,
   over 4 random 64-token prompts: for the embedding and each layer's
   attention output, expert output and residual, the norm of the part
   common to every token (the mean over batch and positions) and the mean
   norm of each token's own part; then the greedy token of the last
   position of each prompt and of positions 10–14 of the first.
2. The serve phase's workload (16 prompts of 16–200 tokens, 32 new, 8
   slots, chunk 32, max_len 512, the captured engine) with the attention's
   out projections and the embedding scaled: for each pair of scales the
   least and the mean number of distinct tokens a request emits.

Prints one JSON line each, then the card's name and power limit.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (attention out scale, embedding scale) pairs of part 2
SCALES = ((1.0, 1.0), (1.0, 0.1), (1.0, 3.0), (1.0, 10.0), (1.0, 30.0),
          (0.3, 1.0), (0.1, 1.0), (0.03, 1.0))


def residual_stats(model, params) -> None:
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = model.cfg
    toks = torch.randint(0, cfg.vocab, (4, 64),
                         generator=torch.Generator().manual_seed(1))
    toks, pos = toks.cuda(), torch.arange(64, device="cuda")

    def emit(x, tag):
        xf = x.float()
        common = xf.mean(dim=(0, 1))
        print(json.dumps({"tag": tag, "common_norm": float(common.norm()),
                          "own_norm": float((xf - common).norm(dim=-1)
                                            .mean())}), flush=True)

    with torch.no_grad():
        x = model._embed(params, toks, model.dtype)
        emit(x, "embed")
        for i, (spec, p) in enumerate(zip(model.specs, params["layers"])):
            h = L.norm_apply(p["norm1"], x, spec.norm)
            a = T._MIXERS[spec.kind].apply(spec.mixer, p["mixer"], h, pos)
            emit(a, f"attn{i}")
            x = x + a
            x2, _ = T._ffn(spec, p, x)
            emit(x2 - x, f"experts{i}")
            x = x2
            emit(x, f"residual{i}")
        logits = L.tied_logits(params["embed"], L.norm_apply(
            params["final_norm"], x, cfg.norm))
        print(json.dumps({"greedy_last": logits[:, -1].argmax(-1).tolist(),
                          "greedy_first_prompt_10_14":
                          logits[0, 10:15].argmax(-1).tolist()}), flush=True)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, SamplingParams
    if not torch.cuda.is_available():
        print("moe_init_tokens: needs a CUDA device", file=sys.stderr)
        return 1
    cfg = configs.get(cs.MOE)
    model = build_model(cfg, device="cuda")
    base = model.init(cs.SEED)
    residual_stats(model, base)
    prompts = cs.serve_prompts(cfg.vocab)
    for attn, embed in SCALES:
        cs.MOE_ATTN_OUT_SCALE = attn
        params = cs.moe_weights(base)
        params = {**params, "embed": params["embed"] * embed}
        engine = Engine(model, params, cs.serve_config("none"),
                        device="cuda")
        outs = [r.output for r in engine.generate_batch(
            prompts, SamplingParams(max_new_tokens=32))]
        distinct = [len(set(o)) for o in outs]
        print(json.dumps({"attn_out_scale": attn, "embed_scale": embed,
                          "distinct_tokens_min": min(distinct),
                          "distinct_tokens_mean": statistics.mean(distinct),
                          "tokens_over_all_requests":
                          len({t for o in outs for t in o})}), flush=True)
        del engine, params
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
