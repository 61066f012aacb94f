#!/usr/bin/env python3
"""How often a batch shape changes granite-moe-1b-a400m's expert choices,
on one card:

    python3 scripts/moe_routing_flips.py

A 100-token prompt is prefilled alone (one row, chunks of 32) and as row 3
of 8 rows of other prompts (chunks of 32, and of 16); every layer's top-k
expert ids of the prompt's tokens are compared between the runs.  Dropless
(capacity factor 8: no token takes another's capacity), the serving
weights of ``chip_smoke.py`` (``moe_weights``), three prompts each, in
bf16 at 24 layers and in fp32 at 2 and at 24 layers.  Prints, per run: the
expert choices that differ (of tokens × layers), the tokens with any, the
first such position, the largest gap between the k-th and (k+1)-th
probability of the lone run at a differing choice, the share of all
choices whose gap is below 1e-6 … 1e-3, and the last position's logits'
largest difference and whether its greedy token agrees.  Then the card's
name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def prefill(model, params, record, rows, row, prompt, others, C):
    """Prefill ``prompt`` in row ``row`` of ``rows`` (the others fed
    ``others``) in chunks of C; per layer the prompt's tokens' expert ids
    (T, k) and gaps (T,), and the last position's logits."""
    import torch
    cache = model.init_cache(rows, 512)
    seqs = [prompt if b == row else others[b] for b in range(rows)]
    fed = [0] * rows
    per_layer = [[] for _ in model.specs]
    last = None
    while fed[row] < len(prompt):
        n = [min(C, len(seqs[b]) - fed[b]) for b in range(rows)]
        toks = torch.zeros((rows, C), dtype=torch.int64)
        for b in range(rows):
            toks[b, :n[b]] = torch.tensor(seqs[b][fed[b]:fed[b] + n[b]])
        record.clear()
        logits, _ = model.prefill_chunk(params, cache, toks,
                                        torch.tensor(fed), torch.tensor(n))
        for i, (idx, gap) in enumerate(record):
            per_layer[i].append((
                idx.reshape(rows, C, -1)[row, :n[row]].cpu(),
                gap.reshape(rows, C)[row, :n[row]].float().cpu()))
        last = logits[row, 0].float().cpu()
        fed = [fed[b] + n[b] for b in range(rows)]
    return [(torch.cat([a for a, _ in p]), torch.cat([g for _, g in p]))
            for p in per_layer], last


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    if not torch.cuda.is_available():
        print("moe_routing_flips: needs a CUDA device", file=sys.stderr)
        return 1
    record = []
    real = moe_lib._top_k

    def recorded(probs, k):
        vals, idx = real(probs, k)
        top = torch.sort(probs, dim=-1, descending=True).values[:, :k + 1]
        record.append((idx, (top[:, :-1] - top[:, 1:]).amin(dim=-1)))
        return vals, idx

    moe_lib._top_k = recorded
    gen = torch.Generator().manual_seed(5)
    for dtype, layers in (("bfloat16", 24), ("float32", 2),
                          ("float32", 24)):
        cfg = cs.dropless(dataclasses.replace(
            configs.get(cs.MOE), n_layers=layers, param_dtype=dtype,
            compute_dtype=dtype))
        model = build_model(cfg, device="cuda")
        params = cs.moe_weights(model.init(cs.SEED))
        for trial in range(3):
            prompt = torch.randint(0, cfg.vocab, (100,),
                                   generator=gen).tolist()
            others = [torch.randint(0, cfg.vocab, (int(torch.randint(
                10, 150, (1,), generator=gen)),), generator=gen).tolist()
                for _ in range(8)]
            alone, last = prefill(model, params, record, 1, 0, prompt,
                                  others, 32)
            gaps = torch.cat([g for _, g in alone])
            for what, C in (("8 rows, chunks of 32", 32),
                            ("8 rows, chunks of 16", 16)):
                batched, last_b = prefill(model, params, record, 8, 3,
                                          prompt, others, C)
                flips, at, tokens = 0, [], set()
                for (ia, ga), (ib, _) in zip(alone, batched):
                    differ = (ia != ib).any(dim=-1)
                    flips += int(differ.sum())
                    at += ga[differ].tolist()
                    tokens |= set(torch.nonzero(differ).flatten().tolist())
                print(json.dumps({
                    "dtype": dtype, "layers": layers, "trial": trial,
                    "against": what, "choices": len(gaps),
                    "choices_differing": flips,
                    "tokens_with_a_difference": len(tokens),
                    "first_position": min(tokens) if tokens else None,
                    "max_gap_at_a_difference": max(at) if at else None,
                    "share_gap_below": {t: float((gaps < t).float().mean())
                                        for t in (1e-6, 1e-5, 1e-4, 1e-3)},
                    "last_logits_max_diff": float((last - last_b).abs()
                                                  .max()),
                    "greedy_equal": int(last.argmax()) == int(
                        last_b.argmax())}), flush=True)
        del model, params
    moe_lib._top_k = real
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
