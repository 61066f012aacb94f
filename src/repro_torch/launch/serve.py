"""Serving launcher of the port: a batch of seeded random prompts through the
chunked-prefill engine, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --max-new 32 --chunk 32 --slots 8 --max-len 512

``--reduced`` runs the small test variant; ``--device cpu`` runs the plain
PyTorch path on the host, eagerly.  On the card the engine captures its
step as CUDA graphs (one per chunk and kv bucket) and replays them; the
launcher prints how many it captured and the seconds that took, which the
prefill and decode rates leave out.  Weights are random, drawn from ``--seed``.
``--quant-weights int8`` (or ``int4``) quantizes them at load (the int8 or
int4 BLAST kernels); adding ``--quant-activations int8`` runs the W8A8 (or
W4A8) kernels.  ``--quant-cache int8`` keeps K/V as int8 codes with
per-(slot, head) scales, attended by the int8-K/V attention kernel.  The
paper's Llama-7B BLAST at full width on one card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama7b-blast \
        --quant-cache int8 --slots 8 --max-len 512
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.quant import QuantConfig, tree_nbytes
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SchedulerConfig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=16,
                    help="prompt tokens one slot may prefill per step")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quant-weights", default="none",
                    choices=["none", "int8", "int4"],
                    help="quantize-at-load weight storage (int4: "
                         "nibble-packed, two codes per byte)")
    ap.add_argument("--quant-activations", default="none",
                    choices=["none", "int8"],
                    help="per-token int8 activations: the BLAST layers run "
                         "the W8A8 (int8 weights) or W4A8 (int4) kernels")
    ap.add_argument("--quant-cache", default="none", choices=["none", "int8"],
                    help="int8 KV cache with per-(slot, head) bf16 scales")
    return ap.parse_args(argv)


def main(argv=None) -> list[Request]:
    args = parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, quant=QuantConfig(
        weights=args.quant_weights, cache=args.quant_cache,
        activations=args.quant_activations))
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=args.slots, chunk_size=args.chunk),
        memory=MemoryConfig(max_len=args.max_len)),
        device=args.device)
    rng = np.random.default_rng(args.seed + 1)
    reqs = [Request(uid=i + 1, max_new_tokens=args.max_new,
                    prompt=[int(t) for t in rng.integers(
                        0, cfg.vocab, size=4 + (i % 5))])
            for i in range(args.requests)]
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    engine.run()
    dt = time.perf_counter() - t0
    tp = engine.throughput()
    for r in reqs:
        print(f"  req {r.uid}: prompt {len(r.prompt)} toks -> "
              f"{len(r.output)} toks {r.output[:8]} ({r.stop_reason})")
    total = sum(len(r.output) for r in reqs)
    print(f"[serve] {len(reqs)} requests, {total} tokens in {dt:.3f}s on "
          f"{args.device}, {args.slots} slots, chunk={args.chunk}, "
          f"{tp['steps']} steps, weights {args.quant_weights}, activations "
          f"{args.quant_activations}, cache {args.quant_cache}, "
          f"{tree_nbytes(engine.params)} parameter bytes")
    print(f"[serve] prefill {engine.stats['prefill_tokens']} toks @ "
          f"{tp['prefill_tok_s']:.1f} tok/s · decode "
          f"{engine.stats['decode_tokens']} toks @ {tp['decode_tok_s']:.1f} "
          "tok/s")
    print(f"[serve] CUDA graphs captured: {engine.stats['graphs']} in "
          f"{engine.stats['capture_s']:.3f}s")
    return reqs


if __name__ == "__main__":
    main()
