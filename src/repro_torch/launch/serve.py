"""Serving launcher of the port: a batch of seeded random prompts through the
chunked-prefill engine, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --requests 16 --max-new 32 --chunk 32 --slots 8 --max-len 512

``--reduced`` runs the small test variant; ``--structure`` one of
``configs.VARIANTS`` swaps the linears' structure (``blast80``, ``dense``,
``low_rank50``, ``monarch50``, ``block_diag``, ``pixelfly50``);
``--device cpu`` runs the plain PyTorch path on the host, eagerly.  On
the card the engine captures its step as CUDA graphs (one per chunk and kv
bucket) and replays them; the launcher prints how many it captured and
the seconds that took, which the prefill and decode rates leave out.
Weights are random, drawn from ``--seed``.
``--quant-weights int8`` (or ``int4``) quantizes them at load (the int8 or
int4 BLAST kernels); adding ``--quant-activations int8`` runs the W8A8 (or
W4A8) kernels.  ``--quant-cache int8`` keeps K/V as int8 codes with
per-(slot, head) scales, attended by the int8-K/V attention kernel.  The
paper's Llama-7B BLAST at full width on one card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama7b-blast \
        --quant-cache int8 --slots 8 --max-len 512

``--paged`` sizes the cache in pages (``--pages`` of ``--page-size``
tokens) with prefix sharing and priority preemption; ``--trace`` drives a
small multi-tenant trace (bulk requests plus shared-prefix interactive
arrivals) tick by tick and prints the SLA report per priority class and
the pool's occupancy:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --paged --pages 16 --page-size 16 \
        --priority-classes 2 --trace

The hybrid recurrentgemma-2b (RG-LRU and sliding-window attention over a
ring cache) serves in every mode: float or quantized weights, ``--paged``
(its RG-LRU state and rings of more than ``--max-len`` slots stay
slot-resident, shared through snapshot slots), ``--speculative`` and
``--quant-cache int8`` (an int8 ring and int8 RG-LRU state):

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --reduced --device cpu --paged

``--speculative K`` decodes self-speculatively: a draft of the model's own
factors truncated to their highest-energy ranks (``--draft-rank-frac`` of
the pooled rank budget) proposes K tokens a round, and one verify chunk of
the full model accepts the agreeing prefix; the launcher prints the draft's
plan and the rounds, acceptance rate and tokens per round:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --reduced --device cpu --speculative 4
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
                               ResilienceConfig, SchedulerConfig,
                               SpeculativeConfig)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--structure", default=None, choices=configs.VARIANTS,
                    help="serve the arch with its linears as this variant "
                         "(configs.variant): BLAST at keep 0.5 or 0.8, dense "
                         "or a baseline structure")
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
                    help="int8 KV cache with per-(slot, head) bf16 scales "
                         "(and int8 recurrent state)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="max total tokens packed into one mixed batch")
    ap.add_argument("--paged", action="store_true",
                    help="page the KV cache: pool sized in tokens, prefix "
                         "sharing + preemption (serve/paged.py)")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: slots*max_len/page_size "
                         "+ 1, slot-static parity)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per cache page (--paged)")
    ap.add_argument("--priority-classes", type=int, default=1,
                    help=">1 enables priority scheduling: class 0 is most "
                         "urgent and may preempt higher classes under page "
                         "pressure (1 = FIFO)")
    ap.add_argument("--deadline", type=float, default=None, metavar="S",
                    help="per-request end-to-end deadline in seconds "
                         "(stop_reason 'deadline' past it)")
    ap.add_argument("--queue-high-water", type=int, default=None,
                    help="shed queued work above this many requests in "
                         "flight")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="self-speculative decoding: draft K tokens per "
                         "round with a rank-truncated copy of the model, "
                         "verify in one full-model chunk (0 = off)")
    ap.add_argument("--draft-rank-frac", type=float, default=0.5,
                    help="fraction of the pooled rank budget the draft "
                         "keeps (--speculative)")
    ap.add_argument("--trace", action="store_true",
                    help="run the built-in multi-tenant trace and print the "
                         "SLA report")
    return ap.parse_args(argv)


def build_engine_config(args) -> EngineConfig:
    """Map the command line onto an ``EngineConfig``."""
    return EngineConfig(
        scheduler=SchedulerConfig(
            slots=args.slots, chunk_size=args.chunk,
            token_budget=args.token_budget,
            policy="priority" if args.priority_classes > 1 else "fifo",
            deadline_s=args.deadline),
        memory=MemoryConfig(max_len=args.max_len, paged=args.paged,
                            page_size=args.page_size, pages=args.pages),
        speculative=SpeculativeConfig(k=args.speculative,
                                      draft_rank_frac=args.draft_rank_frac),
        resilience=ResilienceConfig(queue_high_water=args.queue_high_water),
        seed=args.seed)


def make_cli_trace(vocab, *, n_classes: int, max_new: int, seed: int):
    """Small multi-tenant trace: bulk class-(n-1) requests saturating the
    slots plus interactive class-0 arrivals sharing one 48-token prompt
    prefix, tokens drawn by a numpy generator from ``seed``.  Returns
    [(arrival_tick, Request)] sorted by arrival."""
    rng = np.random.default_rng(seed + 17)

    def toks(n):
        return [int(t) for t in rng.integers(0, vocab, size=n)]
    shared = toks(48)
    lo = max(0, n_classes - 1)
    trace = [(0, Request(uid=i, prompt=toks(8), max_new_tokens=max_new * 2,
                         priority=lo))
             for i in range(6)]   # bulk: long generations, lowest priority
    for i in range(8):   # interactive: the shared prefix, short answers
        trace.append((3 + 2 * i, Request(
            uid=100 + i, prompt=shared + toks(4), max_new_tokens=max_new,
            priority=0)))
    return sorted(trace, key=lambda a: a[0])


def run_trace(engine: Engine, trace) -> dict:
    """Drive the engine tick by tick, submitting each request at its
    arrival tick; returns the SLA report."""
    pending = list(trace)
    tick = 0
    while pending or engine.queue or any(
            s.req is not None for s in engine.slots):
        while pending and pending[0][0] <= tick:
            engine.submit(pending.pop(0)[1])
        engine.tick()
        tick += 1
    return engine.sla_report()


def _ms(s):
    return "-" if s is None else f"{s * 1e3:.1f} ms"


def print_sla(engine: Engine, sla: dict) -> None:
    for c, row in sla["classes"].items():
        print(f"[serve] class {c}: {row['requests']} requests "
              f"{row['stop_reasons']}, TTFT p50 {_ms(row['ttft_p50_s'])} "
              f"p99 {_ms(row['ttft_p99_s'])}, TPOT p50 "
              f"{_ms(row['tpot_p50_s'])} p99 {_ms(row['tpot_p99_s'])}")
    print(f"[serve] preemptions {sla['preemptions']}, prefix-hit "
          f"{sla['prefix_hit_rate']:.2f} ({sla['prefix_hit_tokens']} "
          f"tokens), queue depth p50 {sla['queue_depth_p50']:.1f} max "
          f"{sla['queue_depth_max']}")
    if engine._pc is not None:
        occ = engine._pc.occupancy()
        print(f"[serve] pool: {occ['pages']} pages, {occ['pages_free']} "
              f"free, occupancy {occ['occupancy']:.2f}, "
              f"{sla['pool_tokens']} tokens, {sla['cache_bytes']} bytes")


def main(argv=None) -> list[Request]:
    args = parse_args(argv)
    cfg = configs.get(args.arch, args.structure)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, quant=QuantConfig(
        weights=args.quant_weights, cache=args.quant_cache,
        activations=args.quant_activations))
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = Engine(model, params, build_engine_config(args),
                    device=args.device)
    if args.paged:
        pc = engine._pc
        print(f"[serve] paged: {pc.n_pages} pages x {pc.ps} tokens "
              f"({pc.pool_tokens()} pool tokens vs "
              f"{args.slots * args.max_len} slot-static)")
    if args.speculative:
        plan = engine.draft_plan
        print(f"[serve] speculative k={args.speculative}: draft keeps "
              f"{sum(plan.values())} ranks ({len(plan)} calibrated linears, "
              f"frac={args.draft_rank_frac}): {plan}")
    if args.trace:
        trace = make_cli_trace(cfg.vocab, n_classes=args.priority_classes,
                               max_new=args.max_new, seed=args.seed)
        t0 = time.perf_counter()
        sla = run_trace(engine, trace)
        print(f"[serve] trace: {len(engine.finished)} requests in "
              f"{time.perf_counter() - t0:.3f}s on {args.device}, "
              f"{engine.stats['steps']} steps")
        print_sla(engine, sla)
        return [r for _, r in trace]
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
    if args.speculative:
        print(f"[serve] speculative: {tp['spec_rounds']} rounds, "
              f"acceptance {tp['acceptance_rate']:.2f}, "
              f"{tp['tokens_per_round']:.2f} tok/round")
    print(f"[serve] CUDA graphs captured: {engine.stats['graphs']} in "
          f"{engine.stats['capture_s']:.3f}s")
    return reqs


if __name__ == "__main__":
    main()
