#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device — name, ``nvidia-smi`` name and power limit, torch/CUDA versions.
   Without a CUDA device, or without the port's sources beside this file,
   the script stops here with exit code 1 and prints no result.
2. build — nvcc builds every kernel under ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the full-width smollm-135m shapes, T = 8, 256 and the training step's
   2048 tokens, fp32 and bf16, max error vs tolerance; two launches of
   every BLAST kernel at T = 8 (r split across blocks) and 2048 (unsplit)
   equal bit for bit: the float BLAST kernels, the int8- and int4-weight
   kernels, the W8A8 and W4A8 kernels (each kernel and its plain version
   get the same activation codes), prefill attention (B3: C = 1 and 32 at
   random offsets, C = 1 at the serving run's positions and at the last
   slot, a window, kv_len < S), and full-sequence attention (B4: causal at
   B=8 T=256 and B=1 T=2048, a ragged T=200, a window, a q_offset,
   non-causal); two launches of B3 at decode (bf16: split keys) and of B4
   at the training shape equal bit for bit; B3's split combine kernel
   alone against its plain version.  Past smollm-135m: every BLAST kernel
   (B1, B2, B5–B12) at n = 8192 (granite-3-2b's down, b = 16) and n = 3072
   (gpt2-blast's down, b = 6), where the input axis is staged in panels,
   and B3 and B4 at head dim 256 (recurrentgemma-2b's heads).  Then
   llama7b-blast's kernels: B1, B2, B5 and B6 at its four BLAST shapes
   (Table 9's r = 1024 and 1488) at T = 8 and 256, fp32 and bf16, two
   launches at T = 8 bit for bit; B3 over int8 K/V (the int8 cache's
   codes and scales) for MHA 32/32 × 128 and GQA 9/3 × 64, C = 1 and 32
   at random offsets, the last slot (one row: split keys, two launches bit
   for bit) and kv_len < S, fp32 and bf16.  Then recurrentgemma-2b's: B3
   over its sliding-window ring (``flash_attention_ring``: key positions
   from the ring's ``pos``; 10/1 heads of 256, B = 8, a 2048-slot ring with
   wrapped rows) at C = 1 and at C = 32 over [ring ‖ chunk], over bf16
   K/V and over the int8 ring's codes and scales
   (``flash_attention_ring_q8``), and B1, B2, B5, B6 at its BLAST shapes
   at T = 8 and 128, fp32 and bf16, two launches of each bit for bit.
   Then mamba2-130m's: B1, B5, B7, B9 and B10 at in_proj's shape (768 →
   3352, b = 8, odd p = 419) and out_proj's (1536 → 768), T = 8 and 256,
   fp32 and bf16, two launches of each at T = 8 bit for bit.  Then
   granite-moe-1b-a400m's: the batched expert kernel (each of the 32
   experts on its own rows: the tile kernel with a per-set x stride) at
   ``wi`` (1024 → 1024, r = 224) and ``wo`` (512 → 1024, r = 144), 3 and
   80 rows an expert, each row set ending in a zero row, fp32 and bf16, in
   float, int8, W8A8, int4 and W4A8, two launches of each at 3 rows bit
   for bit.  Then deepseek-v3-671b's (``phase_kernels_deepseek``): the MLA
   latent kernel (``mla_attention``: scores over [latent ‖ k_rope], 512 +
   64 dims, values the latent, 128 heads on one shared key) at B = 8, S =
   512, C = 1 and 32 at random offsets, the last slot, dead columns with
   an empty row, kv_len < S, fp32 and bf16, two launches at decode bit for
   bit; B1 and B2 at its MLA, shared-expert and dense-FFN shapes and at
   ``wkv_b``'s densification (512 → 32768, T = 512); the batched expert
   kernel at 256 experts, 1 and 40 rows a set, bf16, five storages.
4. grads — fp32 gradients of the four autograd Functions on the training
   path (B1, B2, B4 and the batched expert launch) against torch.autograd
   through the plain versions, at 2048 tokens, and at granite-moe's
   ``wi`` and ``wo`` with 32 experts of 640 rows (full, and with empty
   capacity slots; one batched forward and one batched dx launch): within
   1e-4 × each gradient's largest entry.
5. reference — the full-width model (fp32, depth cut to 2 layers) on the
   card through the kernels against the same model on the CPU through the
   plain versions, over ragged multi-chunk steps, in each serving mode:
   float, int8 weights, W8A8, int4 weights and W4A8; every quantized
   weight's codes (int4: packed bytes) and scales equal on both.  With
   int8 activations the gated run shares the card's activation codes with
   the CPU, after checking that the two differ only by boundary flips.
   llama7b-blast the same way (d_model 4096, vocab 32000, the untied head)
   at one layer, in three modes from one init: float; the int8 cache;
   int8 weights and
   the int8 cache — the cache's K/V rows shared the same way
   (``SharedRowCodes``, after the CPU's codec on the card's inputs gives
   the card's codes bit for bit), and every cache leaf equal on both; and
   gpt2-blast (LayerNorm, learned positions, GELU), float; and
   recurrentgemma-2b at full width cut to 3 layers (rglru, rglru,
   local_attn) and a window of 64, prompts of 200, 120 and 40 tokens in
   chunks of 32 then 4 decode steps, so that the rings wrap: logits, and
   every cache leaf (``pos`` equal; K/V, ``conv``, ``h`` within 1e-3 +
   1e-3·max); and the same over the int8 cache (an int8 ring and int8
   RG-LRU state), the CPU given the card's codes (``SharedRowCodes``).
   mamba2-130m at full width cut to 2 layers the same way (prompts of
   200, 120, 40 tokens in chunks of 32, 4 decode steps; logits, ``conv``
   and ``h``) in six modes — float, int8, W8A8, int4, W4A8 weights, the
   int8 cache — with shared activation and state codes where they are
   int8; in float also ``LM.apply`` (the chunked dual form) against
   ``prefill_chunk`` (the per-token recurrence) on the card.
   granite-moe-1b-a400m at full width cut to 2 layers, fp32, over three
   ragged chunks (idle rows and dead columns, which it routes) and
   ``LM.apply``: logits and ``aux``, in float, int8, W8A8 and the int8
   cache; the CPU takes the card's expert ids (``SharedRouting``, after
   checking that its own differ only at near-ties of 1e-5).
   deepseek-v3-671b at full width cut to one dense and one MoE layer,
   fp32, weights drawn on the card and copied to the host (~31 GB a
   side), the same way over the float and the int8 latent cache (logits,
   ``aux``, every cache leaf; expert ids and the int8 cache's codes
   shared after their checks).
6. train_reference — the same 2-layer fp32 model, one training batch:
   loss, every gradient and the parameters after one AdamW step on the
   card against the CPU.  The same for gpt2-blast (2 layers),
   recurrentgemma-2b (3 layers, window 64, 200 tokens a row: past the
   window), mamba2-130m (4 layers) and granite-moe-1b-a400m (2 layers,
   ``aux`` too, the card's expert ids shared with the CPU after the
   near-tie check), at full width.  Then, once (their results do not
   depend on the family), on smollm-135m's 2 layers: the optimizer alone
   (the card's AdamW step against the CPU's on the card's gradients) and
   ``LM.apply(last_only=True)`` against ``prefill_chunk`` (B4 against
   B3).
7. serve — full-width smollm-135m (30 layers, vocab 49152, bf16, seeded
   random weights) served by the engine in each mode (weights quantized at
   load): 16 prompts of 16-200 tokens, 32 new tokens each, once through
   the captured engine (the default: one CUDA graph per chunk and kv
   bucket, captured at first use) and once through an eager engine
   (``step_fn=model.prefill_chunk``); the greedy tokens of every request
   must be identical, and each run's launch counters (the captured one's
   counted at capture and added on every replay) must equal steps × (90,
   30, 30) in the mode's own kernels, the others staying 0.  Each step's
   B3 key splits follow from its host geometry (``split_plan`` at the kv
   bucket); the run prints how many steps split, and the splits the
   bucket adds against the live key range.  Per mode, per path: graphs
   captured, capture seconds, decode tok/s, step ms and
   ``max_memory_allocated``.  Then, in each mode, through the graphs and
   eagerly, six steady decode steps timed and six more under
   torch.profiler (8 slots, prompts of 16 tokens; 2 of the 30 layers,
   for the script's time): wall, device busy and
   idle share per step, kernel time by name; on every profile whose trace names the kernels (the eager
   one always; ``kernels_by_name``) every BLAST launch runs the tile
   kernel's two ``__global__``s and no other, and attention the bf16
   attention kernel (one a layer a step) and no other
   (``attn_per_step``).  One more float profile each way decodes after
   prompts of 192 tokens, where B3 splits the keys: the split combine must
   run once a layer a step.
   Then llama7b-blast at full width (32 layers, vocab 32000, bf16, seeded
   random weights drawn tensor by tensor; the init's 3,278,639,104
   parameters counted before the pre-stack) in three modes — float, the
   int8 cache (2 layers), int8 weights with the int8 cache (2 layers) —
   the same way, launches steps × (3, 1, 1) a layer with attention in the
   int8-K/V kernel under the int8 cache, and the int8-cache run's peak
   memory below the float run's at 2 layers;
   temperature sampling (T = 0.8, 2 layers) twice with one seed
   (identical tokens) and once with another (different); the decode
   profile in float and with the int8 cache, both ways (2 layers);
   gpt2-blast at full width, float.
   Then ``hybrid``: recurrentgemma-2b at full width (26 layers, vocab
   256000, 1,419,506,176 parameters counted; the embedding scaled by
   ``HYBRID_EMBED_SCALE``, so that the tokens depend on the layers, and
   every hybrid run's requests emit more than one distinct token),
   float and int8 weights (6 of 26 layers),
   captured and eager (tokens equal bit for bit, launches steps × (86 B1,
   18 B2, 8 B3 over the ring)), in the usual run and (6 of 26 layers) in
   a long run of 4 prompts of 2,100–2,600 tokens at max_len 4096 that
   wraps every ring; the float decode profile both ways (6 of 26 layers;
   launches a step,
   the tile and ring kernels' calls and ms, and eagerly the RG-LRU
   recurrence's kernels and ms under a ``record_function`` range); then
   its other serving modes (``phase_hybrid_modes``, at 6 of 26 layers,
   speculation at 3):
   the int8 cache alone and with int8 weights (launches with B3 over the
   int8 ring), int4 weights, the paged cache at max_len 512 (rings paged:
   paged = slot-static bit for bit), prefix sharing through snapshot
   slots at max_len 4096 (fp32 at 3 layers and window 64 too, where the
   rings wrap inside the shared prefix), and speculative decoding at frac
   0.5 (fp32 at 3 layers and window 64 past the rings' wraps, both
   fracs).  Then ``mamba2``: mamba2-130m at full width (24 SSD layers,
   vocab 50280 tied, 83,176,896 parameters counted) in seven modes —
   float, int8, W8A8, int4, W4A8 weights, the int8 cache alone and with
   int8 weights — captured and eager (tokens equal, launches steps × 48
   in the mode's kernel), a long run (4 prompts of 2,000–3,500 tokens at
   max_len 4096; 6 of 24 layers), paged = slot-static (every leaf a state
   leaf: a nominal pool), prefix sharing with ``Request.prefix_len``
   through snapshot slots (bf16, and fp32 at 2 layers), speculation at
   frac 0.4 (graphs, eager, paged, 6 layers; fp32 at 2 layers at 0.4 and
   1.0), and the decode profile (captured at context 64 and 3,000;
   eagerly at 64 and, at 6 layers, over 32-token prefill steps, the SSD
   state update under a ``record_function`` range).  Then ``moe``:
   granite-moe-1b-a400m at full width (24 layers, 32 experts top-8 of
   512, capacity 1.25, vocab 49155 tied, 682,381,312 parameters counted;
   the attention's out projections ×0.3 so that the per-token path decides
   the tokens) in six modes — float at full depth, the int8 cache and
   int8, W8A8, int4, W4A8 weights at 4 layers — captured and eager
   (tokens equal, launches steps × (2 B1, 2 batched expert launches, 1 B3
   by key position) a layer in the mode's kernels), paged = slot-static
   bit for bit at the default capacity (4 layers), and dropless
   (capacity factor 8): prefix sharing (full depth, gated), preemption
   and speculation at frac 0.5 (2 layers; graphs, eager, paged bit for
   bit among themselves, tokens against plain reported: a bf16 batch
   shape re-routes), preemption and speculation in fp32 at 2 layers (gated,
   acceptance ≥ 0.9 at frac 1.0), and the decode profile (4 layers; the
   routing,
   dispatch, gather, experts and combine under ``record_function``
   ranges).  Then ``deepseek``: deepseek-v3-671b at full width (MLA over
   a latent cache, 256 experts top-8 and a shared expert, dense first
   layers, vocab 129280 untied; weights drawn on the card): float at 3
   dense + 2 MoE layers (≈ 28 GB) and int8, W8A8, int4, W4A8 weights and
   the int8 latent cache at 1 + 1, 8 prompts each, captured = eager and
   launches steps × (4 B1, 2 B2, 1 MLA kernel a layer, 2 batched launches
   a MoE layer); paged = slot-static (1 + 1); dropless (capacity factor
   32) prefix sharing, preemption and speculation at frac 0.7 (bf16:
   tokens against plain reported; fp32 at 1 + 1: gated at the 1e-4
   margin, acceptance ≥ 0.9 at frac 1.0); the decode profile (the MLA
   kernel's calls and ms, the routing glue and the absorbed matrices
   under ranges).
8. paged — the paged cache (``serve/paged.py``, pages of 16 tokens)
   through the same engine, captured per (C, kv, F, M) bucket.  Run 1, in
   smollm-135m float and int8 weights and llama7b-blast float
   and int8 cache (2 layers each), each beside a slot-static run at that
   depth: the serve phase's 16 prompts through a paged engine with the
   default pool, captured and eager: greedy tokens equal the same mode's
   slot-static run and each other bit for bit, launches steps × the
   mode's per-step counts, ``audit`` (refcounts, free list, the zero page
   still the template) after each run; decode step ms and tok/s against
   slot-static, graphs and capture seconds, pool and view bytes, peak
   memory, and the gather's and scatter's device ms of a decode step at
   kv 64 and 256 (CUDA events).  Run 2, smollm-135m and llama7b-blast
   float (2 layers each): 16 requests
   sharing a 256-token system prompt on a pool of half of B·max_len
   tokens: ≥ 15·256 prefix-hit tokens, tokens equal an unshared
   slot-static run's up to each request's first near-tie (``near_tie``:
   the margin rule of ``tests/test_torch_engine.py`` in the logits'
   precision).  Run 3, llama7b-blast float (2 layers): 6 bulk requests at priority
   1, then 4 at priority 0 after 8 ticks, on a pool too small for them:
   preemptions, every request finished by length, two runs identical,
   tokens equal a roomy pool's up to each first near-tie; then the same
   run in fp32 at 1 layer, where the rule is the 1e-4 margin alone.
9. spec — self-speculative decoding (k = 4) of the serve phase's 16
   prompts, at draft rank fractions 0.5 and 1.0, in smollm-135m float and
   int8 weights (full width, 2 of its 30 layers), and llama7b-blast (full
   width, 2 of its 32 layers) float
   and with the int8 cache: the tokens equal the same config's plain
   engine's up to each request's first near-tie; at frac 0.5 the captured
   round equals the eager round (``step_fn``; llama float) and paged
   equals slot-static (int8 cache aside) bit for bit (every round's token
   ids, every plain step's logits); launches
   rounds × (k + 2) plus plain steps × 2 (the step and the draft's
   replay) times the per-step counts; no launch pads its factors' rank
   (the draft is padded once at load; smollm also checks the padded
   draft's logits against the unpadded draft's, bit for bit); ``audit``
   when paged.  Each run prints rounds, acceptance, tokens a round, decode
   tok/s and ms a round against the plain engine's, graphs, capture s,
   peak memory and the draft's parameter bytes.  The same in fp32 at 2
   layers of llama7b-blast, held to the 1e-4 margin alone, frac 1.0
   accepting ≥ 90%.  ``spec_split``: at llama7b-blast's full width, 2
   layers, a draft step and the resync at frac 0.5 and 1.0, the verify
   chunk (T = 64), the plain step and a whole captured round at each frac,
   each a CUDA graph timed by CUDA events.
10. train — full-width smollm-135m trained by the port's ``Trainer`` for 20
   steps through the captured step (bf16, remat, batch 8 × seq 256 of the
   Markov ``TokenStream``, lr 1e-3 with warmup 5; one eager warm-up step,
   then one CUDA graph of the whole step): per step loss, grad norm,
   skipped flag, time and launches; the median step time, training
   tokens/s, peak device memory, launches per step, and one more step
   under torch.profiler each way.  Every loss finite, no step skipped, the
   loss of a batch no step sees lower after the run than before, B4
   launched 30 × 2 times a step,
   no serving-only kernel; the profiled step's attention is the bf16 tile
   kernel alone, 60 launches.  A ``Trainer(jit=False)`` from the same init
   on the same batches: loss, grad norm and every parameter equal the
   captured run's bit for bit after each of 3 steps.  One more captured
   step whose loss is made non-finite (NaN in the embedding row of its
   first token) reports skipped, leaves params, m and v bit for bit and
   still counts.  Then the same captured run (no profile) for gpt2-blast
   (6 of 12 layers, 60 steps), recurrentgemma-2b (3 of 26: one cycle, 10
   steps), mamba2-130m (12 of 24, 20 steps) and granite-moe-1b-a400m (6
   of 24, 20 steps; the batched expert launches forward, in remat's
   recompute and as dx counted), each at full width, batch 8 × 256, lr
   1e-3: captured = eager bit for bit for 3 steps, the NaN step skipped,
   and a held-out batch's loss lower after the run than before (gpt2-blast's
   rises over its first 20 to 40 steps, as the reference's does).
11. timing — CUDA events, median of 25 runs after warm-up with the L2 cache
   flushed before each run: kernel, plain version and one PyTorch library
   call (a yardstick only; the port never calls it), at decode, prefill
   and training shapes (B3 at decode also at the serving run's positions,
   16–32; B4; B1 and B2 forward and B1 as the backward's dx
   at 2048 tokens), and every BLAST kernel at n = 8192 (panels), beside
   each call's bound on the H100; the W8A8 and W4A8 rows also time the
   kernel alone on ready codes and print the quantize prologue's share.
   llama7b-blast's rows: its BLAST shapes (float, int8 weights) at T = 8
   and 256, and B3 over int8 K/V at its decode and prefill (library:
   ``dequantize_rows``, then masked SDPA; ``float_kv_ms``: B3 on bf16 K/V
   of the same values).  recurrentgemma-2b's: B3 over its ring at decode
   and at C = 32 (library: SDPA with the mask of the ring's positions),
   over bf16 K/V and over the int8 ring (library: ``dequantize_rows``,
   then that SDPA).  mamba2-130m's: its two BLAST shapes at T = 8 and
   256, float and the four quantized modes.  granite-moe-1b-a400m's: the
   batched expert kernel at ``wi`` and ``wo``, 32 experts at 3 and 80
   rows, float and the four quantized modes, and at a training step's
   640 rows forward and as dx (library: ``torch.bmm`` of each expert's
   rows with its dense matrix).  deepseek-v3-671b's: the MLA kernel at
   decode and at C = 32 (library: the reference's einsums as
   ``torch.matmul``), B1 at ``wkv_b``'s densification, B2 at ``wq_a`` +
   ``wkv_a``, and the batched expert kernel at 256 experts, 1 and 40 rows.
   The profiles of phases 7 and 10 also sum the
   BLAST tile kernel's two ``__global__``s (``blast_tile_kernel``,
   ``blast_split_sum``) and the attention kernel's (``attn_tile_kernel``,
   ``attn_split_combine``).

12. structures — the paper's baselines and its compression.  ``reference
   structures``: smollm-135m at full width, fp32, 2 layers, card against
   CPU as low_rank50, monarch50, pixelfly50 and block_diag, float and int8
   weights (codes and scales equal; logits within 1e-3 + 1e-3·max a row).
   ``smollm variants``: smollm-135m at full width (30 layers, bf16, the
   attention out projections ×0.1: ``variant_weights``) in every variant
   of ``configs.VARIANTS`` (blast50 is the ``serve none`` run) and int8
   weights for low_rank50 and pixelfly50, 8 prompts of 16 new tokens:
   captured = eager, launches steps × (3, 1, 1) a layer for BLAST and B3
   alone for the other kinds, every request more than one distinct token,
   and the captured decode profile; a ``variants`` line with each one's
   step ms, busy ms, kernels a step, parameter bytes and kernels.  ``spec
   low_rank50``: the low-rank model's draft (its factors truncated by
   energy), fp32 at 2 layers and frac 1.0 (tokens = plain's at the 1e-4
   margin, acceptance ≥ 0.9), bf16 at 2 layers and frac 0.5 (paged =
   slot-static; acceptance reported).  ``compress``: Algorithm 2 card
   against CPU at 512², b = 16, r = 128, 20 steps from one start (losses
   within 1e-4 relative); one llama7b-blast layer of power-law weights
   (the reference example's ``synth_weight``) compressed by
   ``compress_tree`` into the per-role BLAST ranks, low_rank50, monarch50
   and block_diag (``COMPRESS_STEPS`` steps a fit): errors, seconds,
   Algorithm 2's loss before its first step and after its last and its
   seconds a step; BLAST's error at most block_diag's on every linear; the
   BLAST layer served through B1/B2/B3 (captured = eager) and held card
   against CPU in fp32.  ``train structures``: gpt2-blast (full width, 2
   layers) as low_rank50, monarch50 and pixelfly50 through ``phase_train``
   (captured = eager bit for bit, the held-out loss falls, B4 the only
   kernel).

The structures phases run after smollm-135m's serving phases, before
llama7b-blast's.  deepseek-v3-671b's kernels, reference and serving phases
run after the training phases, before ``timing``.  Each phase's seconds are printed on a
``{"phase": "seconds"}`` line.  The
last lines are the per-kernel JSON summary, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
# the training runs: the launcher's batch 8 × seq 256, lr 1e-3 (every
# family; see TRAIN_RUNS), warmup 5, 20 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 256, 20, 1e-3, 5
PEAK_FLOPS = {"float32": 67e12,         # no tensor cores
              "bfloat16": 989e12,       # dense tensor cores
              "int8": 1979e12}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEED = 0
DEVICE = "cuda"
# serving modes: (quant.weights, quant.activations) and the launch keys of
# their (BLAST, grouped BLAST) kernels
MODES = {"none": (("none", "none"), ("blast_matmul", "blast_matmul_grouped")),
         "int8": (("int8", "none"), ("blast_matmul_q", "blast_matmul_grouped_q")),
         "w8a8": (("int8", "int8"),
                  ("blast_matmul_w8a8", "blast_matmul_grouped_w8a8")),
         "int4": (("int4", "none"),
                  ("blast_matmul_q4", "blast_matmul_grouped_q4")),
         "w4a8": (("int4", "int8"),
                  ("blast_matmul_w4a8", "blast_matmul_grouped_w4a8"))}
QUANT_MODES = ("int8", "w8a8", "int4", "w4a8")
# llama7b-blast's serving modes: (quant.weights, quant.cache)
LLAMA_MODES = {"float": ("none", "none"), "int8_cache": ("none", "int8"),
               "int8_int8_cache": ("int8", "int8")}
# model.init's parameters of llama7b-blast before the pre-stack: 32 layers of
# BLAST qkv (r = 1024), out (1024), gate, up and down (1488) and two norms,
# the embedding, the untied head and the final norm
LLAMA_PARAMS = 3_278_639_104


def mode_bits_act(mode) -> tuple[int | None, str]:
    """(weight bits, activation mode) of a serving mode."""
    weights, act = MODES[mode][0]
    return {"none": None, "int8": 8, "int4": 4}[weights], act


def card_seed():
    """A generator on the card seeded with ``SEED``: ``LM.init`` draws a
    full-width model's billions of parameters there in seconds, where the
    host's generator takes tens of seconds (other numbers than a CPU
    generator's)."""
    import torch
    return torch.Generator(device=DEVICE).manual_seed(SEED)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_close(name: str, got, want, dtype: str,
                scaled: bool = False) -> float:
    """Max |got - want|; raises past ``atol + rtol·|want|`` (rtol = the
    dtype's tolerance; atol = rtol, or with ``scaled`` rtol·min(1,
    max|want|): a limit in the output's own scale where outputs are small,
    as attention's over thousands of keys are)."""
    import torch
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs "
                           f"{tuple(w.shape)} or non-finite output")
    atol = tol * min(1.0, float(w.abs().max())) if scaled else tol
    err = (g - w).abs()
    bad = err > atol + tol * w.abs()
    max_err = float(err.max())
    emit({"phase": "kernels", "case": name, "dtype": dtype,
          "max_abs_err": max_err, "rtol": tol, "atol": atol,
          "ok": not bool(bad.any())})
    if bad.any():
        raise RuntimeError(f"{name}: kernel disagrees with its plain version"
                           f" (max abs err {max_err}, atol {atol}, rtol {tol})")
    return max_err


# -- main-path shapes ---------------------------------------------------------


def blast_shapes(cfg):
    """(name, n, m, b, r, G) of every BLAST launch in one smollm-135m layer."""
    from repro_torch.models.transformer import make_block
    blk = make_block(cfg, "attn")
    out = []
    for name, spec, G in (("qkv", blk.mixer.qkv, 1), ("out", blk.mixer.out, 1),
                          ("down", blk.ffn.wo, 1), ("gate+up", blk.ffn.gate, 2)):
        out.append((name, spec.d_in, spec.d_out, spec.meta["b"],
                    spec.meta["r"], G))
    return out


def make_blast_inputs(n, m, b, r, G, T, dtype, gen, device):
    """x (T, n) and G factor sets (``core/blast.py::init``'s scales),
    drawn on the generator's device: a CUDA generator draws 256 experts'
    factors in seconds."""
    import torch
    from repro_torch.core import blast as blast_lib
    x = torch.randn((T, n), generator=gen, device=gen.device).to(
        device=device, dtype=dtype)
    sets = [blast_lib.init(gen, m, n, b, r, dtype=dtype, device=device)
            for _ in range(G)]
    U, S, V = (torch.stack([s[k] for s in sets]) for k in range(3))
    return x, U, S, V


def quantize_factors(U, S, V, bits=8):
    """Per-block codes (G, b, ·, r) — int4: nibble-packed (G, b, ·, ⌈r/2⌉)
    — and scales su/sv (G, b), ss (G, b, b) of stacked float factors, as
    the model quantizes them."""
    import torch
    from repro_torch import quant
    G, b = U.shape[:2]
    codes, scales = [], []
    for a, axes, shape in ((U, (1, 2), (b,)), (S, (2,), (b, b)),
                           (V, (1, 2), (b,))):
        qa = [quant.quantize(a[g].float(), bits=bits, block_axes=axes)
              for g in range(G)]
        codes.append(torch.stack([x.q for x in qa]))
        scales.append(torch.stack([x.scale.reshape(shape) for x in qa]))
    return codes, scales


def quant_calls(mode, x, codes, scales, r):
    """(kernel name, kernel call, plain call) of one BLAST launch in a
    quantized mode (int8 / W8A8 on int8 codes, int4 / W4A8 on packed codes
    of logical rank r); G = 1 goes through ``blast_matmul_q`` with QArray
    factors, as the model calls it."""
    from repro_torch import quant
    from repro_torch.kernels import ops, ref
    bits, act = mode_bits_act(mode)
    (Uc, Sc, Vc), (su, ss, sv) = codes, scales
    G, b = Uc.shape[:2]
    kname = MODES[mode][1][G > 1]
    if G == 1:
        fac = [quant.QArray(c[0], s_.reshape(shape), bits=bits, last_dim=r)
               for c, s_, shape in ((Uc, su, (b, 1, 1)), (Sc, ss, (b, b, 1)),
                                    (Vc, sv, (b, 1, 1)))]
        kern = lambda: ops.blast_matmul_q(x, *fac, act=act)[None]  # noqa: E731
    else:
        grouped = (ops.blast_matmul_grouped_q4 if bits == 4
                   else ops.blast_matmul_grouped_q)
        kern = lambda: grouped(  # noqa: E731
            x, Uc, Sc, Vc, su, ss, sv, act=act)
    if act == "int8":
        plain_a8 = (ref.blast_matmul_grouped_a4_ref if bits == 4
                    else ref.blast_matmul_grouped_a8_ref)

        def plain():
            xq, sx = quant.quantize_act(x)        # the wrapper's prologue
            return plain_a8(xq, sx, Uc, Sc, Vc, su, ss, sv).to(x.dtype)
    else:
        plain_q = (ref.blast_matmul_grouped_q4_ref if bits == 4
                   else ref.blast_matmul_grouped_q_ref)
        plain = lambda: plain_q(x, Uc, Sc, Vc, su, ss, sv)  # noqa: E731
    return kname, kern, plain


def make_attn_inputs(B, Hq, Hkv, C, S, D, dtype, gen, device, offsets=None):
    """q (B, Hq, C, D) as the model's transposed view, the cache in its
    (B, S, Hkv, D) layout viewed as (B, Hkv, S, D), row offsets drawn from
    ``offsets`` = (lo, hi) inclusive (default: anywhere, 0 … S − C)."""
    import torch
    lo, hi = offsets or (0, S - C)
    q = torch.randn((B, C, Hq, D), generator=gen).to(device=device, dtype=dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen).to(device=device, dtype=dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen).to(device=device, dtype=dtype)
    offs = torch.randint(lo, hi + 1, (B,), generator=gen).to(device=device,
                                                             dtype=torch.int32)
    return (q.transpose(1, 2), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            offs)


# decode positions of the serving run's profiled steps (prompts of 16
# tokens, then decode): the offsets of the timing phase's "serving" row
SERVING_OFFSETS = (16, 32)
# prompt tokens of the float decode profile whose context spans four key
# tiles (positions 194–199, near the top of the serving run's 16–232), where
# B3 takes its split path
LONG_PROMPT = 192
# B3 cases of the kernels phase (B = 8, S = 512): (C, offsets, options) —
# anywhere, at the serving run's positions, at the last slot (every split
# live), a window, kv_len < S
B3_CASES = [(1, None, {}), (32, None, {}), (1, SERVING_OFFSETS, {}),
            (1, (511, 511), {}), (32, None, {"window": 100}),
            (20, None, {"kv_len": 400})]
# B4 cases of the kernels phase: (B, T, S, options)
B4_CASES = [(8, 256, 256, {}), (1, 2048, 2048, {}), (8, 200, 200, {}),
            (8, 256, 256, {"window": 64}), (8, 256, 320, {"q_offset": 64}),
            (8, 256, 256, {"causal": False})]
# Past smollm-135m.  BLAST down projections whose n = b·q passes the tile
# kernel's resident layout, so that it stages the input axis in panels:
# (label, n, m, b, r) at keep 0.5, r = keep·m·n / (m + n + b²) rounded to
# 16.  Attention at head dim 256: recurrentgemma-2b's 10 query heads over
# 1 kv head (Hq, Hkv, D), with its B4 cases.
WIDE_BLAST = [("granite-3-2b down", 8192, 2048, 16, 800),
              ("gpt2-blast down", 3072, 768, 6, 304)]
WIDE_HEADS = (10, 1, 256)
B4_WIDE_CASES = [(2, 512, 512, {}), (2, 256, 256, {"window": 64}),
                 (2, 256, 320, {"q_offset": 64})]


def make_full_attn_inputs(B, Hq, Hkv, T, S, D, dtype, gen, device):
    """q, k, v (B, H, T, D) as strided views of one token-major buffer per
    role, as the attention layer passes views of the qkv projection."""
    import torch
    q = torch.randn((B, T, Hq, D), generator=gen).to(device=device,
                                                      dtype=dtype)
    kv = torch.randn((B, S, 2 * Hkv, D), generator=gen).to(device=device,
                                                            dtype=dtype)
    return (q.transpose(1, 2), kv[:, :, :Hkv].transpose(1, 2),
            kv[:, :, Hkv:].transpose(1, 2))


def blast_cost(n, m, b, r, G, T, elt, mode="none", batched=False):
    """(bytes, {dtype: operations}) of one BLAST call taking x of ``elt``
    bytes and writing y of that type: every input read once, the output
    written once.  Quantized factors are 1-byte int8 codes or ⌈r/2⌉ bytes
    of packed int4 per factor row, plus fp32 scales (2b + b² per set);
    the W8A8 and W4A8 stage 1 runs at the int8 rate.  ``batched``: each of
    the G sets reads its own T rows of x (the MoE experts), G·T·n values."""
    p, q = m // b, n // b
    rows = G * b * (p + b + q)            # factor rows of r ranks each
    bits, act = mode_bits_act(mode)
    x_rows = G * T if batched else T
    if bits is None:
        bytes_ = (x_rows * n + rows * r + G * T * m) * elt
    else:
        row_bytes = (r + 1) // 2 if bits == 4 else r
        bytes_ = ((x_rows * n + G * T * m) * elt + rows * row_bytes
                  + G * (2 * b + b * b) * 4)
    stage1 = 2 * G * T * n * r
    rest = 2 * G * T * (m * r + b * b * r)
    if act == "int8":
        return bytes_, {"int8": stage1, "bfloat16": rest}
    return bytes_, {"bfloat16": stage1 + rest}


def attn_cost(q, k, offs, elt, int8_kv=False):
    """(bytes, flops) of B3: q read and o written in ``elt`` bytes, the
    visible K/V rows read once — in ``elt`` bytes, or as int8 codes with a
    bf16 scale per (key, head) — and the row offsets."""
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    offs = [int(o) for o in offs.cpu()]
    keys = sum(min(S, o + C) for o in offs)                    # visible rows
    pairs = sum(min(S, o + t + 1) for o in offs for t in range(C))
    kv_row = D + 2 if int8_kv else D * elt
    bytes_ = 2 * B * Hq * C * D * elt + 2 * keys * Hkv * kv_row + 4 * B
    flops = 4 * D * Hq * pairs
    return bytes_, flops


def full_attn_cost(B, Hq, Hkv, T, S, D, elt, causal=True, window=None,
                   q_offset=0):
    """(bytes, flops) of B4: q, k, v read once and o written once; 4·D
    flops (QKᵀ and PV) per visible (query, key) pair of each query head."""
    pairs = 0
    for t in range(T):
        hi = min(S, q_offset + t + 1) if causal else S
        lo = max(0, q_offset + t - window + 1) if window else 0
        pairs += max(0, hi - lo)
    bytes_ = (2 * B * Hq * T * D + 2 * B * Hkv * S * D) * elt
    return bytes_, 4 * D * B * Hq * pairs


def bound(bytes_, ops_by_dtype):
    """(bytes time, operations time) in ms on the H100."""
    return (bytes_ / HBM_BYTES_PER_S * 1e3,
            sum(f / PEAK_FLOPS[d] for d, f in ops_by_dtype.items()) * 1e3)


def time_ms(fn, flush, reps=25, warmup=5) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), with
    the L2 cache flushed before each run (the main path streams 157 MB of
    weights per step through a 50 MB L2, so every call finds it cold)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        # keep the device busy while the host enqueues the run, so the
        # events time the device work and not the host's launch overhead
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


# -- phases -------------------------------------------------------------------


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: the port's sources are not under {SRC}")
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit({"phase": "device", **dev, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return dev, smi


def ptxas_usage(log: str) -> list[dict]:
    """Registers and spill bytes of each kernel from ptxas' ``-v`` report."""
    import re
    import shutil
    out, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append({"kernel": name, "registers": int(m.group(1)),
                        "spill_store_bytes": spill})
            name = None
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(
            u["kernel"] for u in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        for u, n in zip(out, names):
            u["kernel"] = n.replace("(anonymous namespace)::",
                                    "").split("(")[0]
    return out


def phase_build():
    from repro_torch.kernels import blast_matmul, build, flash_attention
    t0 = time.perf_counter()
    paths = build.build_all()
    blast_matmul.float_tiles()    # loads and types the libraries
    flash_attention._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()},
          "ptxas": {k: ptxas_usage(log) for k, log in build.build_logs.items()}})


def blast_calls(x, U, S, V, r, modes):
    """(kernel name, kernel call, plain call) of the float kernel and of
    the quantized ``modes`` at one shape: G = 1 the plain kernels, G > 1
    the grouped ones."""
    from repro_torch.kernels import ops, ref
    if U.shape[0] == 1:
        calls = [("blast_matmul",
                  lambda: ops.blast_matmul(x, U[0], S[0], V[0]),
                  lambda: ref.blast_matmul_ref(x, U[0], S[0], V[0]))]
    else:
        calls = [("blast_matmul_grouped",
                  lambda: ops.blast_matmul_grouped(x, U, S, V),
                  lambda: ref.blast_matmul_grouped_ref(x, U, S, V))]
    packed = {bits: quantize_factors(U, S, V, bits=bits)
              for bits in {mode_bits_act(mode)[0] for mode in modes}}
    return calls + [quant_calls(mode, x, *packed[mode_bits_act(mode)[0]], r)
                    for mode in modes]


def phase_kernels(cfg):
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    # the B3 cases past the first two, the repeats and the combine check
    # draw from a generator of their own, so that the other cases keep
    # their inputs (and fp32 errors) as the kernels change around them
    gen_b3 = torch.Generator().manual_seed(SEED + 18)
    errs = {k: 0.0 for k in SOURCES}

    def check(kname, label, got, want, dname):
        torch.cuda.synchronize()
        e = check_close(f"{kname}[{label}]", got.reshape(want.shape), want,
                        dname)
        if dname == "bfloat16":
            errs[kname] = max(errs[kname], e)

    def attention(hq, hkv, hd, full_cases, dtype, dname):
        for i, (C, offsets, kw) in enumerate(B3_CASES):
            q, k, v, offs = make_attn_inputs(8, hq, hkv, C, 512, hd, dtype,
                                             gen if i < 2 else gen_b3, DEVICE,
                                             offsets)
            where = "" if offsets is None else f" offsets={list(offsets)}"
            check("flash_attention_prefill",
                  f"B=8 Hq={hq} Hkv={hkv} C={C} S=512 D={hd}{where}"
                  + (f" {kw}" if kw else ""),
                  ops.flash_attention_prefill(q, k, v, offs, **kw),
                  ref.attention_prefill_ref(q, k, v, offs, **kw), dname)
            if i == 1:        # the B4 cases draw after the first two
                full(hq, hkv, hd, full_cases, dtype, dname)

    def full(hq, hkv, hd, full_cases, dtype, dname):
        for B, T, S, kw in full_cases:
            q, k, v = make_full_attn_inputs(B, hq, hkv, T, S, hd, dtype, gen,
                                            DEVICE)
            check("flash_attention",
                  f"B={B} Hq={hq} Hkv={hkv} T={T} S={S} D={hd} {kw}",
                  ops.flash_attention(q, k, v, **kw),
                  ref.attention_ref(q, k, v, **kw), dname)

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, n, m, b, r, G in blast_shapes(cfg):
            for T in (8, 256, TRAIN_BATCH * TRAIN_SEQ):
                x, U, S, V = make_blast_inputs(n, m, b, r, G, T, dtype, gen,
                                               DEVICE)
                calls = blast_calls(x, U, S, V, r, QUANT_MODES)
                if T != 256:          # T = 8 splits r, 2048 does not
                    for call in calls:
                        repeat_identical(call, name, T, dname)
                for kname, kern, plain in calls:
                    check(kname, f"{name} {n}->{m} b={b} r={r} G={G} T={T}",
                          kern(), plain(), dname)
        for label, n, m, b, r in WIDE_BLAST:
            for G in (1, 2):
                for T in (8, 256):
                    x, U, S, V = make_blast_inputs(n, m, b, r, G, T, dtype,
                                                   gen, DEVICE)
                    for kname, kern, plain in blast_calls(x, U, S, V, r,
                                                          QUANT_MODES):
                        check(kname, f"{label} {n}->{m} b={b} r={r} G={G} "
                              f"T={T}", kern(), plain(), dname)
        attention(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, B4_CASES,
                  dtype, dname)
        attention(*WIDE_HEADS, B4_WIDE_CASES, dtype, dname)
        attention_repeats(cfg, dtype, dname, gen_b3)
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"],
                                          check_combine(cfg, gen_b3))
    return errs


# llama7b-blast's kernels (the paper's Table-9 ranks, MHA heads of 128):
# its four BLAST launches at decode and prefill, and B3 over int8 K/V
# (B, C, offsets, options) for MHA 32/32 × 128 and smollm-135m's 9/3 × 64,
# S = 512: anywhere, a chunk, the last slot (8 rows: every key tile; 1 row:
# the key split), a chunk with kv_len < S
LLAMA_T = (8, 256)
Q8_HEADS = [(32, 32, 128), (9, 3, 64)]
Q8_CASES = [(8, 1, None, {}), (8, 32, None, {}), (8, 1, (511, 511), {}),
            (1, 1, (511, 511), {}), (8, 20, None, {"kv_len": 400})]


def make_q8_inputs(B, Hq, Hkv, C, S, D, dtype, gen, offsets=None):
    """``make_attn_inputs`` with K and V stored as the int8 cache stores
    them: codes (B, S, Hkv, D) and bf16 scales (B, S, Hkv) from
    ``quantize_rows``, passed as their (B, Hkv, S, ·) views."""
    from repro_torch import quant
    q, k, v, offs = make_attn_inputs(B, Hq, Hkv, C, S, D, dtype, gen, DEVICE,
                                     offsets)
    (kq, ks), (vq, vs) = (quant.quantize_rows(a.permute(0, 2, 1, 3))
                          for a in (k, v))
    return (q, kq.permute(0, 2, 1, 3), vq.permute(0, 2, 1, 3),
            ks.transpose(1, 2), vs.transpose(1, 2), offs)


def phase_kernels_llama(llama, errs) -> None:
    """llama7b-blast's kernels against their plain versions on the card:
    B1, B2 (gate+up) and their int8-weight twins B5, B6 at its four BLAST
    shapes (qkv 4096→12288 and out 4096→4096 at r = 1024, gate+up
    4096→11008 and down 11008→4096 at r = 1488: p = 688 and q = 688 in
    ragged column chunks, down in panels) at T = 8 and 256, fp32 and bf16,
    two launches at T = 8 bit for bit; B3 over int8 K/V (``Q8_CASES``),
    fp32 and bf16, two launches of the split case bit for bit."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 20)

    def check(kname, label, got, want, dname):
        torch.cuda.synchronize()
        e = check_close(f"{kname}[llama7b-blast {label}]",
                        got.reshape(want.shape), want, dname)
        if dname == "bfloat16":
            errs[kname] = max(errs[kname], e)

    def repeat(kname, label, kern, dname):
        first, second = kern(), kern()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        emit({"phase": "kernels", "case": f"{kname}[llama7b-blast {label}] "
              "repeat", "dtype": dname, "bitwise_identical": same,
              "ok": same})
        if not same:
            raise RuntimeError(f"{kname}[{label} {dname}]: two launches "
                               "differ")

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, n, m, b, r, G in blast_shapes(llama):
            _, U, S, V = make_blast_inputs(n, m, b, r, G, 1, dtype, gen,
                                           DEVICE)
            for T in LLAMA_T:
                x = torch.randn((T, n), generator=gen).to(DEVICE, dtype)
                label = f"{name} {n}->{m} b={b} r={r} G={G} T={T}"
                for kname, kern, plain in blast_calls(x, U, S, V, r,
                                                      ("int8",)):
                    if T == LLAMA_T[0]:
                        repeat(kname, label, kern, dname)
                    check(kname, label, kern(), plain(), dname)
            del U, S, V
        for hq, hkv, hd in Q8_HEADS:
            for B, C, offsets, kw in Q8_CASES:
                args = make_q8_inputs(B, hq, hkv, C, 512, hd, dtype, gen,
                                      offsets)
                label = (f"B={B} Hq={hq} Hkv={hkv} C={C} S=512 D={hd}"
                         + ("" if offsets is None else
                            f" offsets={list(offsets)}")
                         + (f" {kw}" if kw else ""))
                if (B, offsets) == (1, (511, 511)):
                    repeat("flash_attention_prefill_q8", label,
                           lambda: ops.flash_attention_prefill_q8(*args),
                           dname)
                check("flash_attention_prefill_q8", label,
                      ops.flash_attention_prefill_q8(*args, **kw),
                      ref.attention_prefill_q8_ref(*args, **kw), dname)


HYBRID = "recurrentgemma-2b"
HYBRID_PARAMS = 1_419_506_176        # the reference's LM.init, eval_shape
HYBRID_T = (8, 128)                  # decode; a long-run prefill step
# B3 over the ring at recurrentgemma-2b's shapes: B = 8, a 2048-slot ring
# (wrapped rows), C = 1 (decode: the ring alone) and C = 32 (a chunk:
# [ring ‖ chunk], 2080 keys)
RING_CASES = (1, 32)


def ring_q8(k, v):
    """An int8 ring's K/V as the ring layer passes them: codes (B, Hkv, S_k,
    D) and bf16 scales (B, Hkv, S_k) of ``quantize_rows`` (the cache's own
    codec) of the views k, v."""
    from repro_torch import quant
    (kq, ks), (vq, vs) = (quant.quantize_rows(t.permute(0, 2, 1, 3))
                          for t in (k, v))
    return (kq.permute(0, 2, 1, 3), vq.permute(0, 2, 1, 3),
            ks.transpose(1, 2), vs.transpose(1, 2))


def make_ring_inputs(B, Hq, Hkv, C, S, D, dtype, gen):
    """B3-over-a-ring inputs as the ring layer passes them: q (B, Hq, C, D)
    and K/V (B, Hkv, S_k, D) views, key positions (B, S_k) int32 and row
    offsets.  Row b's ring holds positions up to a random ``last[b]`` in
    [S, 4S) (row 0: S // 3, unwrapped), slot j the latest p ≤ last with
    p % S = j (-1 where none).  C = 1: the query is the newest position,
    written before the step attends; C > 1: the chunk's keys follow the
    ring (S_k = S + C) at positions last + 1 + t, row 1's second half dead
    (-1)."""
    import torch
    last = torch.randint(S, 4 * S, (B,), generator=gen)
    last[0] = S // 3
    j = torch.arange(S)
    pos = last[:, None] - (last[:, None] - j[None, :]) % S
    pos = torch.where(pos >= 0, pos, -1)
    offs = last if C == 1 else last + 1
    if C > 1:
        chunk = offs[:, None] + torch.arange(C)[None, :]
        chunk[1, C // 2:] = -1
        pos = torch.cat([pos, chunk], dim=1)
    Sk = pos.shape[1]
    q = torch.randn((B, C, Hq, D), generator=gen).to(DEVICE, dtype)
    k, v = (torch.randn((B, Sk, Hkv, D), generator=gen).to(DEVICE, dtype)
            for _ in range(2))
    return (q.transpose(1, 2), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            pos.to(DEVICE, torch.int32), offs.to(DEVICE, torch.int32))


def ring_cost(q, k, kpos, offs, window, elt, int8_kv=False):
    """(bytes, flops) of B3 over a ring: q read and o written in ``elt``
    bytes, the key positions read, and the K/V rows some query of the row
    sees read once (``int8_kv``: a byte a code and a bf16 scale a row); 4·D
    flops per visible (query, key) pair of each query head (counted from
    this call's positions)."""
    import torch
    B, Hq, C, D = q.shape
    Hkv = k.shape[1]
    qpos = offs[:, None].long() + torch.arange(C, device=q.device)[None]
    kp = kpos.long()[:, None, :]
    vis = (kp >= 0) & (kp <= qpos[:, :, None]) & (kp > qpos[:, :, None]
                                                  - window)   # (B, C, S_k)
    keys = int(vis.any(dim=1).sum())
    kv_row = D + 2 if int8_kv else D * elt
    bytes_ = (2 * B * Hq * C * D * elt + 2 * keys * Hkv * kv_row
              + 4 * kpos.numel() + 4 * B)
    return bytes_, 4 * D * Hq * int(vis.sum())


def hybrid_blast_shapes(cfg):
    """(name, n, m, b, r, G) of every BLAST launch shape of recurrentgemma-2b:
    the RG-LRU's in_gate+in_x (grouped) and out, the attention's qkv (its
    out has in_x's shape), the GELU FFN's wi and wo."""
    from repro_torch.models.transformer import make_block
    rec, att = make_block(cfg, "rglru"), make_block(cfg, "local_attn")
    out = []
    for name, spec, G in (("in_gate+in_x", rec.mixer.in_x, 2),
                          ("out", rec.mixer.out, 1),
                          ("qkv", att.mixer.qkv, 1),
                          ("wi", rec.ffn.wi, 1), ("wo", rec.ffn.wo, 1)):
        out.append((name, spec.d_in, spec.d_out, spec.meta["b"],
                    spec.meta["r"], G))
    return out


def phase_kernels_hybrid(hyb, errs) -> None:
    """recurrentgemma-2b's kernels against their plain versions on the card:
    B3 over the ring (``flash_attention_ring``: 10/1 heads of 256, B = 8,
    a 2048-slot ring with wrapped rows, window 2048) at C = 1 and 32, and
    over the int8 ring's codes and scales (``flash_attention_ring_q8``,
    against ``attention_ring_q8_ref``), two launches of each bit for bit; B1, B2 and their int8-weight twins B5,
    B6 at its BLAST shapes (r = 608, 656 and 928; wo's n = 7680 in
    panels) at T = 8 and 128, two launches at T = 8 bit for bit; fp32 and
    bf16."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 30)
    hq, hkv, hd, S = hyb.n_heads, hyb.n_kv_heads, hyb.head_dim_, hyb.window

    def check(kname, label, got, want, dname, scaled=False):
        torch.cuda.synchronize()
        e = check_close(f"{kname}[{HYBRID} {label}]",
                        got.reshape(want.shape), want, dname, scaled)
        if dname == "bfloat16":
            errs[kname] = max(errs[kname], e)

    def repeat(kname, label, kern, dname):
        first, second = kern(), kern()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        emit({"phase": "kernels", "case": f"{kname}[{HYBRID} {label}] "
              "repeat", "dtype": dname, "bitwise_identical": same,
              "ok": same})
        if not same:
            raise RuntimeError(f"{kname}[{label} {dname}]: two launches "
                               "differ")

    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for C in RING_CASES:
            q, k, v, kpos, offs = make_ring_inputs(8, hq, hkv, C, S, hd,
                                                   dtype, gen)
            label = f"B=8 Hq={hq} Hkv={hkv} C={C} S_k={k.shape[2]} D={hd}"

            def kern():
                return ops.flash_attention_ring(q, k, v, kpos, offs,
                                                window=S)
            repeat("flash_attention_ring", label, kern, dname)
            check("flash_attention_ring", label, kern(),
                  ref.attention_ring_ref(q, k, v, kpos, offs, window=S),
                  dname, scaled=True)
            args = (q, *ring_q8(k, v), kpos, offs)

            def kern_q8():
                return ops.flash_attention_ring_q8(*args, window=S)
            repeat("flash_attention_ring_q8", label + " int8", kern_q8, dname)
            check("flash_attention_ring_q8", label + " int8", kern_q8(),
                  ref.attention_ring_q8_ref(*args, window=S), dname,
                  scaled=True)
        for name, n, m, b, r, G in hybrid_blast_shapes(hyb):
            _, U, S_, V = make_blast_inputs(n, m, b, r, G, 1, dtype, gen,
                                            DEVICE)
            for T in HYBRID_T:
                x = torch.randn((T, n), generator=gen).to(DEVICE, dtype)
                label = f"{name} {n}->{m} b={b} r={r} G={G} T={T}"
                for kname, kern, plain in blast_calls(x, U, S_, V, r,
                                                      ("int8",)):
                    if T == HYBRID_T[0]:
                        repeat(kname, label, kern, dname)
                    check(kname, label, kern(), plain(), dname)
            del U, S_, V


def attention_repeats(cfg, dtype, dname, gen) -> None:
    """Two launches of each attention kernel on the same inputs agree bit
    for bit: B3 at decode, where the plan splits the keys and the combine
    adds the splits in a fixed order, and B4 at the training shape."""
    import torch
    from repro_torch.kernels import ops
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v, offs = make_attn_inputs(8, hq, hkv, 1, 512, hd, dtype, gen,
                                     DEVICE)
    qf, kf, vf = make_full_attn_inputs(TRAIN_BATCH, hq, hkv, TRAIN_SEQ,
                                       TRAIN_SEQ, hd, dtype, gen, DEVICE)
    for kname, label, run in (
            ("flash_attention_prefill", "B=8 C=1 S=512" + (
                " (split)" if dtype == torch.bfloat16 else ""),
             lambda: ops.flash_attention_prefill(q, k, v, offs)),
            ("flash_attention", f"B={TRAIN_BATCH} T={TRAIN_SEQ}",
             lambda: ops.flash_attention(qf, kf, vf))):
        first, second = run(), run()
        torch.cuda.synchronize()
        same = bool(torch.equal(first, second))
        emit({"phase": "kernels", "case": f"{kname}[{label}] repeat",
              "dtype": dname, "bitwise_identical": same, "ok": same})
        if not same:
            raise RuntimeError(f"{kname}[{label} {dname}]: two launches "
                               "differ")


def check_combine(cfg, gen) -> float:
    """B3's split combine kernel alone against its plain version, on the
    partials of the plain split algorithm at decode (B = 8, C = 1, S = 512,
    the plan's splits; rows at the first slots leave later splits empty);
    bf16 output, bf16 tolerance.  Returns the max error."""
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as fa
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v, offs = make_attn_inputs(8, hq, hkv, 1, 512, hd, torch.float32,
                                     gen, DEVICE)
    offs[:2] = 0
    _, _, splits, kps = fa.split_plan(8, hkv, hq // hkv, 1, 512,
                                      build.sm_count(q.device))
    acc, m, l = ref.attention_split_ref(q, k, v, offs, splits=splits,
                                        keys_per_split=kps)
    got = fa.launch_combine(acc, m, l)
    torch.cuda.synchronize()
    return check_close(f"flash_attention_prefill[combine splits={splits} "
                       f"kps={kps}]", got, ref.attention_combine_ref(
                           acc, m, l).to(torch.bfloat16), "bfloat16")


def repeat_identical(call, linear, T, dname) -> None:
    """Two launches of a BLAST kernel on the same inputs must agree bit for
    bit (split r summed in a fixed order, no atomics)."""
    import torch
    kname, kern, _ = call
    first = kern()
    second = kern()
    torch.cuda.synchronize()
    same = bool(torch.equal(first, second))
    emit({"phase": "kernels", "case": f"{kname}[{linear} T={T}] repeat",
          "dtype": dname, "bitwise_identical": same, "ok": same})
    if not same:
        raise RuntimeError(f"{kname}[{linear} T={T} {dname}]: two launches "
                           "differ")


def qarrays(tree):
    """The QArray leaves of a params tree, in order."""
    from repro_torch import quant
    if quant.is_qarray(tree):
        return [tree]
    items = (tree.values() if isinstance(tree, dict)
             else tree if isinstance(tree, list) else ())
    return [qa for v in items for qa in qarrays(v)]


class SharedActCodes:
    """While active, ``quantize_act`` (the int8-activation prologue of the
    BLAST wrappers) records each call's codes on the card, and the CPU run
    that follows takes the card's codes and scales call by call — after
    checking that its own differ from them only by boundary flips: every
    scale within 1e-5 relative, every code within one step, and at each
    differing code the two scaled inputs within 1e-3 of a step of each
    other (so they straddle a rounding boundary).  A fp32 summation-order
    difference of ~1e-7 upstream flips such a code and moves its row's
    logits by about 1% of their scale; sharing the codes keeps one flip
    from hiding, or being taken for, a fault elsewhere on the path."""

    CODEC = "quantize_act"

    def __init__(self):
        self.card: list = []
        self.recording = True     # True: the card's run; False: the CPU's
        self.calls = self.elements = self.flips = 0

    def __enter__(self):
        from repro_torch.quant import qarray as qt
        self.real = real = getattr(qt, self.CODEC)

        def shared(x, **kw):
            xq, sx = real(x, **kw)
            if self.recording:
                self.card.append((x, xq, sx))
                return xq, sx
            xg, qg, sg = (t.cpu() for t in self.card.pop(0))
            self.check(x, xq, sx, xg, qg, sg, **kw)
            return qg, sg

        setattr(qt, self.CODEC, shared)
        return self

    def __exit__(self, *exc):
        from repro_torch.quant import qarray as qt
        setattr(qt, self.CODEC, self.real)
        if exc[0] is None and self.card:
            raise RuntimeError(f"{len(self.card)} card {self.CODEC} calls "
                               "had no CPU counterpart")

    def check(self, x, xq, sx, xg, qg, sg):
        step = (qg.int() - xq.int()).abs()
        flips = step > 0
        gap = ((xg.float() / sg) - (x.float() / sx)).abs()
        rel = ((sg - sx).abs() / sx).max()
        if (qg.shape != xq.shape or step.max() > 1 or rel > 1e-5
                or (flips.any() and gap[flips].max() > 1e-3)):
            raise RuntimeError(
                f"activation codes differ beyond boundary flips: max code "
                f"step {int(step.max())}, max scale rel diff {float(rel)}, "
                f"max gap at flips "
                f"{float(gap[flips].max()) if flips.any() else 0.0}")
        self.calls += 1
        self.elements += xq.numel()
        self.flips += int(flips.sum())


class SharedRowCodes(SharedActCodes):
    """The same for ``quantize_rows``, the int8 cache's write (K/V rows, and
    an RG-LRU state's conv tail and its ``h`` with fp32 scales).  Each CPU
    call first runs the CPU's codec on the card's own input: codes and
    scales must equal the card's bit for bit (the codec across devices).
    On its own input the CPU's codes must be within one step of the card's
    and its scales equal or at most one bf16 step apart (a scale near a
    bf16 rounding boundary, which moves its row's codes by up to one step);
    the rows whose scale moved are counted.  The CPU then writes the card's
    codes, so the two caches must end equal."""

    CODEC = "quantize_rows"

    def __init__(self):
        super().__init__()
        self.moved_scales = 0

    def check(self, x, xq, sx, xg, qg, sg, **kw):
        import torch
        qs, ss = self.real(xg, **kw)
        if not (torch.equal(qs, qg) and torch.equal(ss, sg)):
            raise RuntimeError("quantize_rows on the CPU gives other codes "
                               "or scales than on the card for the same "
                               "input")
        step = (qg.int() - xq.int()).abs()
        rel = ((sg.float() - sx.float()).abs() / sx.float()).max()
        if qg.shape != xq.shape or step.max() > 1 or rel > 2.0 ** -7:
            raise RuntimeError(f"cache codes differ beyond boundary flips: "
                               f"max code step {int(step.max())}, max scale "
                               f"rel diff {float(rel)}")
        self.calls += 1
        self.elements += xq.numel()
        self.flips += int((step > 0).sum())
        self.moved_scales += int((sg != sx).sum())


def _reference_rows(gpu, cpu, params_gpu, params_cpu, act, shared=()):
    """Logit row errors and limits, card vs CPU, over three ragged chunks;
    and the two caches.  ``shared``: codecs whose card codes the CPU takes
    (``SharedActCodes``, ``SharedRowCodes``)."""
    import contextlib
    import torch
    from repro_torch.core import structures
    cache_g, cache_c = gpu.init_cache(3, 64), cpu.init_cache(3, 64)
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = torch.tensor([0, 0, 0])
    row_err, row_limit = [], []
    for n_tok in ([16, 5, 0], [7, 16, 3], [1, 1, 16]):
        n_tok = torch.tensor(n_tok)
        toks = torch.randint(0, gpu.cfg.vocab, (3, 16), generator=rng)
        with structures.activations(act), contextlib.ExitStack() as stack:
            for codec in shared:
                stack.enter_context(codec)
                codec.recording = True
            lg, cache_g = gpu.prefill_chunk(params_gpu, cache_g, toks, steps,
                                            n_tok)
            for codec in shared:
                codec.recording = False
            lc, cache_c = cpu.prefill_chunk(params_cpu, cache_c, toks, steps,
                                            n_tok)
        live = n_tok > 0
        got, want = lg.float().cpu()[live], lc[live]
        if not torch.isfinite(got).all():
            raise RuntimeError("reference: non-finite logits on the card")
        scale = float(want.abs().max())
        row_err += (got - want).abs().amax(dim=(1, 2)).tolist()
        row_limit += [1e-3 + 1e-3 * scale] * int(live.sum())
        steps = steps + n_tok
    return torch.tensor(row_err), torch.tensor(row_limit), (cache_g, cache_c)


def phase_reference(cfg, mode, weights="none", act="none", cache="none",
                    base=None, layers=2):
    """Full-width fp32 model, 2 layers: card (kernels) vs CPU (plain), in
    one serving mode (``mode`` labels it); the codes (int4: packed bytes)
    and scales must be equal on both.  Logits: every live row within 1e-3
    abs + 1e-3·max|logit|.  With int8 activations the two devices feed each
    per-token activation quantizer the same values only up to summation
    order, and a value that close to a rounding boundary moves its code by
    one step (about 1% of the logit scale); so the gated run shares the
    card's activation codes with the CPU after checking that the two
    differ only by such flips (``SharedActCodes``).  The free-running
    comparison is reported beside it.  With the int8 cache the K/V rows are
    shared the same way (``SharedRowCodes``), and every cache leaf — pos,
    codes, scales — must end equal on both.  A wrong scale or layout moves
    every row by O(1).  ``base``: the CPU float params of the model at
    ``layers`` layers (default its ``init(SEED)``), moved to the card for
    the card's run."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    qcfg = quant.QuantConfig(weights=weights, activations=act)
    small = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                                compute_dtype="float32",
                                quant=quant.QuantConfig(cache=cache))
    gpu = build_model(small, device=DEVICE)
    cpu = build_model(small, device="cpu")
    base = cpu.init(SEED) if base is None else base
    params_cpu = cpu.quantize_params(base, qcfg)
    params_gpu = gpu.quantize_params(
        tree_map(lambda t: t.to(DEVICE), base), qcfg)
    pairs = list(zip(qarrays(params_gpu), qarrays(params_cpu)))
    if any(not (torch.equal(a.q.cpu(), b_.q)
                and torch.equal(a.scale.cpu(), b_.scale)) for a, b_ in pairs):
        raise RuntimeError(f"reference[{mode}]: codes or scales differ "
                           "between the card and the CPU")
    extra = {}
    shared = []
    if act == "int8" or cache == "int8":
        free_err, free_lim, _ = _reference_rows(gpu, cpu, params_gpu,
                                                params_cpu, act)
        extra = {"free_running_max_abs_logit_err": float(free_err.max()),
                 "free_running_rows_past_limit":
                     int((free_err > free_lim).sum())}
        shared = ([SharedActCodes()] if act == "int8" else []) + (
            [SharedRowCodes()] if cache == "int8" else [])
    err, lim, (cache_g, cache_c) = _reference_rows(
        gpu, cpu, params_gpu, params_cpu, act, shared)
    past = int((err > lim).sum())
    for codec in shared:
        extra[codec.CODEC] = {"calls": codec.calls, "codes": codec.elements,
                              "code_flips": codec.flips,
                              **({"moved_scales": codec.moved_scales}
                                 if hasattr(codec, "moved_scales") else {})}
    leaves_equal = []
    if cache == "int8":
        leaves_equal = [n for c_g, c_c in zip(cache_g, cache_c)
                        for n, leaf in c_g.items()
                        if not torch.equal(leaf.cpu(), c_c[n])]
        extra["cache_leaves_equal"] = not leaves_equal
    emit({"phase": "reference", "mode": mode, "arch": cfg.name,
          "layers": layers,
          "d_model": small.d_model, "vocab": small.vocab, "dtype": "float32",
          "weights": weights, "activations": act, "cache": cache,
          "chunks": 3, "qarrays_equal": len(pairs),
          "max_abs_logit_err": float(err.max()),
          "rows": len(err), "rows_past_limit": past,
          "limit": "1e-3 + 1e-3*max|logit| per row", **extra})
    if past:
        raise RuntimeError(f"reference[{mode}]: card logits differ from the "
                           f"CPU plain path: row errors {err.tolist()}, "
                           f"limits {lim.tolist()}")
    if cache == "int8" and leaves_equal:
        raise RuntimeError(f"reference[{mode}]: int8 cache leaves differ "
                           f"between the card and the CPU: {leaves_equal}")


def phase_reference_dense(llama, gpt2):
    """``phase_reference`` at llama7b-blast's full width (d_model 4096,
    vocab 32000, the untied head, Table 9's per-role ranks) in three modes
    from one init — float; float weights with the int8 cache; int8
    weights with the int8 cache — and gpt2-blast's (LayerNorm, learned
    positions, GELU, b = 6), float."""
    from repro_torch.models import build_model
    base = build_model(dataclasses.replace(
        llama, n_layers=LLAMA_FP32_LAYERS, param_dtype="float32",
        compute_dtype="float32"), device="cpu").init(SEED)
    for mode, (weights, cache) in LLAMA_MODES.items():
        phase_reference(llama, f"llama:{mode}", weights=weights, cache=cache,
                        base=base, layers=LLAMA_FP32_LAYERS)
    del base
    phase_reference(gpt2, "gpt2:float")


REFERENCE_PROMPTS = (200, 120, 40)   # the state models' reference prompts


def _prompt_rows(gpu, cpu, params_gpu, params_cpu, seed, act="none",
                 shared=()):
    """Card (kernels) against CPU (plain versions) over prompts of
    ``REFERENCE_PROMPTS`` tokens fed in ragged chunks of 32, then 4 decode
    steps, on fresh caches (max_len 256): every live logit row's error and
    its limit 1e-3 + 1e-3·max|logit|.  ``shared``: codecs whose card codes
    the CPU takes (``SharedActCodes``, ``SharedRowCodes``).  Returns
    (errors, limits, chunks, positions fed, (card cache, CPU cache))."""
    import contextlib
    import torch
    from repro_torch.core import structures
    B = len(REFERENCE_PROMPTS)
    cache_g, cache_c = gpu.init_cache(B, 256), cpu.init_cache(B, 256)
    rng = torch.Generator().manual_seed(seed)
    lens = torch.tensor(REFERENCE_PROMPTS)
    prompts = torch.randint(0, gpu.cfg.vocab, (B, int(lens.max())),
                            generator=rng)
    fed = torch.zeros(B, dtype=torch.int64)
    row_err, row_limit = [], []

    def step(toks, n_tok):
        """One ragged step on both devices; the live rows' errors."""
        with structures.activations(act), contextlib.ExitStack() as stack:
            for codec in shared:
                stack.enter_context(codec)
                codec.recording = True
            lg, _ = gpu.prefill_chunk(params_gpu, cache_g, toks, fed, n_tok)
            for codec in shared:
                codec.recording = False
            lc, _ = cpu.prefill_chunk(params_cpu, cache_c, toks, fed, n_tok)
        live = n_tok > 0
        got, want = lg.float().cpu()[live], lc[live]
        if not torch.isfinite(got).all():
            raise RuntimeError("reference: non-finite logits on the card")
        row_err.extend((got - want).abs().amax(dim=(1, 2)).tolist())
        row_limit.extend([1e-3 + 1e-3 * float(want.abs().max())]
                         * int(live.sum()))

    chunks = 0
    while bool((fed < lens).any()):
        n_tok = torch.clamp(lens - fed, 0, 32)
        toks = torch.zeros((B, 32), dtype=torch.int64)
        for b in range(B):
            toks[b, :n_tok[b]] = prompts[b, fed[b]:fed[b] + n_tok[b]]
        step(toks, n_tok)
        fed, chunks = fed + n_tok, chunks + 1
    for _ in range(4):
        step(torch.randint(0, gpu.cfg.vocab, (B, 1), generator=rng),
             torch.ones(B, dtype=torch.int64))
        fed = fed + 1
    return (torch.tensor(row_err), torch.tensor(row_limit), chunks, fed,
            (cache_g, cache_c))


def _leaf_report(cache_g, cache_c) -> dict:
    """Every cache leaf, card against CPU: ``pos`` equal, any other within
    1e-3 + 1e-3·max|leaf| (int8 codes shared by ``SharedRowCodes`` end
    equal)."""
    import torch
    leaves = {}
    for i, (c_g, c_c) in enumerate(zip(cache_g, cache_c)):
        for name, leaf in c_g.items():
            got, want = leaf.cpu(), c_c[name]
            if name == "pos":
                ok, e = bool(torch.equal(got, want)), 0.0
            else:
                e = float((got.float() - want.float()).abs().max())
                ok = e <= 1e-3 + 1e-3 * float(want.abs().max())
            leaves[f"{i}.{name}"] = {"max_abs_err": e, "ok": ok}
    return leaves


def _codec_report(codec) -> dict:
    out = {"calls": codec.calls, "elements": codec.elements,
           "flipped_codes": codec.flips}
    if hasattr(codec, "moved_scales"):
        out["moved_scales"] = codec.moved_scales
    return out


def phase_reference_hybrid(hyb, cache="none"):
    """recurrentgemma-2b at full width (d_model 2560, vocab 256000, 10/1
    heads of 256, the tied head scaled by √d_model and softcapped), fp32,
    cut to 3 layers (rglru, rglru, local_attn) and a window of 64, so that
    prompts of 200, 120 and 40 tokens wrap the ring: card (kernels) vs CPU
    (plain), the prompts fed in ragged chunks of 32, then 4 decode steps
    (``_prompt_rows``).  Every live logit row within 1e-3 abs +
    1e-3·max|logit|; every cache leaf after the last step: ``pos`` equal,
    K/V, ``conv`` and ``h`` within 1e-3 + 1e-3·max|leaf|.
    ``cache="int8"``: the int8 cache (an int8 ring, int8 RG-LRU state),
    the CPU given the card's codes (``SharedRowCodes``, ROADMAP C6), so
    its leaves must end equal."""
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    small = dataclasses.replace(hyb, n_layers=3, window=64,
                                param_dtype="float32",
                                compute_dtype="float32",
                                quant=quant.QuantConfig(cache=cache))
    gpu = build_model(small, device=DEVICE)
    cpu = build_model(small, device="cpu")
    params_cpu = cpu.init(SEED)
    params_gpu = tree_map(lambda t: t.to(DEVICE), params_cpu)
    shared = [SharedRowCodes()] if cache == "int8" else []
    err, lim, chunks, fed, caches = _prompt_rows(
        gpu, cpu, params_gpu, params_cpu, SEED + 3, shared=shared)
    leaves = _leaf_report(*caches)
    past = int((err > lim).sum())
    bad = [k for k, v in leaves.items() if not v["ok"]]
    emit({"phase": "reference", "arch": hyb.name,
          "mode": "hybrid:float" if cache == "none" else "hybrid:int8_cache",
          "layers": 3, "pattern": small.layer_kinds(), "window": 64,
          "d_model": small.d_model, "vocab": small.vocab, "dtype": "float32",
          "prompt_tokens": list(REFERENCE_PROMPTS), "chunks": chunks,
          "decode_steps": 4, "positions_past_window": int(fed.max()) - 64,
          "max_abs_logit_err": float(err.max()), "rows": len(err),
          "rows_past_limit": past, "cache_leaves": leaves,
          **({"shared_row_codes": _codec_report(shared[0])} if shared
             else {}),
          "limit": "1e-3 + 1e-3*max|logit| per row"})
    if past or bad:
        raise RuntimeError(f"reference[{HYBRID}]: card differs from the CPU "
                           f"plain path: row errors {err.tolist()}, limits "
                           f"{lim.tolist()}, cache leaves past the limit "
                           f"{bad}")


def serve_config(mode, weights=None, max_len=512, **kw):
    """The serving runs' engine: 8 slots, chunk 32, ``max_len`` (512),
    weights (and activations) of a smollm-135m ``mode``, or ``weights``."""
    from repro_torch import quant
    from repro_torch.serve import EngineConfig, MemoryConfig, SchedulerConfig
    (w, act), _ = MODES[mode] if weights is None else ((weights, "none"),
                                                       None)
    return EngineConfig(scheduler=SchedulerConfig(slots=8, chunk_size=32),
                        memory=MemoryConfig(max_len=max_len),
                        quant=quant.QuantConfig(weights=w, activations=act),
                        **kw)


def smollm_per_step(cfg, mode) -> dict:
    """Launches a serving step of smollm-135m makes in ``mode``."""
    blast, grouped = MODES[mode][1]
    L = cfg.n_layers
    return {blast: 3 * L, grouped: L, "flash_attention_prefill": L}


def llama_per_step(cfg, mode) -> dict:
    """Launches a serving step of llama7b-blast makes in ``mode``: 96 BLAST
    (qkv, out, down), 32 grouped (gate+up), 32 attention at 32 layers, in
    the mode's own kernels."""
    weights, cache = LLAMA_MODES[mode]
    blast, grouped = MODES["int8" if weights == "int8" else "none"][1]
    attn = ("flash_attention_prefill_q8" if cache == "int8"
            else "flash_attention_prefill")
    L = cfg.n_layers
    return {blast: 3 * L, grouped: L, attn: L}


def _serve_run(engine, prompts, max_new, temperature=0.0):
    """Serve ``prompts`` → (requests, wall s, launch counts, peak bytes)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import SamplingParams
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = engine.generate_batch(prompts, SamplingParams(
        max_new_tokens=max_new, temperature=temperature))
    torch.cuda.synchronize()
    return (reqs, time.perf_counter() - t0, dict(ops.launches),
            torch.cuda.max_memory_allocated())


def serve_prompts(vocab, n=16):
    """``n`` seeded prompts of 16-200 tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [[int(t) for t in rng.integers(0, vocab, size=int(L))]
            for L in rng.integers(16, 201, size=n)]


def phase_serve(model, params, mode, config, per_step, prompts=None,
                max_new=32, **extra):
    """One full-width serving run of ``model`` in ``mode`` through the
    captured engine (CUDA graphs, the default) and one through an eager
    engine (``step_fn``, which observes every step): identical greedy
    tokens, and each run's launch counts steps × ``per_step`` (every other
    kernel 0).  ``prompts``: default ``serve_prompts``; ``max_new`` new
    tokens each.  Returns (the captured run's launch counts, its row, its
    outputs)."""
    import torch
    from repro_torch import quant
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import Engine
    cfg = model.cfg
    finite = []
    splits = []     # each step's B3 key splits: at its kv bucket, and at
    #                 its largest live slot + 1 (what the layer passed before)
    sms = build.sm_count(torch.device(DEVICE))
    G = cfg.n_heads // cfg.n_kv_heads

    def step(params, cache, tokens, steps, n_tokens, kv_len):
        B, C = tokens.shape
        if not model.slot_resident and cfg.mla is None:   # B3's plan
            live = int((steps + n_tokens)[n_tokens > 0].max())    # syncs
            splits.append([fa.split_plan(B, cfg.n_kv_heads, G, C, kv,
                                         sms)[2] for kv in (kv_len, live)])
        logits, cache = model.prefill_chunk(params, cache, tokens, steps,
                                            n_tokens, kv_len=kv_len)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    prompts = serve_prompts(cfg.vocab) if prompts is None else prompts
    runs = {}
    for path in ("graphs", "eager"):
        t0 = time.perf_counter()
        engine = Engine(model, params, config, device=DEVICE,
                        step_fn=step if path == "eager" else None)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        reqs, wall, launches, peak = _serve_run(engine, prompts, max_new)
        steps = engine.stats["steps"]
        want = {k: 0 for k in launches}
        want.update({k: n * steps for k, n in per_step.items()})
        if launches != want:
            raise RuntimeError(f"{mode} ({path}): launch counts {launches} "
                               f"!= {want} ({steps} steps × {per_step})")
        bad = [r.uid for r in reqs if not r.done or len(r.output) != max_new
               or r.stop_reason != "length"]
        if bad:
            raise RuntimeError(f"{mode} ({path}): requests did not finish "
                               f"with {max_new} tokens: {bad}")
        tp = engine.throughput()
        runs[path] = {
            "outputs": [r.output for r in reqs], "launches": launches,
            "row": {"steps": steps, "graphs": engine.stats["graphs"],
                    "capture_s": engine.stats["capture_s"],
                    "decode_only_steps": len(engine.stats["decode_step_s"]),
                    "wall_s": wall, "load_s": load_s,
                    "max_memory_allocated_bytes": peak,
                    "prefill_tok_s": tp["prefill_tok_s"],
                    "decode_tok_s": tp["decode_tok_s"],
                    "decode_step_ms_median": 1e3 * statistics.median(
                        engine.stats["decode_step_s"]),
                    "step_ms_median": 1e3 * statistics.median(
                        engine.stats["step_s"])}}
        param_bytes = quant.tree_nbytes(engine.params)
        cache_bytes = quant.tree_nbytes(engine.cache)
        del engine
    if runs["graphs"]["outputs"] != runs["eager"]["outputs"]:
        raise RuntimeError(f"{mode}: the captured engine's greedy tokens "
                           "differ from the eager engine's")
    if not bool(torch.stack(finite).all()):
        raise RuntimeError(f"{mode}: non-finite logits in the serving run")
    if runs["graphs"]["row"]["graphs"] == 0:
        raise RuntimeError(f"{mode}: the default engine captured no graph")
    row = {"phase": "serve", "mode": mode, "arch": cfg.name,
           "layers": cfg.n_layers, "vocab": cfg.vocab,
           "dtype": cfg.param_dtype, "weights": config.quant.weights,
           "activations": config.quant.activations,
           "cache": cfg.quant.cache, "slots": config.scheduler.slots,
           "chunk": config.scheduler.chunk_size,
           "max_len": config.memory.max_len, "requests": len(prompts),
           "prompt_tokens": sum(map(len, prompts)),
           "new_tokens": len(prompts) * max_new,
           # engine params (quantized, the pre-stacked bundle included)
           "param_bytes": param_bytes, "cache_bytes": cache_bytes, **extra,
           "graphs": runs["graphs"]["row"], "eager": runs["eager"]["row"],
           "greedy_tokens_identical": True,
           "launches": {k: v for k, v in runs["graphs"]["launches"].items()
                        if v},
           "per_step": per_step}
    if splits:
        bucket, live = zip(*splits)
        row.update({
            "attn_split_steps": sum(k > 1 for k in bucket),
            "attn_splits_max": max(bucket),
            # what the kv bucket costs against the live key range: B3 key
            # splits summed over steps (× the layers a step) and the steps
            # whose launches add a combine
            "attn_splits_sum": {"bucket": sum(bucket), "live": sum(live)},
            "attn_combine_steps": {"bucket": sum(k > 1 for k in bucket),
                                   "live": sum(k > 1 for k in live)}})
    emit(row)
    return runs["graphs"]["launches"], row, runs["graphs"]["outputs"]


def phase_temperature(model, params):
    """Temperature sampling through the captured engine: 8 prompts, 16 new
    tokens each at T = 0.8, twice with the engine's seed and once with
    another: the same seed gives the same tokens, the other does not."""
    import torch
    from repro_torch.serve import Engine
    prompts = serve_prompts(model.cfg.vocab, n=8)
    outs = []
    for seed in (SEED, SEED, SEED + 1):
        engine = Engine(model, params, serve_config(
            None, weights="none", seed=seed), device=DEVICE)
        reqs, wall, _, _ = _serve_run(engine, prompts, 16, temperature=0.8)
        outs.append([r.output for r in reqs])
        del engine
    same, other = outs[0] == outs[1], outs[0] != outs[2]
    emit({"phase": "temperature", "arch": model.cfg.name, "temperature": 0.8,
          "requests": len(prompts), "new_tokens": 16,
          "same_seed_identical": same, "other_seed_differs": other,
          "ok": same and other})
    if not (same and other):
        raise RuntimeError("temperature sampling: the seed does not set the "
                           "stream")
    torch.cuda.synchronize()



# -- the paged cache --------------------------------------------------------------

PAGE_SIZE = 16
# tokens are compared up to each request's first output whose top-1/top-2
# logit margin in the reference run marks a near-tie (``near_tie``)
MARGIN = 1e-4           # tests/test_torch_engine.py, fp32
PREEMPT_PAGES = 56      # 55 usable pages (880 tokens) for 1158 tokens of work


def near_tie(top: float, margin: float, dtype) -> bool:
    """The margin rule of ``tests/test_torch_engine.py`` (a top-1/top-2
    margin below ``MARGIN``), in the logits' own precision: a margin below
    two steps of the logits' type at the top logit is a near-tie too.  Two
    bf16 logits one step apart may have been equal before rounding, and a
    recompute in other batch shapes (other kernel splits, so other
    rounding of the cache) moves a bf16 logit by about a step; for fp32
    logits the two-step floor is ~1e-6 and ``MARGIN`` rules."""
    import torch
    step = torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(
        max(abs(top), torch.finfo(dtype).tiny)))
    return margin < max(MARGIN, 2 * step)


def paged_config(config, pages=None):
    """``config`` with a paged cache of ``PAGE_SIZE``-token pages (default
    pool: B·max_len/PAGE_SIZE + 1 pages, slot-static parity)."""
    mem = dataclasses.replace(config.memory, paged=True, page_size=PAGE_SIZE,
                              pages=pages)
    return dataclasses.replace(config, memory=mem)


def _with_margins(engine) -> dict:
    """Record, for every token ``engine`` emits, whether the logits it came
    from make it a near-tie (``near_tie``), and its margin:
    {uid: [(near_tie, margin), ...]}.  The wrappers hold the engine in a
    reference cycle: delete them (``del engine._run_step, engine._emit``)
    before the engine, or its memory outlives it."""
    import torch
    last, margins = {}, {}
    run_step, emit_tok = engine._run_step, engine._emit

    def run(key):
        last["logits"] = run_step(key)
        return last["logits"]

    def emit_(req, tok):
        b = next(i for i, s in enumerate(engine.slots) if s.req is req)
        row = last["logits"][b, 0]
        top2 = torch.topk(row.float(), 2).values.tolist()
        margin = top2[0] - top2[1]
        margins.setdefault(req.uid, []).append(
            (near_tie(top2[0], margin, row.dtype), margin))
        emit_tok(req, tok)

    engine._run_step, engine._emit = run, emit_
    return margins


def _margin_compare(got: dict, want: dict, margins: dict, what: str,
                    gate: bool = True) -> dict:
    """{uid: tokens} of a run against the reference run's, up to each
    request's first output that is a near-tie in the reference run; raises
    on a difference.  Returns what was compared.  ``gate=False`` raises
    nothing and reports instead, for each request that differs before its
    first near-tie, the first differing output and its reference margin
    (a MoE model in bf16, ``MOE_BF16_ROUTING``)."""
    compared, identical, before_tie = 0, 0, {}
    for uid, w in want.items():
        ties = [i for i, (tie, _) in enumerate(margins[uid]) if tie]
        n = ties[0] if ties else len(w)
        if got[uid][:n] != w[:n]:
            first = next(i for i in range(n) if got[uid][i] != w[i])
            if gate:
                raise RuntimeError(
                    f"{what}: request {uid} differs from the reference run "
                    f"at output {first} (reference margin "
                    f"{margins[uid][first][1]:.3g}, compared {n} of "
                    f"{len(w)})")
            before_tie[uid] = {"output": first,
                               "reference_margin": margins[uid][first][1]}
            n = first
        compared += n
        identical += got[uid] == w
    out = {"tokens_compared": compared,
           "tokens_total": sum(len(w) for w in want.values()),
           "requests_identical_in_full": identical}
    if not gate:
        out["gated"] = False
        out["differs_before_first_near_tie"] = before_tie
    return out


def paged_step_ms(model, params, config, prompt_len) -> dict:
    """Device ms of one decode step's gather (fresh-page reset and the page
    copy into the view) and scatter (the write-window pages back to the
    pool), each timed alone with CUDA events (``time_ms``: median of 25, L2
    flushed) on the operands of a steady decode step: 8 slots after
    ``prompt_len``-token prompts, 10 decode steps in.  A throwaway engine:
    re-running the reset clobbers that step's fresh pages."""
    import torch
    from repro_torch.serve import Engine, Request
    engine = Engine(model, params, config, device=DEVICE)
    for i in range(8):
        engine.submit(Request(uid=i, prompt=list(range(1, prompt_len + 1)),
                              max_new_tokens=64))
    keys = []
    run_step = engine._run_step
    engine._run_step = lambda key: (keys.append(key), run_step(key))[1]
    engine.run(max_iters=-(-prompt_len // 32) + 10)
    C, kv, F, M = keys[-1]
    pc, d, o = engine._pc, engine._inputs, engine._offs
    g = pc.gather_pages(kv)
    table = d[o["table"]:o["table"] + engine.B * g]
    fresh = d[o["fresh"]:o["fresh"] + F]
    rows, lps, phys = (d[o[k]:o[k] + M] for k in ("rows", "lps", "phys"))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    out = {"prompt_len": prompt_len, "key": [C, kv, F, M],
           "gather_pages_per_row": g,
           "gather_ms": time_ms(lambda: pc.gather(table, fresh), flush),
           "scatter_ms": time_ms(lambda: pc.scatter(rows, lps, phys), flush)}
    elt = sum(t[0].numel() * t.element_size() for t in pc.pool.values())
    # bytes each must move: a gathered page read and written once, a fresh
    # page written once; a scattered page read from the view and written
    # to the pool once
    out["gather_bytes"] = (2 * engine.B * g + F) * elt
    out["scatter_bytes"] = 2 * M * elt
    out["gather_bound_ms"] = out["gather_bytes"] / HBM_BYTES_PER_S * 1e3
    out["scatter_bound_ms"] = out["scatter_bytes"] / HBM_BYTES_PER_S * 1e3
    del engine._run_step, engine    # the wrapper's cycle holds the engine
    torch.cuda.synchronize()
    return out


def phase_paged(model, params, mode, config, per_step, static,
                prompts=None, max_new=32):
    """Run 1 of the paged cache: the serve phase's 16 prompts and 32 new
    tokens through a paged engine with the default pool, captured and
    eager (``step_fn``): greedy tokens equal the same mode's slot-static
    run (``static``: its row and outputs) bit for bit and each other,
    launches steps × ``per_step``, ``audit`` (refcounts, free list, the
    zero page still the template) after each run; decode step ms and tok/s
    against slot-static, graphs and capture seconds, pool and view bytes,
    peak memory, and the gather and scatter device ms of a decode step.
    ``prompts``, ``max_new``: the slot-static run's (default
    ``serve_prompts``, 32).  Returns the captured run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.serve import Engine
    cfg = model.cfg
    s_row, s_out = static
    prompts = serve_prompts(cfg.vocab) if prompts is None else prompts
    runs = {}
    for path in ("graphs", "eager"):
        engine = Engine(model, params, paged_config(config), device=DEVICE,
                        step_fn=None if path == "graphs" else
                        model.prefill_chunk)
        reqs, wall, launches, peak = _serve_run(engine, prompts, max_new)
        steps = engine.stats["steps"]
        want = {k: 0 for k in launches}
        want.update({k: n * steps for k, n in per_step.items()})
        if launches != want:
            raise RuntimeError(f"paged {mode} ({path}): launch counts "
                               f"{launches} != {want}")
        if any(not r.done or len(r.output) != max_new for r in reqs):
            raise RuntimeError(f"paged {mode} ({path}): a request did not "
                               f"finish with {max_new} tokens")
        engine._pc.audit()
        tp = engine.throughput()
        runs[path] = {"outputs": [r.output for r in reqs],
                      "launches": launches,
                      "row": {"steps": steps, "graphs": engine.stats["graphs"],
                              "capture_s": engine.stats["capture_s"],
                              "wall_s": wall,
                              "max_memory_allocated_bytes": peak,
                              "prefill_tok_s": tp["prefill_tok_s"],
                              "decode_tok_s": tp["decode_tok_s"],
                              "decode_step_ms_median": 1e3 * statistics.median(
                                  engine.stats["decode_step_s"]),
                              "step_ms_median": 1e3 * statistics.median(
                                  engine.stats["step_s"])}}
        pc = engine._pc
        pool = {"cache_bytes": pc.nbytes(),
                "view_bytes": quant.tree_nbytes(pc.view),
                "pool_tokens": pc.pool_tokens(), "pages": pc.n_pages,
                "page_size": pc.ps, "paged_leaves": pc.has_paged}
        del engine, pc
    if runs["graphs"]["outputs"] != s_out:
        raise RuntimeError(f"paged {mode}: the paged engine's greedy tokens "
                           "differ from the slot-static engine's")
    if runs["eager"]["outputs"] != runs["graphs"]["outputs"]:
        raise RuntimeError(f"paged {mode}: the captured paged engine's "
                           "tokens differ from the eager paged engine's")
    if runs["graphs"]["row"]["graphs"] == 0:
        raise RuntimeError(f"paged {mode}: the default engine captured no "
                           "graph")
    g = runs["graphs"]["row"]
    row = {"phase": "paged", "run": "paged = slot-static", "mode": mode,
           "arch": cfg.name, "layers": cfg.n_layers,
           "weights": config.quant.weights, "cache": cfg.quant.cache,
           "slots": 8, "chunk": 32, "max_len": 512, "requests": len(prompts),
           "new_tokens": len(prompts) * max_new, **pool,
           "graphs": g, "eager": runs["eager"]["row"],
           "slot_static": {k: s_row["graphs"][k] for k in (
               "steps", "graphs", "capture_s", "decode_tok_s",
               "decode_step_ms_median", "step_ms_median",
               "max_memory_allocated_bytes")},
           "slot_static_cache_bytes": s_row["cache_bytes"],
           "decode_step_ms_paged_minus_static": (
               g["decode_step_ms_median"]
               - s_row["graphs"]["decode_step_ms_median"]),
           "tokens_identical_to_slot_static": True,
           "captured_equals_eager": True,
           "launches": {k: v for k, v in runs["graphs"]["launches"].items()
                        if v},
           "per_step": per_step,
           # the serve run decodes at kv 256 (live positions up to 232);
           # a nominal pool (every leaf a state leaf) gathers nothing
           "decode_step": [paged_step_ms(model, params, paged_config(config),
                                         n) for n in (16, 200)]
           if pool["paged_leaves"] else None,
           "nvidia_smi": nvidia_smi()}
    emit(row)
    torch.cuda.synchronize()
    return runs["graphs"]["launches"]


def phase_paged_prefix(model, params, mode, config, prefix_len=None):
    """Run 2: 16 requests sharing a 256-token system prompt plus 4 distinct
    tokens each, 32 new tokens, through a paged engine whose pool holds half
    of B·max_len tokens: the first request alone to completion (registering
    the prefix levels), then the other 15: ``prefix_hit_tokens`` ≥ 15·256,
    ``audit`` after, and the tokens equal an unshared slot-static engine's
    under the margin rule.  ``prefix_len``: every request's
    ``Request.prefix_len`` hint (a model with state registers its snapshot
    there).  Returns the shared run's tokens {uid: tokens}."""
    import numpy as np
    import torch
    from repro_torch.serve import Engine, Request, SamplingParams
    rng = np.random.default_rng(SEED + 2)
    vocab = model.cfg.vocab
    system = [int(t) for t in rng.integers(0, vocab, size=256)]
    prompts = [system + [int(t) for t in rng.integers(0, vocab, size=4)]
               for _ in range(16)]
    ref = Engine(model, params, config, device=DEVICE)
    margins = _with_margins(ref)
    ref_reqs = ref.generate_batch(prompts, SamplingParams(max_new_tokens=32))
    want = {i: r.output for i, r in enumerate(ref_reqs)}
    margins = {i: margins[r.uid] for i, r in enumerate(ref_reqs)}
    del ref._run_step, ref._emit, ref     # the wrappers' cycles
    pages = 8 * 512 // PAGE_SIZE // 2 + 1
    engine = Engine(model, params, paged_config(config, pages=pages),
                    device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=32,
                          prefix_len=prefix_len))
    engine.run()
    for i in range(1, 16):
        engine.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32,
                              prefix_len=prefix_len))
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine._pc.audit()
    got = {r.uid: r.output for r in engine.finished}
    sla = engine.sla_report()
    if sla["prefix_hit_tokens"] < 15 * 256:
        raise RuntimeError(f"paged prefix {mode}: {sla['prefix_hit_tokens']} "
                           f"prefix-hit tokens < {15 * 256}")
    if engine._pc.pool_tokens() > 8 * 512 // 2:
        raise RuntimeError("paged prefix: the pool is not under half")
    cmp = _margin_compare(got, want, margins, f"paged prefix {mode}")
    emit({"phase": "paged", "run": "prefix sharing", "mode": mode,
          "arch": model.cfg.name, "layers": model.cfg.n_layers,
          "max_len": config.memory.max_len,
          "state_leaves": engine._pc.has_state,
          "snap_slots": engine._pc.n_snap, "prefix_len": prefix_len,
          "requests": 16, "system_prompt": 256,
          "new_tokens": 16 * 32, "pages": pages,
          "pool_tokens": engine._pc.pool_tokens(),
          "cache_bytes": engine._pc.nbytes(),
          "prefix_hit_tokens": sla["prefix_hit_tokens"],
          "prefix_hit_rate": sla["prefix_hit_rate"],
          "steps": engine.stats["steps"], "graphs": engine.stats["graphs"],
          "capture_s": engine.stats["capture_s"], "wall_s": wall,
          "decode_tok_s": engine.throughput()["decode_tok_s"],
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          **cmp})
    del engine
    return got


def phase_paged_preempt(model, params, mode, config, gate_tokens=True):
    """Run 3: 6 bulk requests at priority 1 (the serve phase's first 6
    prompts, 32 new tokens), then 4 at priority 0 arriving after 8 ticks,
    on a pool of ``PREEMPT_PAGES`` pages, too small for all of them: twice
    (identical tokens and preemption counts), preemptions > 0, every
    request finishing by length; the tokens equal a roomy-pool run's under
    the margin rule (``gate_tokens=False``: reported, not gated).  Returns
    the preempted run's tokens {uid: tokens}."""
    import torch
    from repro_torch.serve import Engine, Request
    prompts = serve_prompts(model.cfg.vocab, n=10)

    def run(pages, margins=False):
        engine = Engine(model, params, paged_config(config, pages=pages),
                        device=DEVICE)
        marg = _with_margins(engine) if margins else None
        for i in range(6):
            engine.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32,
                                  priority=1))
        for _ in range(8):
            engine.tick()
        for i in range(6, 10):
            engine.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=32,
                                  priority=0))
        engine.run()
        torch.cuda.synchronize()
        engine._pc.audit()
        done = {r.uid: r for r in engine.finished}
        if sorted(done) != list(range(10)) or any(
                r.stop_reason != "length" or len(r.output) != 32
                for r in done.values()):
            raise RuntimeError(f"paged preempt {mode}: not every request "
                               f"finished by length ({pages} pages)")
        out = {"outputs": {u: r.output for u, r in done.items()},
               "preemptions": engine.stats["preemptions"],
               "preempted": {u: r.n_preempted for u, r in done.items()
                             if r.n_preempted},
               "steps": engine.stats["steps"],
               "graphs": engine.stats["graphs"],
               "sla": engine.sla_report(), "margins": marg}
        if margins:
            del engine._run_step, engine._emit    # the wrappers' cycles
        del engine
        return out

    a, b = run(PREEMPT_PAGES), run(PREEMPT_PAGES)
    roomy = run(None, margins=True)
    if a["outputs"] != b["outputs"] or a["preemptions"] != b["preemptions"]:
        raise RuntimeError(f"paged preempt {mode}: two runs differ")
    if a["preemptions"] == 0 or roomy["preemptions"] != 0:
        raise RuntimeError(f"paged preempt {mode}: preemptions "
                           f"{a['preemptions']} (roomy {roomy['preemptions']})")
    cmp = _margin_compare(a["outputs"], roomy["outputs"], roomy["margins"],
                          f"paged preempt {mode}", gate=gate_tokens)
    classes = {c: {k: v for k, v in row.items() if k != "stop_reasons"}
               for c, row in a["sla"]["classes"].items()}
    emit({"phase": "paged", "run": "preemption", "mode": mode,
          "arch": model.cfg.name, "layers": model.cfg.n_layers,
          "dtype": model.cfg.compute_dtype, "pages": PREEMPT_PAGES,
          "pool_tokens": (PREEMPT_PAGES - 1) * PAGE_SIZE,
          "preemptions": a["preemptions"], "preempted": a["preempted"],
          "runs_identical": True, "steps": a["steps"], "graphs": a["graphs"],
          "roomy_steps": roomy["steps"], "classes": classes, **cmp})
    return a["outputs"]


def phase_paged_preempt_fp32(llama):
    """Run 3 again at llama7b-blast's full width in fp32,
    ``LLAMA_FP32_LAYERS`` layers (as the ``reference`` phase builds it): the same schedule and pool (page counts
    follow tokens, not layers), so the same preemptions.  In fp32 a
    recompute in other batch shapes moves a logit by ~1e-6, so the margin
    rule is ``MARGIN`` alone (``near_tie``'s two-step floor is ~1e-6 here):
    a resume that restored the wrong cache would flip tokens whose margin
    is far above it.  This is the witness that the bf16 run's flips near a
    bf16 step are rounding, not a resume fault."""
    from repro_torch.models import build_model
    small = dataclasses.replace(llama, n_layers=LLAMA_FP32_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(small, device=DEVICE)
    phase_paged_preempt(model, model.init(SEED), "llama:fp32",
                        serve_config(None, weights="none"))


# -- self-speculative decoding ------------------------------------------------

SPEC_K = 4
SPEC_FRACS = (0.5, 1.0)
# depth cuts, for the script's time: llama7b-blast's in the speculative
# runs, the round's parts, the int8 cache's paged run, the prefix-sharing
# and bf16 preemption runs, temperature sampling and the decode profiles;
# smollm-135m's in its speculative runs and decode profiles
LLAMA_CUT_LAYERS = 2
SMOLLM_CUT_LAYERS = 2
# llama7b-blast's fp32 witnesses (preemption, speculation) and its fp32
# card-vs-CPU reference: one layer, for the script's time
LLAMA_FP32_LAYERS = 1


def spec_config(config, frac, paged=False):
    """``config`` decoding self-speculatively: ``SPEC_K`` drafts a round
    from the model's factors truncated to ``frac`` of the rank budget;
    ``paged``: through the paged cache (``paged_config``)."""
    from repro_torch.serve import SpeculativeConfig
    config = dataclasses.replace(config, speculative=SpeculativeConfig(
        k=SPEC_K, draft_rank_frac=frac))
    return paged_config(config) if paged else config


class PadCount:
    """Counts the BLAST wrappers' per-launch rank pads (``ops._pad_last``
    where it copies) while active: a draft padded once at load pads in no
    launch, neither eagerly nor in a capture, whose copies every replay
    would repeat."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.n, self._ops, self._pad = 0, ops, ops._pad_last

        def counted(a, target):
            self.n += a.shape[-1] != target
            return self._pad(a, target)
        ops._pad_last = counted
        return self

    def __exit__(self, *exc):
        self._ops._pad_last = self._pad
        return False


def _recorded(engine) -> list:
    """Record every output of ``engine``'s steps (a round's token ids, a
    plain step's logits) with its bucket: [(key, output)].  Delete the
    wrapper (``del engine._run_step``) before the engine."""
    seen = []
    run_step = engine._run_step

    def run(key):
        out = run_step(key)
        seen.append((key, out.clone()))
        return out
    engine._run_step = run
    return seen


def _spec_run(model, params, config, prompts, max_new, per_step, what,
              step_fn=None) -> dict:
    """Serve ``prompts`` through a speculative engine: tokens, each step's
    output, counters, the launch equality (rounds × (k + 2) and plain
    steps × 2 — the step and the draft's replay — times ``per_step``), no
    per-launch rank pad, ``audit`` when paged; decode tok/s, ms a round,
    graphs, capture s, peak memory and the draft's parameter bytes."""
    import torch
    from repro_torch import quant
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    engine = Engine(model, params, config, device=DEVICE, step_fn=step_fn)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    seen = _recorded(engine)
    with PadCount() as pads:
        reqs, wall, launches, peak = _serve_run(engine, prompts, max_new)
    s = engine.stats
    rounds, plain = s["spec_rounds"], s["steps"] - s["spec_rounds"]
    want = {k: 0 for k in launches}
    want.update({k: n * (rounds * (SPEC_K + 2) + plain * 2)
                 for k, n in per_step.items()})
    if launches != want:
        raise RuntimeError(f"spec {what}: launch counts {launches} != {want} "
                           f"({rounds} rounds, {plain} plain steps)")
    if pads.n:
        raise RuntimeError(f"spec {what}: {pads.n} launches padded their "
                           "factors' rank")
    if rounds == 0:
        raise RuntimeError(f"spec {what}: no speculative round ran")
    if any(not r.done or len(r.output) != max_new for r in reqs):
        raise RuntimeError(f"spec {what}: a request did not finish with "
                           f"{max_new} tokens")
    if engine._pc is not None:
        engine._pc.audit()
    tp = engine.throughput()
    row = {"steps": s["steps"], "rounds": rounds, "plain_steps": plain,
           "acceptance_rate": tp["acceptance_rate"],
           "tokens_per_round": tp["tokens_per_round"],
           "spec_drafted": s["spec_drafted"],
           "spec_accepted": s["spec_accepted"],
           "spec_emitted": s["spec_emitted"],
           "draft_plan": engine.draft_plan,
           "draft_param_bytes": quant.tree_nbytes(engine.draft_params),
           "graphs": s["graphs"], "capture_s": s["capture_s"],
           "load_s": load_s, "wall_s": wall,
           "decode_tok_s": tp["decode_tok_s"],
           "round_ms_median": 1e3 * statistics.median(s["decode_step_s"]),
           "max_memory_allocated_bytes": peak,
           "launches": {k: v for k, v in launches.items() if v}}
    out = {"outputs": {r.uid: r.output for r in reqs}, "seen": seen,
           "row": row}
    del engine._run_step, engine
    return out


def _same_steps(a: dict, b: dict, what: str) -> None:
    """Two runs made the same steps at the same buckets (paged keys compared
    on their (C, kv) part) with equal outputs bit for bit."""
    import torch
    if [k[:2] for k, _ in a["seen"]] != [k[:2] for k, _ in b["seen"]]:
        raise RuntimeError(f"spec {what}: the runs stepped differently")
    for (key, x), (_, y) in zip(a["seen"], b["seen"]):
        if not torch.equal(x, y):
            raise RuntimeError(f"spec {what}: outputs differ at {key}")
    if a["outputs"] != b["outputs"]:
        raise RuntimeError(f"spec {what}: tokens differ")


def _plain_with_margins(model, params, config, prompts, max_new) -> dict:
    """The plain captured engine on ``prompts``: tokens, each token's
    near-tie flag and margin (``_with_margins``), decode tok/s and step
    ms."""
    import torch
    from repro_torch.serve import Engine
    engine = Engine(model, params, config, device=DEVICE)
    margins = _with_margins(engine)
    reqs, wall, _, peak = _serve_run(engine, prompts, max_new)
    torch.cuda.synchronize()
    tp = engine.throughput()
    out = {"outputs": {r.uid: r.output for r in reqs},
           "margins": {r.uid: margins[r.uid] for r in reqs},
           "row": {"steps": engine.stats["steps"],
                   "decode_tok_s": tp["decode_tok_s"],
                   "decode_step_ms_median": 1e3 * statistics.median(
                       engine.stats["decode_step_s"]),
                   "max_memory_allocated_bytes": peak}}
    del engine._run_step, engine._emit, engine
    return out


def padded_draft_equal(engine_params, model, plan) -> bool:
    """The draft padded once at load (``LM.pad_ranks``) against the same
    draft unpadded (each launch pads its factors): one ragged chunk's
    logits on fresh caches, equal bit for bit."""
    import torch
    from repro_torch.kernels import blast_matmul as kbm
    from repro_torch.kernels import ops
    unpadded = model.prestack_params(model.truncate_params(engine_params,
                                                           plan))
    padded = model.prestack_params(model.pad_ranks(unpadded,
                                                   kbm.float_tiles()[1]))
    gen = torch.Generator().manual_seed(SEED)
    toks = torch.randint(0, model.cfg.vocab, (8, 32), generator=gen)
    steps = torch.zeros(8, dtype=torch.int64)
    n = torch.arange(1, 33, 4, dtype=torch.int64)
    outs = []
    with ops.launches_apart():
        for tree in (unpadded, padded):
            cache = model.init_cache(8, 64)
            logits, _ = model.prefill_chunk(tree, cache, toks.to(DEVICE),
                                            steps.to(DEVICE), n.to(DEVICE),
                                            kv_len=64, all_logits=True)
            outs.append(logits)
    return bool(torch.equal(outs[0], outs[1]))


def phase_spec(model, params, mode, config, per_step, *, paged=True,
               eager=True, pad_check=False, fracs=SPEC_FRACS,
               gate_tokens=True, prompts=None, max_new=32):
    """Self-speculative decoding (k = ``SPEC_K``) of the serve phase's 16
    prompts, 32 new tokens, 8 slots, chunk 32, max_len 512, at each of
    ``fracs`` through the captured engine, and at the first also
    through the eager one (``step_fn``; with ``eager``) and the paged one
    (with ``paged``: the round's code is the same at every frac).  Each
    run: the launch equality, no per-launch rank pad, ``audit`` when
    paged; the tokens equal the plain engine's up to each request's first
    near-tie (``near_tie``, in the logits' precision); captured = eager
    and paged = slot-static bit for bit (every round's token ids and every
    plain step's logits); ``gate_tokens=False``: the tokens against the
    plain engine's are reported, not gated.  ``prompts``: default
    ``serve_prompts``; ``max_new`` new tokens each.  Prints rounds, acceptance, tokens a round,
    decode tok/s and ms a round against the plain engine's, graphs,
    capture s, peak memory and the draft's parameter bytes."""
    import torch
    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab) if prompts is None else prompts
    plain = _plain_with_margins(model, params, config, prompts, max_new)
    rows = []
    for frac in fracs:
        what = f"{mode} frac {frac}"
        runs = {"graphs": _spec_run(model, params, spec_config(config, frac),
                                    prompts, max_new, per_step, what)}
        if eager and frac == fracs[0]:
            runs["eager"] = _spec_run(
                model, params, spec_config(config, frac), prompts, max_new,
                per_step, what + " eager", step_fn=model.prefill_chunk)
            _same_steps(runs["graphs"], runs["eager"], what + " captured "
                        "against eager")
        if paged and frac == fracs[0]:
            runs["paged"] = _spec_run(
                model, params, spec_config(config, frac, paged=True),
                prompts, max_new, per_step, what + " paged")
            _same_steps(runs["graphs"], runs["paged"], what + " paged "
                        "against slot-static")
        cmp = _margin_compare(runs["graphs"]["outputs"], plain["outputs"],
                              plain["margins"], f"spec {what}",
                              gate=gate_tokens)
        g = runs["graphs"]["row"]
        row = {"phase": "spec", "mode": mode, "arch": cfg.name,
               "layers": cfg.n_layers, "dtype": cfg.compute_dtype,
               "weights": config.quant.weights, "cache": cfg.quant.cache,
               "k": SPEC_K, "draft_rank_frac": frac,
               "slots": config.scheduler.slots,
               "chunk": config.scheduler.chunk_size,
               "max_len": config.memory.max_len, "requests": len(prompts),
               "new_tokens": len(prompts) * max_new, **cmp,
               "graphs": g,
               **{path: run["row"] for path, run in runs.items()
                  if path != "graphs"},
               "plain": plain["row"],
               "distinct_tokens_per_request": statistics.mean(
                   len(set(o)) for o in plain["outputs"].values()),
               "distinct_tokens_min": min(
                   len(set(o)) for o in plain["outputs"].values()),
               "round_ms_over_plain_step_ms": (
                   g["round_ms_median"]
                   / plain["row"]["decode_step_ms_median"]),
               "decode_tok_s_over_plain": (g["decode_tok_s"]
                                           / plain["row"]["decode_tok_s"]),
               "captured_equals_eager": "eager" in runs or None,
               "paged_equals_slot_static": "paged" in runs or None,
               "per_step": per_step, "nvidia_smi": nvidia_smi()}
        if pad_check:
            from repro_torch.serve import Engine
            engine = Engine(model, params, spec_config(config, frac),
                            device=DEVICE)
            row["padded_draft_equals_unpadded"] = padded_draft_equal(
                engine.params, model, engine.draft_plan)
            del engine
            if not row["padded_draft_equals_unpadded"]:
                raise RuntimeError(f"spec {what}: the draft padded at load "
                                   "differs from the unpadded draft")
        emit(row)
        rows.append(row)
        del runs
        torch.cuda.synchronize()
    return rows


def phase_spec_fp32(llama):
    """llama7b-blast at full width in fp32, ``LLAMA_FP32_LAYERS`` layers
    (as the ``reference`` phase builds it), speculative at each of ``SPEC_FRACS``: there a logit
    moves by ~1e-6 between batch shapes, so the tokens are held to the
    plain engine's under the 1e-4 margin alone (``near_tie``'s two-step
    floor is far below it), and at frac 1.0 — the draft is the full model —
    at least 90% of the drafts are accepted."""
    from repro_torch.models import build_model
    small = dataclasses.replace(llama, n_layers=LLAMA_FP32_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(small, device=DEVICE)
    rows = phase_spec(model, model.init(SEED), "llama:fp32",
                      serve_config(None, weights="none"),
                      llama_per_step(small, "float"), paged=False,
                      eager=False)
    full = rows[SPEC_FRACS.index(1.0)]["graphs"]["acceptance_rate"]
    if full < 0.9:
        raise RuntimeError(f"spec llama:fp32: acceptance {full} at frac 1.0")


def cut_models(cfg, params, n_layers, modes):
    """(a model of each cache mode, params) of ``cfg`` cut to its first
    ``n_layers`` layers: the full model's layers, shared, not copied."""
    from repro_torch import quant
    from repro_torch.models import build_model
    cut = dataclasses.replace(cfg, n_layers=min(n_layers, cfg.n_layers))
    models = {mode: build_model(dataclasses.replace(
        cut, quant=quant.QuantConfig(cache=cache)), device=DEVICE)
        for mode, cache in modes.items()}
    return models, {**params, "layers": params["layers"][:cut.n_layers]}


def spec_llama(llama, models, params) -> None:
    """The ``spec`` phase's llama7b-blast runs at ``LLAMA_CUT_LAYERS``
    layers (``models`` of each cache mode and their ``params``): float and
    int8 cache (float also eager and paged), the round's parts
    (``spec_split``), and the fp32 runs."""
    for mode in ("float", "int8_cache"):
        timed(f"spec llama:{mode}", phase_spec, models[mode], params,
              f"llama:{mode}", serve_config(None, weights="none"),
              llama_per_step(models[mode].cfg, mode),
              paged=mode == "float", eager=mode == "float")
    timed("spec split llama:float", phase_spec_split, models["float"],
          params, serve_config(None, weights="none"))
    timed("spec llama:fp32", phase_spec_fp32, llama)


def _events_ms(fn, reps=20) -> float:
    """Median device ms of ``fn`` (one graph replay) by CUDA events, the
    device kept busy while the host enqueues it."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


def _graph_ms(fn, reps=20) -> float:
    """Median device ms of one replay of ``fn`` captured as a CUDA graph
    (warmed up eagerly on the capture stream first); launches kept
    apart."""
    import torch
    from repro_torch.kernels import ops
    graph = torch.cuda.CUDAGraph()
    capture = torch.cuda.graph(graph)
    side = capture.capture_stream
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), ops.launches_apart():
        fn()
    torch.cuda.current_stream().wait_stream(side)
    gc.collect()    # no dropped engine's graph freed under the capture
    with ops.launches_apart(), capture:
        fn()
    ms = _events_ms(graph.replay, reps)
    del graph
    return ms


def phase_spec_split(model, params, config, context=200):
    """The round's parts at llama7b-blast's width, each captured as a CUDA
    graph and timed by CUDA events (median of 20 replays): 8 rows at
    ``context`` cached tokens (kv bucket 256); one draft step (C = 1) at
    frac 0.5 and 1.0; the verify chunk (C = 8, T = 64, logits on every
    column); the draft resync chunk (C = 8, 3 live tokens a row) at each
    frac; the plain decode step; and one whole captured round of an engine
    at each frac."""
    import torch
    from repro_torch.kernels.flash_attention import kv_bucket
    from repro_torch.serve import Engine, Request
    B, S, Cv = 8, 512, 8
    kv = kv_bucket(context + SPEC_K + 1, S)
    steps = torch.full((B,), context, dtype=torch.int64, device=DEVICE)
    one = torch.ones(B, dtype=torch.int64, device=DEVICE)
    gen = torch.Generator().manual_seed(SEED)
    tok1 = torch.randint(0, model.cfg.vocab, (B, 1), generator=gen).to(DEVICE)
    tokv = torch.randint(0, model.cfg.vocab, (B, Cv), generator=gen).to(DEVICE)
    cache = model.init_cache(B, S)
    out = {"phase": "spec_split", "arch": model.cfg.name, "rows": B,
           "context": context, "kv_len": kv, "k": SPEC_K}
    full = model.prestack_params(params)
    out["plain_step_ms"] = _graph_ms(lambda: model.prefill_chunk(
        full, cache, tok1, steps, one, kv_len=kv))
    out["verify_ms"] = _graph_ms(lambda: model.prefill_chunk(
        full, cache, tokv, steps, one * (SPEC_K + 1), kv_len=kv,
        all_logits=True))
    for frac in SPEC_FRACS:
        engine = Engine(model, params, spec_config(config, frac),
                        device=DEVICE)
        dp = engine.draft_params
        out[f"draft_step_ms_frac_{frac}"] = _graph_ms(
            lambda: model.prefill_chunk(dp, cache, tok1, steps, one,
                                        kv_len=kv))
        out[f"resync_ms_frac_{frac}"] = _graph_ms(
            lambda: model.prefill_chunk(dp, cache, tokv, steps, one * 3,
                                        kv_len=kv))
        # one whole round, as the engine replays it
        for i in range(B):
            engine.submit(Request(uid=i, prompt=list(range(1, context)),
                                  max_new_tokens=64))
        while not engine.stats["spec_rounds"]:
            engine.tick()
        key = next(k for k in engine._graphs if k[0] == "spec")
        out["round_key"] = list(key)
        out[f"round_ms_frac_{frac}"] = _events_ms(
            engine._graphs[key].graph.replay)
        del engine, dp
        torch.cuda.synchronize()
    for frac in SPEC_FRACS:
        out[f"round_parts_ms_frac_{frac}"] = (
            SPEC_K * out[f"draft_step_ms_frac_{frac}"] + out["verify_ms"]
            + out[f"resync_ms_frac_{frac}"])
    out["nvidia_smi"] = nvidia_smi()
    emit(out)
    return out


def tile_blast(kernels) -> dict:
    """Calls and device ms of the tile kernel's two ``__global__``s (float
    and weight-only codes) in a profile's {name: [calls, ms]}:
    ``blast_tile_kernel``, and ``blast_split_sum`` where r is split.  The split sum is launched as a
    programmatic dependent of the tile kernel and waits for it on the card,
    so its span overlaps the tile kernel's: ``ms`` counts the tile kernel
    and the part of the sum's span past it is not separated."""
    out = {}
    for name in ("blast_tile_kernel", "blast_split_sum"):
        mine = [v for k, v in kernels.items() if name in k]
        out[name] = {"calls": sum(v[0] for v in mine),
                     "ms": sum(v[1] for v in mine)}
    out["ms"] = out["blast_tile_kernel"]["ms"]
    return out


ATTN_KERNELS = ("attn_tile_kernel", "attn_split_combine")


class TraceShort(RuntimeError):
    """A trace holds fewer records of a kernel than its launches, and no
    other kernel in their place: the profiler lost records, and the trace
    says nothing about which kernel ran."""


TRACE_TRIES = 3


def retried(fn):
    """``fn`` again, up to ``TRACE_TRIES`` runs in all, while its trace
    comes back short (``TraceShort``).  CUPTI on the H100 machine loses a
    few kernel records now and then (2 of 12 attention launches in one
    profile, 1 of 60 in another: PERF.md, ROADMAP's constraints; 1 of 60
    in two traces in a row of the training step once); the last trace must
    be whole and pass every check.  Each short trace is printed on a
    ``trace_retry`` line."""
    def call(*args, **kw):
        for _ in range(TRACE_TRIES - 1):
            try:
                return fn(*args, **kw)
            except TraceShort as e:
                emit({"phase": "trace_retry", "of": fn.__name__,
                      "error": str(e)})
        return fn(*args, **kw)
    return call


def attention_kernels(kernels, per: int, want_tile: int,
                      want_combine: int = 0) -> dict:
    """Calls and device ms (divided by ``per``) of the bf16 attention
    kernel and its split combine in a profile's {name: [calls, ms]}.
    Raises unless every attention launch ran one of the two, the tile
    kernel ran ``want_tile`` times (B3's or B4's launches) and the combine
    ``want_combine`` times (B3's split launches)."""
    out = {}
    for name in ATTN_KERNELS:
        mine = [v for k, v in kernels.items() if name in k]
        out[name] = {"calls": sum(v[0] for v in mine) / per,
                     "ms": sum(v[1] for v in mine) / per}
    out["ms"] = sum(out[name]["ms"] for name in ATTN_KERNELS)
    other = sorted(k for k in kernels if "attn" in k and not any(
        t in k for t in ATTN_KERNELS))
    tile = round(out["attn_tile_kernel"]["calls"] * per)
    combine = round(out["attn_split_combine"]["calls"] * per)
    if other or tile != want_tile or combine != want_combine:
        short = (not other and tile <= want_tile
                 and combine <= want_combine)
        raise (TraceShort if short else RuntimeError)(
            f"bf16 attention did not run the tile kernel alone: {out}, "
            f"other kernels {other}")
    return out


def _device_kernels(prof) -> dict:
    """{kernel name: [calls, device ms]} of a torch.profiler trace."""
    import torch
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    return kernels


def phase_profile(model, params, mode, config, prompt_len=16, graphs=True):
    """Device busy share of steady decode: 8 slots in decode after prompts
    of ``prompt_len`` tokens, 6 engine steps timed, then 6 more under
    ``torch.profiler``, through the captured engine (``graphs``) or the
    eager one: the wall time of each, the device busy time and kernel time
    by name from the trace, and the idle share of the untraced wall time.  Past one key tile of context
    (``LONG_PROMPT``) B3 splits the keys: its combine must run once for
    each of its launches.  The by-name checks run on every profile whose
    trace names the kernels (``kernels_by_name``); the eager profile of
    each mode always does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import Engine, Request
    engine = Engine(model, params, config, device=DEVICE,
                    step_fn=None if graphs else model.prefill_chunk)
    for i in range(8):
        engine.submit(Request(uid=i, prompt=list(range(1, prompt_len + 1)),
                              max_new_tokens=64))
    # prefill (chunks of 32), then warm decode (which captures the decode
    # graph of the profiled steps' kv bucket)
    engine.run(max_iters=-(-prompt_len // 32) + 2)
    n_steps = 6
    graphs_before = engine.stats["graphs"]
    # six steps timed without the profiler (which slows the host, and a
    # graph's replay on the card, while it traces), then six under it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(max_iters=n_steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(max_iters=n_steps)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if engine.stats["graphs"] != graphs_before:
        raise RuntimeError(f"{mode}: a profiled decode step captured a graph")
    kernels = _device_kernels(prof)
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    by_name = tile_blast(kernels)["blast_tile_kernel"]["calls"] > 0
    if not (by_name or graphs):
        raise RuntimeError(f"{mode}: the eager decode profile names no "
                           "BLAST tile kernel")
    row = {"phase": "profile", "mode": mode, "arch": model.cfg.name,
           "layers": model.cfg.n_layers,
           "path": "graphs" if graphs else "eager",
           "prompt_len": prompt_len, "decode_steps": n_steps, "slots": 8,
           "graphs": engine.stats["graphs"],
           "wall_ms_per_step": wall_ms / n_steps,
           "traced_wall_ms_per_step": traced_ms / n_steps,
           "device_busy_ms_per_step": busy / n_steps if kernels else None,
           # busy time under the profiler against the untraced wall time
           "device_idle_share": 1 - busy / wall_ms if kernels else None,
           "traced_idle_share": 1 - busy / traced_ms if kernels else None,
           "device_ops_per_step": (sum(v[0] for v in kernels.values())
                                   / n_steps),
           "kernels_by_name": by_name}
    if by_name:
        other = sorted(k for k in kernels if "blast" in k and not any(
            t in k for t in ("blast_tile_kernel", "blast_split_sum")))
        if other:
            raise RuntimeError(f"{mode} decode did not run the tile kernel "
                               f"alone: other BLAST kernels {other}")
        # the profiled steps write slots prompt_len + 8 … + 13 (after two
        # warm decode steps and six timed ones): kv_len as the attention
        # layer passes it (the bucket of the live key range), and B3's plan
        cfg = model.cfg
        sms = build.sm_count(torch.device(DEVICE))
        split_steps = sum(
            fa.split_plan(8, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                          1, fa.kv_bucket(prompt_len + 9 + i, 512),
                          sms)[2] > 1 for i in range(n_steps))
        row.update({
            "tile_blast_per_step": {
                k: ({"calls": v["calls"] / n_steps, "ms": v["ms"] / n_steps}
                    if isinstance(v, dict) else v / n_steps)
                for k, v in tile_blast(kernels).items()},
            "attn_per_step": attention_kernels(
                kernels, n_steps, cfg.n_layers * n_steps,
                cfg.n_layers * split_steps)})
    row["top"] = [{"name": n[:80], "calls_per_step": c / n_steps,
                   "ms_per_step": t / n_steps} for n, (c, t) in top]
    emit(row)
    return row


# -- training -------------------------------------------------------------------


def _rel_grad_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def phase_grads(cfg, moe):
    """fp32 gradients of the four autograd Functions on the card (kernel
    forward, B1 for BLAST dx, the batched launch for the experts' dx,
    explicit backward) against torch.autograd through the plain versions on
    the same inputs, at smollm-135m's training shapes (2048 tokens) and at
    granite-moe's ``wi`` and ``wo`` (32 experts of ``MOE_TRAIN_ROWS`` rows,
    its capacity at 2048 tokens; full, and with each expert's last 1–7
    rows zero, empty capacity slots): each gradient within 1e-4 × its
    largest entry."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 3)
    T = TRAIN_BATCH * TRAIN_SEQ
    cases = []
    E = moe.moe.n_experts
    for name, n, m, b, r in moe_shapes(moe):
        for empty in (False, True):
            x, U, S, V = make_blast_inputs(n, m, b, r, E, E * MOE_TRAIN_ROWS,
                                           torch.float32, gen, DEVICE)
            x = x.reshape(E, MOE_TRAIN_ROWS, n)
            if empty:
                for e in range(E):
                    x[e, MOE_TRAIN_ROWS - 1 - e % 7:] = 0
            slots = " empty slots" if empty else ""
            cases.append((f"blast_matmul_batched[{MOE} {name} E={E} rows="
                          f"{MOE_TRAIN_ROWS}{slots}]",
                          ops.blast_matmul_batched,
                          ref.blast_matmul_batched_ref, [x, U, S, V],
                          ("dx", "dU", "dS", "dV")))
    for name, n, m, b, r, G in blast_shapes(cfg):
        x, U, S, V = make_blast_inputs(n, m, b, r, G, T, torch.float32, gen,
                                       DEVICE)
        if G == 1:
            cases.append((f"blast_matmul[{name}]", ops.blast_matmul,
                          ref.blast_matmul_ref, [x, U[0], S[0], V[0]],
                          ("dx", "dU", "dS", "dV")))
        else:
            cases.append((f"blast_matmul_grouped[{name}]",
                          ops.blast_matmul_grouped,
                          ref.blast_matmul_grouped_ref, [x, U, S, V],
                          ("dx", "dU", "dS", "dV")))
    q, k, v = make_full_attn_inputs(TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads,
                                    TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim_,
                                    torch.float32, gen, DEVICE)
    cases.append(("flash_attention[B=8 T=256]", ops.flash_attention,
                  ref.attention_ref, [q, k, v], ("dq", "dk", "dv")))
    for name, fn, plain, inputs, names in cases:
        ops.reset_launches()
        a = [t.detach().clone().requires_grad_(True) for t in inputs]
        b_ = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = fn(*a)
        dy = torch.randn(y.shape, generator=gen).to(DEVICE)
        got = torch.autograd.grad(y, a, dy)
        want = torch.autograd.grad(plain(*b_), b_, dy)
        torch.cuda.synchronize()
        errs = {n_: _rel_grad_err(g, w) for n_, g, w in zip(names, got, want)}
        launched = {k: v for k, v in ops.launches.items() if v}
        ok = all(e <= 1e-4 for e in errs.values())
        if fn is ops.blast_matmul_batched:
            ok = ok and launched == {"blast_matmul_batched": 1,
                                     "blast_matmul_batched_dx": 1}
        emit({"phase": "grads", "case": name, "dtype": "float32",
              "max_err_over_max_grad": errs, "launches": launched,
              "limit": 1e-4, "ok": ok})
        if not ok:
            raise RuntimeError(f"grads[{name}]: {errs} past 1e-4, or "
                               f"launches {launched}")


ADAM_NOISE = 1e-3   # see phase_train_reference


def _adamw_step(params: list, grads, decay, lr) -> float:
    """One AdamW step (a constant ``lr``) in place; returns the skipped
    flag."""
    from repro_torch.optim import adamw, constant_schedule
    opt = adamw(constant_schedule(lr))
    return float(opt.update(list(grads), opt.init(params), params,
                            decay=decay)[2]["skipped"])


def phase_train_reference(cfg, layers=2, seq=128, **over):
    """Full width, ``layers`` layers, fp32, one batch of 2 × ``seq``
    tokens (``over``: other config fields, a hybrid's window): the card
    (kernels) against the CPU (plain versions) from the same seeded
    weights.  Loss within 1e-5 relative (a MoE model's ``aux`` too; the
    CPU takes the card's expert ids, ``SharedRouting``, after its near-tie
    check, remat's recompute routing again on both); every gradient within
    1e-4 × its leaf's largest entry.  One AdamW step (the trainer's decay
    rule, ``LM.decay_mask``) on each device's own gradients, both steps
    run on the card (the optimizer has no kernel; the card's AdamW is held
    against the CPU's on the same gradients once, in
    ``phase_optimizer_and_last_only``, and the CPU's is slow over a
    hybrid's 743 M parameters): every
    parameter within 1e-6, except entries whose CPU gradient is below
    ``ADAM_NOISE`` × its leaf's largest, bounded by 2 × lr.  There AdamW's
    first step, lr·g/(|g| + eps) on the clipped gradient, turns the
    gradients' rounding into step differences above 1e-6 (the clipped |g|
    is within a few tens of eps); the error at the narrower cut of 1e-6 ×
    the leaf's largest is reported beside it."""
    import contextlib
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import leaves, tree_map
    small = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                                compute_dtype="float32", **over)
    lr = 1e-3
    batch = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=2,
                        seed=SEED).batch(0)
    routing = SharedRouting() if cfg.moe else None
    # ``LM.init(SEED)`` drawn once, on the host; each device trains a copy
    cpu_model = build_model(small, device="cpu")
    init = cpu_model.init(SEED)
    models = (build_model(small, device=DEVICE), cpu_model)
    out = []
    with routing or contextlib.nullcontext():
        for i, model in enumerate(models):
            params = tree_map(lambda t: t.to(model.device, copy=True), init)
            decay = model.decay_mask(params)
            flat = leaves(params)
            for t in flat:
                t.requires_grad_(True)
            if routing is not None:
                routing.recording = i == 0      # the card's run
            loss, metrics = make_loss_fn(model)(params, batch)
            # the CPU's gradients and its copy of the init move to the
            # card, where the step runs and the results are compared
            grads = [g.to(DEVICE) for g in torch.autograd.grad(loss, flat)]
            flat = [p.detach().to(DEVICE) for p in flat]
            skipped = _adamw_step(flat, grads, decay, lr)
            out.append((model, float(loss.detach()), grads, flat, skipped,
                        float(metrics["aux"].detach())))
    (_, loss_g, grads_g, after_g, skip_g, aux_g), (
        _, loss_c, grads_c, after_c, skip_c, aux_c) = out
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    aux_rel = abs(aux_g - aux_c) / abs(aux_c) if cfg.moe else 0.0
    grad_err = max(_rel_grad_err(g, c) for g, c in zip(grads_g, grads_c))
    by_cut = {}
    for cut in (1e-6, ADAM_NOISE):
        param_err = noise_err = 0.0
        n_noise = 0
        for a, c, g in zip(after_g, after_c, grads_c):
            nz = g.abs() < cut * g.abs().max()
            err = (a - c).abs()
            param_err = max(param_err, float(torch.where(nz, 0.0, err).max()))
            noise_err = max(noise_err, float(torch.where(nz, err, 0.0).max()))
            n_noise += int(nz.sum())
        by_cut[cut] = {"max_param_err": param_err, "noise_entries": n_noise,
                       "max_noise_entry_err": noise_err}
    held = by_cut[ADAM_NOISE]
    ok = (loss_rel <= 1e-5 and aux_rel <= 1e-5 and grad_err <= 1e-4
          and held["max_param_err"] <= 1e-6
          and held["max_noise_entry_err"] <= 2 * lr
          and skip_g == skip_c == 0)
    emit({"phase": "train_reference", "arch": cfg.name, "layers": layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": "float32",
          "tokens": [2, seq], **over,
          "loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_rel,
          **({"aux_card": aux_g, "aux_cpu": aux_c, "aux_rel_err": aux_rel,
              "routing": {"calls": routing.calls, "tokens": routing.tokens,
                          "tokens_with_swapped_experts": routing.flips,
                          "max_gap_at_swaps": routing.max_gap}}
             if cfg.moe else {}),
          "max_grad_err_over_leaf_max": grad_err,
          "after_step_by_noise_cut": {str(k): v for k, v in by_cut.items()},
          "params": sum(a.numel() for a in after_c),
          "limits": {"loss_rel": 1e-5, "aux_rel": 1e-5, "grad": 1e-4,
                     "param": 1e-6, "noise_cut": ADAM_NOISE,
                     "noise": 2 * lr}, "ok": ok})
    if not ok:
        raise RuntimeError(f"train_reference[{cfg.name}]: the card's "
                           "training step differs from the CPU's past its "
                           "limits")


def phase_optimizer_and_last_only(cfg, layers=2, seq=128):
    """Two checks that do not depend on the family, on ``cfg`` at full
    width, ``layers`` layers, fp32: the optimizer alone — one AdamW step
    on the card against the CPU's AdamW on the same (the card's)
    gradients, every parameter within 1e-6 — and
    ``LM.apply(last_only=True)`` against ``prefill_chunk`` on the card (B4
    against B3), logits within 1e-4."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import leaves, tree_map
    small = dataclasses.replace(cfg, n_layers=layers, param_dtype="float32",
                                compute_dtype="float32")
    lr = 1e-3
    toks = TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=2,
                       seed=SEED).batch(0)["tokens"]
    model = build_model(small, device=DEVICE)
    init = model.init(SEED)
    params = tree_map(lambda t: t.clone().requires_grad_(True), init)
    flat = leaves(params)
    grads = torch.autograd.grad(
        make_loss_fn(model)(params, {"tokens": toks})[0], flat)
    decay = model.decay_mask(params)
    card = [p.detach().clone() for p in flat]
    host = [p.detach().cpu() for p in flat]
    _adamw_step(card, grads, decay, lr)
    _adamw_step(host, [g.cpu() for g in grads], decay, lr)
    optimizer_err = max(float((a.cpu() - c).abs().max())
                        for a, c in zip(card, host))
    # B4 (apply, last_only) against B3 (prefill_chunk)
    toks = toks[:, :seq]
    with torch.no_grad():
        last = model.apply(init, toks, last_only=True).logits
    pre, _ = model.prefill_chunk(init, model.init_cache(2, seq), toks,
                                 [0, 0], [seq, seq])
    lo_err = float((last - pre).abs().max())
    ok = optimizer_err <= 1e-6 and lo_err <= 1e-4
    emit({"phase": "optimizer_and_last_only", "arch": cfg.name,
          "layers": layers, "dtype": "float32", "tokens": [2, seq],
          "same_grads_optimizer_max_param_err": optimizer_err,
          "last_only_vs_prefill_chunk_max_abs_err": lo_err,
          "limits": {"same_grads_optimizer": 1e-6, "last_only": 1e-4},
          "ok": ok})
    if not ok:
        raise RuntimeError("optimizer_and_last_only: the card's AdamW or "
                           "B4's last logits differ past their limits")


# the train_reference runs: arch → (layers, tokens a row, config fields);
# recurrentgemma-2b at a window of 64 over 200 tokens, so B4's window and
# the RG-LRU scan run under autograd past the window
TRAIN_REFERENCE = {"smollm-135m": (2, 128, {}), "gpt2-blast": (2, 128, {}),
                   "recurrentgemma-2b": (3, 200, {"window": 64}),
                   "mamba2-130m": (4, 128, {}),
                   "granite-moe-1b-a400m": (2, 128, {})}


def _bits(t):
    """A float tensor's bit patterns (NaNs compare equal to themselves)."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _trainer(cfg, jit, log, lr=TRAIN_LR, steps=TRAIN_STEPS):
    """The port's ``Trainer`` at the launcher's shape, from ``LM.init(SEED)``,
    its ``train_step`` wrapped to time each step and record its metrics,
    its launches and (``log["keep"]`` steps) every parameter after it."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.train import Trainer
    from repro_torch.tree import leaves
    model = build_model(cfg, device=DEVICE)
    opt = adamw(cosine_schedule(lr, steps, TRAIN_WARMUP))
    data = TokenStream(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=SEED)
    trainer = Trainer(model, opt, data, jit=jit, log_every=10 ** 9)
    inner = trainer.train_step

    def train_step(params, opt_state, batch):
        before = dict(ops.launches)
        capture_s = trainer.stats["capture_s"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = inner(params, opt_state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0
              - (trainer.stats["capture_s"] - capture_s)) * 1e3
        row = {"path": "graphs" if jit else "eager",
               "step": len(log["rows"]), "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]),
               "skipped": bool(m["skipped"]), "ms": ms,
               "launches": {k: v - before[k] for k, v in ops.launches.items()
                            if v != before[k]}}
        if len(log["rows"]) < log["keep"]:
            log["params"].append([p.detach().clone()
                                  for p in leaves(params)])
        log["rows"].append(row)
        emit({"phase": "train_step", **row})
        return params, opt_state, m

    trainer.train_step = train_step
    return trainer


def _profile_train_step(trainer, result, step, want_b4, eager=False):
    """One more training step under torch.profiler — a replay of the
    captured step, or (``eager``) the step function run eagerly: device
    time by kernel name and the device idle share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params, opt_state = result["params"], result["opt_state"]
    batch = trainer.data.batch(step)
    if eager:
        batch = {"tokens": batch["tokens"].to(DEVICE)}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if eager:
            trainer.step_fn(params, opt_state, batch)
        else:
            trainer.train_step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = _device_kernels(prof)
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]
    by_name = tile_blast(kernels)["blast_tile_kernel"]["calls"] > 0
    out = {"path": "eager" if eager else "graphs", "wall_ms": wall_ms,
           "device_busy_ms": busy,
           "device_idle_share": 1 - busy / wall_ms if kernels else None,
           "device_ops": sum(v[0] for v in kernels.values()),
           "kernels_by_name": by_name}
    if by_name:
        out.update(tile_blast=tile_blast(kernels),
                   attn=attention_kernels(kernels, 1, want_b4))
    elif eager:
        raise RuntimeError("the eager training profile names no BLAST tile "
                           "kernel")
    out["top"] = [{"name": n[:80], "calls": c, "ms": t} for n, (c, t) in top]
    return out


# kernels each family's training step launches (every one of them, and no
# other): B1 everywhere, B2 where a bundle shares an input (smollm's gate +
# up, the hybrid's in_gate + in_x), B4 in every attention layer (mamba2 has
# none), the batched expert launch and its dx in granite-moe
TRAIN_KERNELS = {
    "smollm-135m": ("blast_matmul", "blast_matmul_grouped", "flash_attention",
                    "blast_matmul_dx"),
    "gpt2-blast": ("blast_matmul", "flash_attention", "blast_matmul_dx"),
    "recurrentgemma-2b": ("blast_matmul", "blast_matmul_grouped",
                          "flash_attention", "blast_matmul_dx"),
    "mamba2-130m": ("blast_matmul", "blast_matmul_dx"),
    "granite-moe-1b-a400m": ("blast_matmul", "flash_attention",
                             "blast_matmul_dx", "blast_matmul_batched",
                             "blast_matmul_batched_dx")}
# the other families' train runs: arch → (layers, captured steps), cut in
# depth for the script's time: recurrentgemma-2b to one cycle (rglru,
# rglru, local_attn: its RG-LRU scan runs token by token) and 10 steps,
# mamba2-130m to 12 of its 24 layers, granite-moe to 6 of 24, gpt2-blast
# to 6 of 12.  gpt2-blast trains 60 steps: at lr 1e-3 on 8 × 256 tokens
# its held-out loss rises over the first 20 to 40 steps before it falls,
# and the reference's does the same
# (``tests/test_torch_train_witness.py``)
TRAIN_RUNS = {"gpt2-blast": (6, 60), "recurrentgemma-2b": (3, 10),
              "mamba2-130m": (12, 20), "granite-moe-1b-a400m": (6, 20)}
# a batch no training run sees: its loss before and after a run
HELDOUT_BATCH = 10 ** 6


def phase_train(cfg, steps=TRAIN_STEPS, eager_steps=3, profile=True,
                lr=TRAIN_LR):
    """``cfg`` at full width trained by the port's ``Trainer`` (bf16, remat,
    seeded ``LM.init``, the ``TokenStream`` at the launcher's batch 8 × seq
    256, AdamW with a cosine schedule over ``TRAIN_STEPS``): ``steps``
    steps through the captured step (``jit=True``, the default: one eager
    warm-up step, then a CUDA graph), then ``eager_steps`` steps of a
    ``jit=False`` trainer from the same init on the same batches, whose
    loss, grad norm and every parameter must equal the captured run's bit
    for bit after each of the first 3 steps.  The kernels launched are
    ``TRAIN_KERNELS[cfg.name]``, each of them, B4 once an attention layer
    and once more in remat's recompute (a MoE layer's two batched launches
    the same, and two batched dx launches).  The loss must fall: the loss
    on ``HELDOUT_BATCH``, a batch no step sees, below its loss before the
    run.  With
    ``profile`` one profiled step each way.  Then one captured step whose loss is made
    non-finite (NaN in the embedding row of the batch's first token) must
    be skipped, leave params, m and v bit for bit and still count.
    Returns the launch counts of the captured run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import leaves, tree_map
    logs = {path: {"rows": [], "params": [], "keep": 3}
            for path in ("graphs", "eager")}
    trainer = _trainer(cfg, True, logs["graphs"], lr, steps)
    # ``LM.init(SEED)`` drawn once (on the host, seconds at full width):
    # the captured run trains a copy, the eager run the draw itself
    init = trainer.model.init(SEED)
    trainer.model.init = lambda seed: tree_map(torch.clone, init)
    heldout = {"tokens": trainer.data.batch(HELDOUT_BATCH)["tokens"].to(
        DEVICE)}

    def heldout_loss(params) -> float:
        with torch.no_grad():
            return float(make_loss_fn(trainer.model)(params, heldout)[0])

    heldout_before = heldout_loss(init)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = trainer.run(steps, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    rc = 1 + int(cfg.remat)
    want = {"flash_attention": rc * sum(
        s.kind in ("attn", "local_attn") for s in trainer.model.specs)}
    if cfg.moe:
        want.update(blast_matmul_batched=2 * L * rc,
                    blast_matmul_batched_dx=2 * L)
    prof = prof_eager = None
    if profile:
        prof = retried(_profile_train_step)(trainer, result, steps,
                                            want["flash_attention"])
    ms = statistics.median(r["ms"] for r in logs["graphs"]["rows"][3:steps])
    if prof:
        prof["device_idle_share_of_median_step"] = 1 - prof[
            "device_busy_ms"] / ms
    per_step = logs["graphs"]["rows"][:steps]
    params, state = result["params"], result["opt_state"]
    heldout_after = heldout_loss(params)
    # the NaN step: a replay of the captured graph
    batch = trainer.data.batch(steps + 1)
    tok = int(batch["tokens"][0, 0])
    embed = params["embed"]
    held = embed.detach()[tok].clone()
    with torch.no_grad():
        embed[tok] = float("nan")
    before = [t.detach().clone() for t in leaves((params, state["m"],
                                                  state["v"]))]
    count = int(state["count"])
    _, _, m = trainer.train_step(params, state, batch)
    nan_skipped = float(m["skipped"]) == 1.0
    nan_held = all(torch.equal(_bits(a.detach()), _bits(b)) for a, b in
                   zip(leaves((params, state["m"], state["v"])), before))
    nan_counted = int(state["count"]) == count + 1
    with torch.no_grad():
        embed[tok] = held
    graphs, capture_s = trainer.stats["graphs"], trainer.stats["capture_s"]
    del trainer, result, params, state, before, embed
    # the wrapped ``train_step`` holds its trainer in a reference cycle:
    # collect it, and the captured graph's pool, before the eager run
    gc.collect()
    torch.cuda.empty_cache()
    # the eager trainer, from the same init on the same batches
    eager = _trainer(cfg, False, logs["eager"], lr, steps)
    eager.model.init = lambda seed: init
    eager_result = eager.run(eager_steps, seed=SEED)
    del init
    if profile:
        prof_eager = retried(_profile_train_step)(
            eager, eager_result, eager_steps, want["flash_attention"],
            eager=True)
    # the eager steps' median, the first (cold allocator) left out
    eager_ms = statistics.median(r["ms"] for r in
                                 logs["eager"]["rows"][1:eager_steps])
    if prof_eager:
        prof_eager["device_idle_share_of_median_step"] = 1 - prof_eager[
            "device_busy_ms"] / eager_ms
    del eager, eager_result
    ga, ea = logs["graphs"], logs["eager"]
    same = [ga["rows"][i]["loss"] == ea["rows"][i]["loss"]
            and ga["rows"][i]["grad_norm"] == ea["rows"][i]["grad_norm"]
            and all(torch.equal(x, y) for x, y in zip(ga["params"][i],
                                                     ea["params"][i]))
            for i in range(min(3, eager_steps))]
    ga["params"].clear()
    ea["params"].clear()
    gc.collect()
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in per_step]
    eager_rows = ea["rows"][:eager_steps]
    # a linear of another kind than BLAST is a plain product: B4 alone
    trained = (set(TRAIN_KERNELS[cfg.name]) if cfg.structure.kind == "blast"
               else {"flash_attention"})
    stray = {k: v for k, v in launches.items() if v and k not in trained}
    emit({"phase": "train", "arch": cfg.name, "layers": L,
          "structure": cfg.structure.kind,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
          "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": steps, "lr": lr, "warmup": TRAIN_WARMUP,
          "graphs": graphs, "capture_s": capture_s,
          "losses": losses, "first_loss": losses[0],
          "last5_mean_loss": statistics.fmean(losses[-5:]),
          "heldout_loss_before": heldout_before,
          "heldout_loss_after": heldout_after,
          "median_step_ms_after_3": ms,
          "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": {k: v / steps
                                for k, v in launches.items() if v},
          "eager_steps": eager_steps,
          "eager_step_ms": [r["ms"] for r in eager_rows],
          "eager_median_step_ms_after_1": eager_ms,
          "graphs_equal_eager_bitwise_per_step": same,
          "nan_step": {"skipped": nan_skipped, "held": nan_held,
                       "counted": nan_counted},
          **({"profile": prof, "profile_eager": prof_eager}
             if profile else {})})
    bad = []
    if not all(map(math.isfinite, losses)) or len(losses) != steps:
        bad.append(f"losses {losses}")
    if any(r["skipped"] for r in per_step + eager_rows):
        bad.append("a step was skipped")
    if not heldout_after < heldout_before:
        bad.append(f"the held-out batch's loss did not fall: "
                   f"{heldout_before} → {heldout_after}")
    for k, n in want.items():
        if launches[k] != n * steps:
            bad.append(f"{k} launched {launches[k]} times, want "
                       f"{n * steps}")
    if stray:
        bad.append(f"kernels off the training path launched: {stray}")
    if any(launches[k] == 0 for k in trained):
        bad.append(f"a training kernel never launched: {launches}")
    if graphs != 1:
        bad.append(f"the trainer captured {graphs} graphs, want 1")
    if not all(same):
        bad.append(f"captured and eager training differ: {same}")
    if not (nan_skipped and nan_held and nan_counted):
        bad.append("the non-finite step under capture was not skipped "
                   "cleanly")
    if bad:
        raise RuntimeError(f"train[{cfg.name}]: " + "; ".join(bad))
    return launches


# -- the paper's baseline structures and its compression -----------------------

# the new kinds' fp32 card-vs-CPU references, float and int8 weights
STRUCTURE_REFERENCE = ("low_rank50", "monarch50", "pixelfly50", "block_diag")
STRUCTURE_INT8 = ("low_rank50", "pixelfly50")   # their int8 serving runs
# the variants' serving runs: 8 of the serve phase's prompts, 16 new tokens
# each, for the script's time
VARIANT_PROMPTS, VARIANT_NEW = 8, 16
# the variants' attention out projections scaled ×0.1 (``variant_weights``):
# at the init's scale every request of monarch50 repeats one token, its
# linears' gains ~0.4–0.7 leaving the mean that attention takes over random
# tokens to decide (a smaller embedding instead makes blast80 repeat);
# scaled, the per-token path decides, as ``MOE_ATTN_OUT_SCALE`` does for
# granite-moe
VARIANT_ATTN_OUT_SCALE = 0.1
# the factor of each kind that scales its product (Pixelfly: both terms)
OUT_FACTORS = {"dense": ("w",), "blast": ("U",), "low_rank": ("w_up",),
               "monarch": ("R",), "block_diag": ("w",),
               "pixelfly": ("w", "w_up")}
# the low-rank model's speculative runs: fp32 at 2 layers (frac 1.0), bf16
# at 2 of 30 layers (frac 0.5)
STRUCTURE_SPEC_LAYERS = 2
# the new kinds' gpt2-blast training runs: (layers, captured steps); as
# gpt2-blast's own, 60 steps: at lr 1e-3 the held-out loss of the
# low-rank model is still above its start after 30
STRUCTURE_TRAIN = ("low_rank50", "monarch50", "pixelfly50")
STRUCTURE_TRAIN_RUN = (2, 60)
# compression at full width: Algorithm 2's and the Adam fits' steps, the
# parity case (m = n, b, r) and the power-law decay of the targets
COMPRESS_STEPS = 20
COMPRESS_PARITY = (512, 16, 128)
COMPRESS_DECAY = 2.0
COMPRESS_TARGETS = ("blast", "low_rank50", "monarch50", "block_diag")
COMPRESS_LINEARS = (("mixer", "qkv"), ("mixer", "out"), ("ffn", "gate"),
                    ("ffn", "up"), ("ffn", "wo"))


def variant_per_step(cfg, mode="none") -> dict:
    """Launches a smollm-135m serving step makes under ``cfg``'s structure:
    a BLAST model's (``smollm_per_step``); any other kind runs its linears
    as plain products, so B3 alone, once a layer."""
    if cfg.structure.kind == "blast":
        return smollm_per_step(cfg, mode)
    return {"flash_attention_prefill": cfg.n_layers}


def variant_weights(cfg, params):
    """``params`` with every attention out projection scaled by
    ``VARIANT_ATTN_OUT_SCALE`` (the factor of ``OUT_FACTORS``)."""
    scaled = OUT_FACTORS[cfg.structure.kind]
    layers = []
    for layer in params["layers"]:
        out = {k: v * VARIANT_ATTN_OUT_SCALE if k in scaled else v
               for k, v in layer["mixer"]["out"].items()}
        layers.append({**layer, "mixer": {**layer["mixer"], "out": out}})
    return {**params, "layers": layers}


def phase_reference_structures(cfg):
    """``phase_reference`` (fp32, 2 layers, card against CPU, codes and
    scales equal) for each of ``STRUCTURE_REFERENCE`` in float and int8
    weights, from one CPU init a variant."""
    from repro_torch import configs
    from repro_torch.models import build_model
    for v in STRUCTURE_REFERENCE:
        vcfg = configs.variant(cfg, v)
        base = build_model(dataclasses.replace(
            vcfg, n_layers=2, param_dtype="float32", compute_dtype="float32"),
            device="cpu").init(SEED)
        for weights, label in (("none", "float"), ("int8", "int8")):
            phase_reference(vcfg, f"smollm:{v}:{label}", weights=weights,
                            base=base)


def phase_variants(cfg, blast50_row) -> dict:
    """smollm-135m at full width (30 layers, bf16, ``LM.init(SEED)``, the
    attention out projections scaled: ``variant_weights``) in every variant
    of ``configs.VARIANTS`` (blast50 is the default config:
    the ``serve none`` run's row) and int8 weights for ``STRUCTURE_INT8``:
    captured = eager tokens, launches steps × ``variant_per_step``, every
    request emitting more than one distinct token (``varied``); then the
    captured decode profile (busy ms, kernels a step).  One summary line:
    each variant's step ms, busy ms, kernels a step, parameter bytes and
    which of B1/B2/B3 it launches.  Returns each run's launch counts."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    launches, summary_rows = {}, {}
    runs = [(v, "none") for v in configs.VARIANTS if v != "blast50"]
    runs += [(v, "int8") for v in STRUCTURE_INT8]
    for v, mode in runs:
        vcfg = configs.variant(cfg, v)
        model = build_model(vcfg, device=DEVICE)
        params = model.init(SEED)
        params = variant_weights(vcfg, params)
        label = f"smollm:{v}" + (":int8" if mode == "int8" else "")
        per_step = variant_per_step(vcfg, mode)
        launches[label], row, outputs = timed(
            f"serve {label}", phase_serve, model, params, label,
            serve_config(mode), per_step,
            prompts=serve_prompts(cfg.vocab, n=VARIANT_PROMPTS),
            max_new=VARIANT_NEW, structure=vcfg.structure.kind)
        varied(outputs, f"serve {label}")
        prof = timed(f"profile {label}", retried(phase_profile), model,
                     params, label, serve_config(mode))
        summary_rows[label] = {
            "structure": vcfg.structure.kind,
            "decode_step_ms": row["graphs"]["decode_step_ms_median"],
            "busy_ms": prof["device_busy_ms_per_step"],
            "kernels_per_step": prof["device_ops_per_step"],
            "param_bytes": row["param_bytes"],
            "launches_per_step": per_step}
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    summary_rows["smollm:blast50"] = {
        "structure": "blast", "decode_step_ms":
            blast50_row["graphs"]["decode_step_ms_median"],
        "param_bytes": blast50_row["param_bytes"],
        "launches_per_step": smollm_per_step(cfg, "none"),
        "run": "serve none (16 prompts, 32 new tokens)"}
    emit({"phase": "variants", "arch": cfg.name, "layers": cfg.n_layers,
          "requests": VARIANT_PROMPTS, "new_tokens": VARIANT_NEW,
          "rows": summary_rows, "nvidia_smi": nvidia_smi()})
    return launches


def phase_spec_low_rank(cfg):
    """Self-speculative decoding of smollm-135m as ``low_rank50``, its draft
    the low-rank factors truncated by energy: fp32 at
    ``STRUCTURE_SPEC_LAYERS`` layers, frac 1.0, tokens held to plain
    decoding's at the 1e-4 margin and acceptance ≥ 0.9; bf16 at the same
    depth, frac 0.5, slot-static and paged (paged = slot-static bit for
    bit), its acceptance reported, its tokens held to plain's up to each
    first near-tie."""
    from repro_torch import configs
    from repro_torch.models import build_model
    vcfg = configs.variant(cfg, "low_rank50")
    for dtype, frac in (("float32", 1.0), ("bfloat16", 0.5)):
        small = dataclasses.replace(vcfg, n_layers=STRUCTURE_SPEC_LAYERS,
                                    param_dtype=dtype, compute_dtype=dtype)
        model = build_model(small, device=DEVICE)
        mode = "low_rank50:" + ("fp32" if dtype == "float32" else "bf16")
        rows = phase_spec(model, model.init(SEED), mode, serve_config("none"),
                          variant_per_step(small), paged=dtype != "float32",
                          eager=False, fracs=(frac,))
        acc = rows[0]["graphs"]["acceptance_rate"]
        if dtype == "float32" and acc < 0.9:
            raise RuntimeError(f"spec {mode}: acceptance {acc} at frac 1.0")


def synth_weight(gen, d_in, d_out, decay=COMPRESS_DECAY):
    """A (d_in, d_out) weight of power-law singular values s_i = i^-decay
    between random orthonormal bases (the reference example's
    ``examples/compress_llama_block.py::synth_weight``), drawn on the card
    in fp32."""
    import torch
    r = min(d_in, d_out)
    u, _ = torch.linalg.qr(torch.randn((d_in, r), generator=gen,
                                       device=DEVICE))
    v, _ = torch.linalg.qr(torch.randn((d_out, r), generator=gen,
                                       device=DEVICE))
    s = torch.arange(1, r + 1, device=DEVICE, dtype=torch.float32) ** -decay
    return (u * s) @ v.T


def _compress_parity():
    """Algorithm 2 on the card against the CPU at ``COMPRESS_PARITY``, 20
    steps, fp32, from one start: the loss before each step and after the
    last within 1e-4 relative."""
    import torch
    from repro_torch.core import factorize as fct
    m, b, r = COMPRESS_PARITY
    gen = torch.Generator().manual_seed(SEED)
    A = synth_weight(card_seed(), m, m).cpu()
    p, q = m // b, m // b
    start = (1e-2 * torch.randn((b, p, r), generator=gen),
             torch.rand((b, b, r), generator=gen),
             1e-2 * torch.randn((b, q, r), generator=gen))
    cpu = fct.factorize(A, b, r, steps=20, start=start)
    card = fct.factorize(A.to(DEVICE), b, r, steps=20,
                         start=tuple(t.to(DEVICE) for t in start))
    want = torch.cat([cpu.losses, cpu.final_loss[None]])
    got = torch.cat([card.losses, card.final_loss[None]]).cpu()
    rel = float(((got - want).abs() / want.abs()).max())
    row = {"case": f"{m}x{m} b={b} r={r}", "steps": 20,
           "loss_first": float(want[0]), "loss_last": float(want[-1]),
           "max_rel_loss_err": rel, "limit": 1e-4}
    if rel > 1e-4:
        raise RuntimeError(f"compress: Algorithm 2's losses on the card "
                           f"differ from the CPU's by {rel} relative")
    return row


def phase_compress(llama):
    """Compression at full width (``core/compress.py``, ``core/
    factorize.py``).  (a) ``_compress_parity``.  (b) One layer of
    ``variant(llama7b-blast, "dense")`` whose five linears are
    ``synth_weight`` matrices (qkv 4096 → 12288, out 4096², gate and up
    4096 → 11008, down 11008 → 4096), compressed by ``compress_tree`` into
    llama7b-blast's per-role BLAST ranks (b = 16, r = 1024 attention, 1488
    FFN; Algorithm 2) and into low_rank50 (SVD), monarch50 (Adam) and
    block_diag (extraction), ``COMPRESS_STEPS`` steps each fit: every
    linear's normalized error and seconds, Algorithm 2's loss before its
    first step (½‖A‖²) and after its last (½‖A − Â‖²), its seconds a step
    at out's 4096 × 4096, r = 1024 and the FFN's shapes, r = 1488; BLAST's
    error at most block_diag's on every linear (the paper's Tables 3/12).
    (c) The BLAST-compressed layer as llama7b-blast's one layer: served
    through B1/B2/B3 (bf16, captured = eager, launches steps × (3, 1, 1)),
    and card against CPU in fp32 (``phase_reference``).  Returns the
    serving run's launch counts."""
    import torch
    from repro_torch import configs
    from repro_torch.core import compress
    from repro_torch.models import build_model
    from repro_torch.models.transformer import make_block
    from repro_torch.tree import tree_map
    parity = _compress_parity()
    gen = card_seed()
    dense_blk = make_block(configs.variant(llama, "dense"), "attn")
    weights = {f"{g}.{n}": synth_weight(
        gen, getattr(getattr(dense_blk, g), n).d_in,
        getattr(getattr(dense_blk, g), n).d_out) for g, n in COMPRESS_LINEARS}
    errors, seconds, out = {}, {}, {}
    for target in COMPRESS_TARGETS:
        tcfg = llama if target == "blast" else configs.variant(llama, target)
        blk = make_block(tcfg, "attn")
        specs = {k: getattr(getattr(blk, k.split(".")[0]), k.split(".")[1])
                 for k in weights}
        out[target] = {}
        for name, w in weights.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[target][name] = compress.compress_tree(
                {name: w}, {name: specs[name]}, steps=COMPRESS_STEPS,
                generator=gen)[name]
            torch.cuda.synchronize()
            seconds[f"{target}:{name}"] = time.perf_counter() - t0
            errors[f"{target}:{name}"] = compress.reconstruction_error(
                w, specs[name], out[target][name])
    blast_rows = {}
    for name, w in weights.items():
        a_sq = float(torch.sum(w * w))
        err = errors[f"blast:{name}"]
        blast_rows[name] = {
            "shape": list(w.T.shape), "normalized_error": err,
            "loss_first": 0.5 * a_sq, "loss_last": 0.5 * a_sq * err * err,
            "seconds": seconds[f"blast:{name}"],
            "seconds_per_step": seconds[f"blast:{name}"] / COMPRESS_STEPS}
    worse = [n for n in weights
             if errors[f"blast:{n}"] > errors[f"block_diag:{n}"]]
    emit({"phase": "compress", "parity": parity, "steps": COMPRESS_STEPS,
          "decay": COMPRESS_DECAY, "blast": blast_rows,
          "errors": errors, "seconds": seconds,
          "alg2_seconds_per_step": {
              "4096x4096 r=1024": blast_rows["mixer.out"]["seconds_per_step"],
              "11008x4096 r=1488 (gate)":
                  blast_rows["ffn.gate"]["seconds_per_step"]},
          "blast_not_above_block_diag": not worse,
          "nvidia_smi": nvidia_smi()})
    if worse:
        raise RuntimeError(f"compress: BLAST's error above block_diag's on "
                           f"{worse}")
    # (c) the compressed layer, served and held card against CPU
    one = dataclasses.replace(llama, n_layers=1)
    layer = out["blast"]

    def with_layer(params, dtype):
        params["layers"][0] = {**params["layers"][0]}
        for key, lin in layer.items():
            g, n = key.split(".")
            params["layers"][0][g] = {**params["layers"][0][g],
                                      n: {k: v.to(dtype)
                                          for k, v in lin.items()}}
        return params

    model = build_model(one, device=DEVICE)
    params = with_layer(model.init(gen), torch.bfloat16)
    launches, _, outputs = timed(
        "serve compress:blast", phase_serve, model, params, "compress:blast",
        serve_config(None, weights="none"), llama_per_step(one, "float"),
        prompts=serve_prompts(one.vocab, n=VARIANT_PROMPTS),
        max_new=VARIANT_NEW)
    emit({"phase": "compress", "run": "serve compress:blast",
          "distinct_tokens_min": min(len(set(o)) for o in outputs)})
    del model, params
    fp32 = dataclasses.replace(one, param_dtype="float32",
                               compute_dtype="float32")
    base = tree_map(lambda t: t.cpu(), with_layer(
        build_model(fp32, device=DEVICE).init(gen), torch.float32))
    phase_reference(llama, "compress:blast", base=base, layers=1)
    del out, weights, base
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_structures(gpt2) -> dict:
    """gpt2-blast (full width, ``STRUCTURE_TRAIN_RUN`` layers and steps) as
    each of ``STRUCTURE_TRAIN``: ``phase_train`` without its profile
    (captured = eager bit for bit, the held-out loss falls, the NaN step),
    B4 the only kernel (the linears are plain products)."""
    from repro_torch import configs
    layers, steps = STRUCTURE_TRAIN_RUN
    launches = {}
    for v in STRUCTURE_TRAIN:
        cfg = dataclasses.replace(configs.variant(gpt2, v), n_layers=layers)
        launches[f"train:gpt2:{v}"] = timed(
            f"train structure:gpt2-blast:{v}", phase_train, cfg, steps,
            profile=False)
    return launches


def timing_row(kname, linear, T, shape, kern, plain, lib, library, cost,
               flush, **extra):
    bytes_, flops = cost
    t_bytes, t_ops = bound(bytes_, flops)
    row = {"kernel": kname, "linear": linear, "T": T, "shape": shape,
           "ms": time_ms(kern, flush), "plain_ms": time_ms(plain, flush),
           "library_ms": time_ms(lib, flush), "library": library,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "ops_ms": t_ops, "bytes": bytes_,
           "flops": flops,
           **{k: time_ms(f, flush) if callable(f) else f
              for k, f in extra.items()}}
    if "launch_only_ms" in row:     # the quantize prologue and the wrapper
        row["prologue_ms"] = row["ms"] - row["launch_only_ms"]
    emit({"phase": "timing", **row})
    return row


def phase_timing(cfg, llama, hyb, ssm, moe, ds):
    """bf16 timings.  ``ms`` times the wrapper the model calls (for W8A8 and
    W4A8 it includes the per-token quantize prologue; ``launch_only_ms``
    times the kernel alone on ready codes).  Library: ``torch.matmul`` on
    the dense (dequantized) matrix — dense work, not the same
    operations.  llama7b-blast's rows (``arch``): its BLAST shapes, float
    and int8 weights, and B3 over int8 K/V (library: ``dequantize_rows``
    then masked SDPA).  recurrentgemma-2b's: B3 over its 2048-slot ring at
    decode and over [ring ‖ chunk] at C = 32 (library: SDPA with the
    positions' mask), and over the same ring as int8 codes and scales
    (library: ``dequantize_rows``, then that SDPA; ``float_kv_ms``: B3 over
    the bf16 ring)."""
    import torch
    import torch.nn.functional as F
    from repro_torch import quant
    from repro_torch.core import blast as blast_lib
    from repro_torch.kernels import blast_matmul as bm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    dt, dname, elt = torch.bfloat16, "bfloat16", 2
    lib_name = "torch.matmul(x, to_dense(A).T) (dense work)"
    rows = []

    def float_row(name, n, m, b, r, G, T, **kw):
        """B1 (G = 1) or B2 at one shape; returns its inputs."""
        x, U, S, V = make_blast_inputs(n, m, b, r, G, T, dt, gen, DEVICE)
        dense = torch.cat([blast_lib.to_dense(
            blast_lib.BlastParams(U[g], S[g], V[g])) for g in range(G)],
            dim=0)                                       # (G·m, n)
        kname, kern, plain = blast_calls(x, U, S, V, r, ())[0]
        rows.append(timing_row(
            kname, name, T, f"{n}->{m} b={b} r={r} G={G}", kern, plain,
            lambda: torch.matmul(x, dense.T), lib_name,
            blast_cost(n, m, b, r, G, T, elt), flush, **kw))
        return x, U, S, V

    def quant_rows(name, n, m, b, r, G, T, x, U, S, V, modes, **kw):
        """The quantized ``modes`` at one shape, on the codes of U, S, V."""
        shape = f"{n}->{m} b={b} r={r} G={G}"
        xq, sx = quant.quantize_act(x)
        for bits in (8, 4):
            mine = [mode for mode in modes if mode_bits_act(mode)[0] == bits]
            if not mine:
                continue
            codes, scales = quantize_factors(U, S, V, bits=bits)
            su, ss, sv = scales
            ints = [quant.unpack_int4(c, r) if bits == 4 else c
                    for c in codes]
            deq = [a.float() * s_.reshape(*s_.shape,
                                          *(1,) * (a.ndim - s_.ndim))
                   for a, s_ in zip(ints, scales)]
            dense_q = torch.cat([blast_lib.to_dense(blast_lib.BlastParams(
                deq[0][g], deq[1][g], deq[2][g])) for g in range(G)],
                dim=0).to(dt)
            _, stored = bm.padded_rank(codes[0].shape[-1], bits,
                                       bm.float_tiles()[1])
            padded = [ops._pad_last(a, stored) for a in codes]
            launch_act = bm.launch_w4a8 if bits == 4 else bm.launch_w8a8
            for mode in mine:
                qname, kern, plain = quant_calls(mode, x, codes, scales, r)
                extra = dict(kw)
                if mode_bits_act(mode)[1] == "int8":
                    extra["launch_only_ms"] = lambda: launch_act(  # noqa: E731
                        xq, sx, *padded, su, ss, sv, out_dtype=dt)
                rows.append(timing_row(
                    qname, name, T, shape, kern, plain,
                    lambda: torch.matmul(x, dense_q.T), lib_name,
                    blast_cost(n, m, b, r, G, T, elt, mode), flush, **extra))

    for name, n, m, b, r, G in blast_shapes(cfg):
        for T in (8, 256):
            x, U, S, V = float_row(name, n, m, b, r, G, T)
            quant_rows(name, n, m, b, r, G, T, x, U, S, V, QUANT_MODES)
    # the panel path (n past the resident layout), at decode: B1, B5, B7,
    # B9, B10
    label, n, m, b, r = WIDE_BLAST[0]
    x, U, S, V = float_row(label, n, m, b, r, 1, 8, panels=True)
    quant_rows(label, n, m, b, r, 1, 8, x, U, S, V, QUANT_MODES, panels=True)
    for name, n, m, b, r, G in blast_shapes(llama):
        for T in LLAMA_T:
            x, U, S, V = float_row(name, n, m, b, r, G, T, arch=llama.name)
            quant_rows(name, n, m, b, r, G, T, x, U, S, V, ("int8",),
                       arch=llama.name)
    for name, n, m, b, r, G in ssd_blast_shapes(ssm):
        for T in SSM_T:
            x, U, S, V = float_row(name, n, m, b, r, G, T, arch=ssm.name)
            quant_rows(name, n, m, b, r, G, T, x, U, S, V, QUANT_MODES,
                       arch=ssm.name)
    del x, U, S, V
    lq, lkv, ld = llama.n_heads, llama.n_kv_heads, llama.head_dim_
    for C, offsets in ((1, None), (32, None), (1, SERVING_OFFSETS)):
        q, kq, vq, ks, vs, offs = make_q8_inputs(8, lq, lkv, C, 512, ld, dt,
                                                 gen, offsets)
        kw = ({} if offsets is None else
              {"kv_len": fa.kv_bucket(int(offs.max()) + C, 512)})
        kv = kw.get("kv_len", 512)
        qpos = offs[:, None].long() + torch.arange(C, device=DEVICE)[None]
        mask = (torch.arange(kv, device=DEVICE)[None, None]
                <= qpos[:, :, None])[:, None]           # (B, 1, C, kv)
        args = (q, kq, vq, ks, vs, offs)
        kern = lambda: ops.flash_attention_prefill_q8(  # noqa: E731
            *args, **kw)
        plain = lambda: ref.attention_prefill_q8_ref(  # noqa: E731
            *args, **kw)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, quant.dequantize_rows(kq[:, :, :kv], ks[:, :, :kv], dt),
            quant.dequantize_rows(vq[:, :, :kv], vs[:, :, :kv], dt),
            attn_mask=mask, enable_gqa=True)
        want = ref.attention_prefill_q8_ref(*args)
        where = "random" if offsets is None else "serving"
        check_close(f"dequantize+sdpa yardstick C={C} offsets {where}",
                    lib(), want, dname)
        shape = (f"B=8 Hq={lq} Hkv={lkv} C={C} S=512 D={ld} int8 K/V "
                 f"offsets {list(offsets or (0, 512 - C))}"
                 + "".join(f" {k}={v}" for k, v in kw.items()))
        check_close(f"flash_attention_prefill_q8[{shape}]", kern(), want,
                    dname)
        bytes_, flops = attn_cost(q, kq, offs, elt, int8_kv=True)
        # beside it, B3 on bf16 K/V holding the same values (the float
        # cache's kernel at this shape)
        kd, vd = (quant.dequantize_rows(a, sc, dt) for a, sc in
                  ((kq, ks), (vq, vs)))
        rows.append(timing_row(
            "flash_attention_prefill_q8", "attn", 8 * C, shape, kern, plain,
            lib, "dequantize_rows, then scaled_dot_product_attention (masked)",
            (bytes_, {dname: flops}), flush, offsets=where, arch=llama.name,
            float_kv_ms=lambda: ops.flash_attention_prefill(
                q, kd, vd, offs, **kw)))
    rq, rkv, rd, rw = hyb.n_heads, hyb.n_kv_heads, hyb.head_dim_, hyb.window
    for C in RING_CASES:
        q, k, v, kpos, offs = make_ring_inputs(8, rq, rkv, C, rw, rd, dt, gen)
        qpos = offs[:, None].long() + torch.arange(C, device=DEVICE)[None]
        kp = kpos.long()[:, None, :]
        mask = ((kp >= 0) & (kp <= qpos[:, :, None])
                & (kp > qpos[:, :, None] - rw))[:, None]   # (B, 1, C, S_k)
        kern = lambda: ops.flash_attention_ring(  # noqa: E731
            q, k, v, kpos, offs, window=rw)
        plain = lambda: ref.attention_ring_ref(  # noqa: E731
            q, k, v, kpos, offs, window=rw)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
        want = plain()
        shape = f"B=8 Hq={rq} Hkv={rkv} C={C} S_k={k.shape[2]} D={rd} ring"
        check_close(f"ring sdpa yardstick C={C}", lib(), want, dname)
        check_close(f"flash_attention_ring[{shape}]", kern(), want, dname,
                    scaled=True)
        bytes_, flops = ring_cost(q, k, kpos, offs, rw, elt)
        rows.append(timing_row(
            "flash_attention_ring", "attn", 8 * C, shape, kern, plain, lib,
            "scaled_dot_product_attention (mask from the ring's positions, "
            "GQA)", (bytes_, {dname: flops}), flush, arch=hyb.name))
        # the same ring as the int8 cache holds it (its codes and scales)
        args = (q, *ring_q8(k, v), kpos, offs)
        kern = lambda: ops.flash_attention_ring_q8(  # noqa: E731
            *args, window=rw)
        plain = lambda: ref.attention_ring_q8_ref(  # noqa: E731
            *args, window=rw)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, quant.dequantize_rows(args[1], args[3], dt),
            quant.dequantize_rows(args[2], args[4], dt), attn_mask=mask,
            enable_gqa=True)
        want = plain()
        check_close(f"dequantize+ring sdpa yardstick C={C}", lib(), want,
                    dname, scaled=True)
        check_close(f"flash_attention_ring_q8[{shape} int8]", kern(), want,
                    dname, scaled=True)
        bytes_, flops = ring_cost(q, k, kpos, offs, rw, elt, int8_kv=True)
        rows.append(timing_row(
            "flash_attention_ring_q8", "attn", 8 * C, shape + " int8 K/V",
            kern, plain, lib, "dequantize_rows, then "
            "scaled_dot_product_attention (mask from the ring's positions, "
            "GQA)", (bytes_, {dname: flops}), flush, arch=hyb.name,
            float_kv_ms=lambda: ops.flash_attention_ring(
                q, k, v, kpos, offs, window=rw)))
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    for C, offsets in ((1, None), (32, None), (1, SERVING_OFFSETS)):
        q, k, v, offs = make_attn_inputs(8, hq, hkv, C, 512, hd, dt, gen,
                                         DEVICE, offsets)
        # at the serving positions, kv_len as the attention layer passes it
        # (the bucket of its largest live slot + 1); elsewhere the whole
        # cache.  SDPA gets the same key range
        kw = ({} if offsets is None else
              {"kv_len": fa.kv_bucket(int(offs.max()) + C, 512)})
        kv = kw.get("kv_len", 512)
        kc, vc = k[:, :, :kv].contiguous(), v[:, :, :kv].contiguous()
        qpos = offs[:, None].long() + torch.arange(C, device=DEVICE)[None]
        mask = (torch.arange(kv, device=DEVICE)[None, None]
                <= qpos[:, :, None])[:, None]           # (B, 1, C, kv)
        kern = lambda: ops.flash_attention_prefill(  # noqa: E731
            q, k, v, offs, **kw)
        plain = lambda: ref.attention_prefill_ref(  # noqa: E731
            q, k, v, offs, **kw)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kc, vc, attn_mask=mask, enable_gqa=True)
        want = ref.attention_prefill_ref(q, k, v, offs)
        where = "random" if offsets is None else "serving"
        check_close(f"sdpa yardstick C={C} offsets {where}", lib(), want,
                    dname)
        bytes_, flops = attn_cost(q, k, offs, elt)
        shape = (f"B=8 Hq={hq} Hkv={hkv} C={C} S=512 D={hd} offsets "
                 f"{list(offsets or (0, 512 - C))}"
                 + "".join(f" {k}={v}" for k, v in kw.items()))
        check_close(f"flash_attention_prefill[{shape}]", kern(), want, dname)
        rows.append(timing_row(
            "flash_attention_prefill", "attn", 8 * C, shape, kern, plain, lib,
            "scaled_dot_product_attention (masked, GQA)",
            (bytes_, {dname: flops}), flush, offsets=where))
    for B, T in ((8, 256), (1, 2048)):
        q, k, v = make_full_attn_inputs(B, hq, hkv, T, T, hd, dt, gen, DEVICE)
        kern = lambda: ops.flash_attention(q, k, v)  # noqa: E731
        plain = lambda: ref.attention_ref(q, k, v)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
        check_close(f"sdpa yardstick B={B} T={T}", lib(),
                    ref.attention_ref(q, k, v), dname)
        bytes_, flops = full_attn_cost(B, hq, hkv, T, T, hd, elt)
        rows.append(timing_row(
            "flash_attention", "attn", B * T,
            f"B={B} Hq={hq} Hkv={hkv} T={T} D={hd} causal", kern, plain, lib,
            "scaled_dot_product_attention (is_causal, GQA)",
            (bytes_, {dname: flops}), flush))
    # the training step's 2048 tokens: B1 and B2 forward, and B1 launched
    # for a backward pass's dx, on the transposed BLAST matrix (n and m swap)
    T = TRAIN_BATCH * TRAIN_SEQ
    for name, n, m, b, r, G in blast_shapes(cfg):
        float_row(name, n, m, b, r, G, T)
    for name, n, m, b, r, G in blast_shapes(cfg):
        if name not in ("qkv", "down"):
            continue
        _, U, S, V = make_blast_inputs(n, m, b, r, 1, T, dt, gen, DEVICE)
        dy = torch.randn((T, m), generator=gen).to(DEVICE, dt)
        Ut, St, Vt = V[0], S[0].transpose(0, 1).contiguous(), U[0]
        dense = blast_lib.to_dense(blast_lib.BlastParams(Ut, St, Vt))
        rows.append(timing_row(
            "blast_matmul_dx", f"{name} dx", T, f"{m}->{n} b={b} r={r}",
            lambda: ops._blast_dx(dy, U[0], S[0], V[0]),
            lambda: ref.blast_matmul_ref(dy, Ut, St, Vt),
            lambda: torch.matmul(dy, dense.T), lib_name,
            blast_cost(m, n, b, r, 1, T, elt), flush))
    rows += moe_timing_rows(moe, gen, flush)
    rows += ds_timing_rows(ds, flush)
    return rows


def moe_timing_rows(moe, gen, flush) -> list:
    """granite-moe's batched expert kernel at ``wi`` and ``wo``, 32 experts
    at 3 rows each (a decode step of 8 slots: ``T`` 8) and 80 (a 32-token
    chunk over 8 rows: ``T`` 256), bf16, float and the four quantized
    modes: the wrapper (W8A8, W4A8: with the quantize prologue), the plain
    version, and the library yardstick ``torch.bmm`` of each expert's rows
    with its dense bf16 matrix (dense work, not the same operations)."""
    import torch
    from repro_torch.core import blast as blast_lib
    from repro_torch.kernels import ops, ref
    E, dt, elt = moe.moe.n_experts, torch.bfloat16, 2
    out = []
    for name, n, m, b, r in moe_shapes(moe):
        for T, rows in MOE_ROWS.items():
            x, U, S_, V = moe_inputs(n, m, b, r, E, rows, dt, gen)
            dense = torch.stack([blast_lib.to_dense(blast_lib.BlastParams(
                U[g], S_[g], V[g])) for g in range(E)]).transpose(1, 2)
            lib = functools.partial(torch.bmm, x, dense)   # (E, rows, m)
            for kname, kern, plain in batched_calls(x, U, S_, V, r,
                                                    QUANT_MODES):
                mode = next(k for k, v in MOE_BATCHED.items() if v == kname)
                out.append(timing_row(
                    kname, name, T, f"{n}->{m} b={b} r={r} E={E} "
                    f"rows={rows}", kern, plain, lib,
                    "torch.bmm(x, dense experts) (dense work)",
                    blast_cost(n, m, b, r, E, rows, elt, mode, batched=True),
                    flush, arch=moe.name, rows=rows))
            del x, U, S_, V, dense
        # the training step: the forward and the experts' dx (one batched
        # launch over the transposed factors) at its capacity of 640 rows
        rows, T = MOE_TRAIN_ROWS, TRAIN_BATCH * TRAIN_SEQ
        x, U, S_, V = moe_inputs(n, m, b, r, E, rows, dt, gen)
        dense = torch.stack([blast_lib.to_dense(blast_lib.BlastParams(
            U[g], S_[g], V[g])) for g in range(E)])         # (E, m, n)
        dense_t = dense.transpose(1, 2).contiguous()
        out.append(timing_row(
            "blast_matmul_batched", f"{name} train", T,
            f"{n}->{m} b={b} r={r} E={E} rows={rows}",
            lambda: ops.blast_matmul_batched(x, U, S_, V),
            lambda: ref.blast_matmul_batched_ref(x, U, S_, V),
            functools.partial(torch.bmm, x, dense_t),
            "torch.bmm(x, dense experts) (dense work)",
            blast_cost(n, m, b, r, E, rows, elt, batched=True), flush,
            arch=moe.name, rows=rows))
        dy = torch.randn((E, rows, m), generator=gen).to(DEVICE, dt)
        St = S_.transpose(1, 2).contiguous()
        out.append(timing_row(
            "blast_matmul_batched_dx", f"{name} dx", T,
            f"{m}->{n} b={b} r={r} E={E} rows={rows}",
            lambda: ops._batched_launch(dy, V, St, U,
                                        "blast_matmul_batched_dx"),
            lambda: ref.blast_matmul_batched_ref(dy, V, St, U),
            functools.partial(torch.bmm, dy, dense),
            "torch.bmm(dy, dense experts) (dense work)",
            blast_cost(m, n, b, r, E, rows, elt, batched=True), flush,
            arch=moe.name, rows=rows))
        del x, U, S_, V, dense, dense_t, dy, St
    return out


_BLAST_CU = "src/repro_torch/kernels/csrc/blast_matmul.cu"
_ATTN_CU = "src/repro_torch/kernels/csrc/flash_attention.cu"
SMOLLM, LLAMA = "smollm-135m", "llama7b-blast"
SOURCES = {   # kernel → (source, TPU kernel it replaces, run, arch)
    "blast_matmul": (_BLAST_CU, "src/repro/kernels/blast_matmul.py:285",
                     "none", SMOLLM),
    "blast_matmul_grouped": (_BLAST_CU,
                             "src/repro/kernels/blast_matmul.py:324", "none",
                             SMOLLM),
    "blast_matmul_q": (_BLAST_CU, "src/repro/kernels/blast_matmul.py:369",
                       "int8", SMOLLM),
    "blast_matmul_grouped_q": (_BLAST_CU,
                               "src/repro/kernels/blast_matmul.py:475",
                               "int8", SMOLLM),
    "blast_matmul_w8a8": (_BLAST_CU, "src/repro/kernels/blast_matmul.py:633",
                          "w8a8", SMOLLM),
    "blast_matmul_grouped_w8a8": (_BLAST_CU,
                                  "src/repro/kernels/blast_matmul.py:726",
                                  "w8a8", SMOLLM),
    "blast_matmul_q4": (_BLAST_CU, "src/repro/kernels/blast_matmul.py:420",
                        "int4", SMOLLM),
    "blast_matmul_grouped_q4": (_BLAST_CU,
                                "src/repro/kernels/blast_matmul.py:528",
                                "int4", SMOLLM),
    "blast_matmul_w4a8": (_BLAST_CU, "src/repro/kernels/blast_matmul.py:660",
                          "w4a8", SMOLLM),
    "blast_matmul_grouped_w4a8": (_BLAST_CU,
                                  "src/repro/kernels/blast_matmul.py:748",
                                  "w4a8", SMOLLM),
    "flash_attention_prefill": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:155", "none", SMOLLM),
    # B3's int8-K/V instantiation: the reference reads its int8 cache in
    # XLA (src/repro/models/layers.py:423), with no Pallas kernel of its own
    "flash_attention_prefill_q8": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:155",
        "llama:int8_cache:cut", LLAMA),
    "flash_attention": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:98", "train", SMOLLM),
    # B3's ring instantiation: the reference attends over its ring in XLA
    # (src/repro/models/ops.py:133, cache_attention, masked by the ring's
    # pos), beside the Pallas B3 that masks by slot index
    "flash_attention_ring": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:155", "hybrid:float",
        HYBRID),
    # B3's ring instantiation over int8 K/V: the reference reads its int8
    # ring in XLA (src/repro/models/layers.py:433-437, dequantize_rows, then
    # cache_attention by pos)
    "flash_attention_ring_q8": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:155",
        "hybrid:int8_cache", HYBRID),
    # the batched expert kernel (granite-moe's experts, each on its own
    # rows): beyond the Pallas set, the reference runs its experts as a
    # vmapped BLAST in XLA; the tile template of B2 (and B6, B11, B8, B12)
    # with a per-set x stride
    **{kname: (_BLAST_CU, "src/repro/models/moe.py:163 (_expert_ffn, XLA; "
               f"the template of src/repro/kernels/blast_matmul.py:{line})",
               f"moe:{label}", "granite-moe-1b-a400m")
       for kname, label, line in (
           ("blast_matmul_batched", "float", 324),
           ("blast_matmul_batched_q", "int8", 475),
           ("blast_matmul_batched_w8a8", "w8a8", 726),
           ("blast_matmul_batched_q4", "int4", 528),
           ("blast_matmul_batched_w4a8", "w4a8", 748))},
    # MLA's latent attention (deepseek-v3-671b): beyond the Pallas set, the
    # reference runs it in XLA between q_lat and o_lat of mla_prefill
    "mla_attention": ("src/repro_torch/kernels/csrc/mla_attention.cu",
                      "src/repro/models/layers.py:686-702 (mla_prefill, "
                      "XLA; no Pallas kernel)", "deepseek:float",
                      "deepseek-v3-671b"),
}


def summary(rows, errs, launches):
    """One entry per kernel.  Its numbers are one layer's calls of that
    kernel in one decode step (T = 8 slots, C = 1) of its own arch's
    serving run, summed — for B4, which only training runs, one call at the
    training step's shape (B = 8, T = 256); ``cases`` holds every timed
    shape, llama7b-blast's too.  ``launches`` is the count from the run of
    the kernel's own path (its serving mode, or training);
    ``launches_by_run`` has every run's count that is not 0, and B1 and
    the batched expert launch their backward-dx launches
    (``train_dx_launches``: smollm's and granite-moe's training runs,
    timed as the ``blast_matmul_dx`` and ``blast_matmul_batched_dx``
    cases)."""
    out = []
    for kname, (src, replaces, mode, arch) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == kname]
        if kname in ("blast_matmul", "blast_matmul_batched"):
            mine += [r for r in rows if r["kernel"] == f"{kname}_dx"]
        if mode == "train":
            picked = [r for r in mine if r["shape"].startswith("B=8 ")]
            per = "one call at the training shape (B=8, T=256)"
        else:
            picked = [r for r in mine if r["T"] == 8 and not r.get("panels")
                      and r.get("offsets", "random") == "random"
                      and r.get("arch", SMOLLM) == arch]
            per = (f"one {arch} layer's calls in one decode step (T=8; "
                   "attention at random offsets)")
        tot = {k: sum(r[k] for r in picked)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        entry = {"name": kname, "route": "cuda", "source": src,
                 "replaces": replaces, "mode": mode,
                 "launches": launches[mode][kname],
                 "max_abs_err": errs[kname], "ms": tot["ms"],
                 "plain_ms": tot["plain_ms"],
                 "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
                 "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                              else "operations"),
                 "library_ms": tot["library_ms"], "per": per,
                 "launches_by_run": {run: c[kname] for run, c in
                                     launches.items() if c.get(kname)}}
        if kname == "blast_matmul":
            entry["train_dx_launches"] = launches["train"]["blast_matmul_dx"]
        if kname == "blast_matmul_batched":
            entry["train_dx_launches"] = launches[f"train:{MOE}"][
                "blast_matmul_batched_dx"]
        entry["cases"] = [{k: r.get(k, SMOLLM) if k == "arch" else r[k]
                           for k in ("kernel", "arch", "linear", "T", "shape",
                                     "ms", "plain_ms", "library_ms",
                                     "bound_ms", "bound_by")}
                          for r in mine]
        out.append(entry)
    return out


def timed(name, fn, *args, **kw):
    """Run one phase and print its seconds on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    emit({"phase": "seconds", "of": name,
          "seconds": time.perf_counter() - t0})
    return out


def phase_dense_serving(llama, gpt2) -> dict:
    """llama7b-blast at full width (32 layers, vocab 32000, bf16, seeded
    random weights ``LM.init(SEED)``, drawn tensor by tensor) served in its
    three modes from one init (the int8 cache alone and with int8 weights
    at ``LLAMA_CUT_LAYERS`` layers), with each mode's own model (the cache
    mode is the model's): captured = eager greedy tokens, launches steps × (96,
    32, 32) in the mode's kernels, the init's parameter count (before the
    pre-stack) = ``LLAMA_PARAMS``, the int8-cache run's peak memory below
    the float run's at the cut depth; temperature sampling; the decode profile in float and
    with the int8 cache, through the graphs and eagerly.  Then gpt2-blast
    (12 layers, vocab 50257, LayerNorm, learned positions, GELU), float,
    captured = eager.  Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    models = {mode: build_model(dataclasses.replace(
        llama, quant=quant.QuantConfig(cache=LLAMA_MODES[mode][1])),
        device=DEVICE) for mode in ("float", "int8_cache")}
    params = models["float"].init(card_seed())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    init = {"init_params": n_params, "init_bytes": quant.tree_nbytes(params),
            "init_s": init_s}
    if n_params != LLAMA_PARAMS:
        raise RuntimeError(f"llama7b-blast: {n_params} parameters, want "
                           f"{LLAMA_PARAMS}")
    launches, peaks = {}, {}
    launches["llama:float"], _, _ = timed(
        "serve llama:float", phase_serve, models["float"], params,
        "llama:float", serve_config(None, weights="none"),
        llama_per_step(llama, "float"), **init)
    cut, cut_params = cut_models(llama, params, LLAMA_CUT_LAYERS,
                                 {mode: cache for mode, (_, cache)
                                  in LLAMA_MODES.items()})
    # int8 weights with the int8 cache, and paged = slot-static, at the cut
    # depth, for the script's time
    launches["llama:int8_int8_cache"], _, _ = timed(
        "serve llama:int8_int8_cache", phase_serve, cut["int8_int8_cache"],
        cut_params, f"llama:int8_int8_cache:{LLAMA_CUT_LAYERS}L",
        serve_config(None, weights="int8"),
        llama_per_step(cut["int8_int8_cache"].cfg, "int8_int8_cache"))
    for mode in ("float", "int8_cache"):
        # the int8 cache at the cut depth, for the script's time
        launches[f"llama:{mode}:cut"], row, outputs = timed(
            f"serve llama:{mode}:cut", phase_serve, cut[mode], cut_params,
            f"llama:{mode}:{LLAMA_CUT_LAYERS}L",
            serve_config(None, weights="none"),
            llama_per_step(cut[mode].cfg, mode))
        peaks[mode] = row["graphs"]["max_memory_allocated_bytes"]
        launches[f"paged:llama:{mode}"] = timed(
            f"paged llama:{mode}", phase_paged, cut[mode], cut_params,
            f"llama:{mode}", serve_config(None, weights="none"),
            llama_per_step(cut[mode].cfg, mode), (row, outputs))
    if not peaks["int8_cache"] < peaks["float"]:
        raise RuntimeError(f"llama7b-blast: the int8-cache run's peak memory "
                           f"is not below the float run's at "
                           f"{LLAMA_CUT_LAYERS} layers: {peaks}")
    timed("paged prefix llama:float", phase_paged_prefix, cut["float"],
          cut_params, "llama:float", serve_config(None, weights="none"))
    timed("paged preempt llama:float", phase_paged_preempt, cut["float"],
          cut_params, "llama:float", serve_config(None, weights="none"))
    timed("paged preempt llama:fp32", phase_paged_preempt_fp32, llama)
    spec_llama(llama, cut, cut_params)
    timed("temperature", phase_temperature, cut["float"], cut_params)
    for mode in ("float", "int8_cache"):
        for graphs in (True, False):
            timed(f"profile llama:{mode}", retried(phase_profile),
                  cut[mode], cut_params, f"llama:{mode}",
                  serve_config(None, weights="none"), graphs=graphs)
    del cut, cut_params, models, params
    model = build_model(gpt2, device=DEVICE)
    params = model.init(SEED)
    L = gpt2.n_layers
    launches["gpt2:float"], _, _ = timed(
        "serve gpt2:float", phase_serve, model, params, "gpt2:float",
        serve_config("none"),
        {"blast_matmul": 4 * L, "flash_attention_prefill": L},
        init_params=sum(t.numel() for t in leaves(params)))
    return launches


LONG_PROMPTS = (2100, 2600)   # the long run's prompt lengths: past the ring
LONG_MAX_LEN = 4096


def hybrid_per_step(cfg, weights, cache="none") -> dict:
    """Launches a serving step of the hybrid makes: an RG-LRU layer 1 B2
    (in_gate+in_x) and 3 B1 (out, the FFN's wi and wo), an attention layer
    4 B1 (qkv, out, wi, wo) and 1 B3 over its ring (over the int8 cache:
    B3 over the int8 ring); recurrentgemma-2b's 26 layers: 18 B2, 86 B1, 8
    B3 (B5/B6 with int8 weights, B7/B8 with int4)."""
    blast, grouped = MODES[weights if weights in MODES else "none"][1]
    kinds = cfg.layer_kinds()
    rec, att = kinds.count("rglru"), kinds.count("local_attn")
    ring = ("flash_attention_ring_q8" if cache == "int8"
            else "flash_attention_ring")
    return {blast: 3 * rec + 4 * att, grouped: rec, ring: att}


def long_prompts(vocab, n=4):
    """``n`` seeded prompts of ``LONG_PROMPTS`` tokens: each wraps every
    2048-slot ring."""
    import numpy as np
    rng = np.random.default_rng(SEED + 5)
    lo, hi = LONG_PROMPTS
    return [[int(t) for t in rng.integers(0, vocab, size=int(L))]
            for L in rng.integers(lo, hi + 1, size=n)]


RING_KERNELS = ("attn_tile_ring_kernel", "attn_split_combine")


def _annotated(prof, name) -> tuple[int, float]:
    """(kernels, device ms) launched under the ``record_function`` range
    ``name`` in a trace."""
    import torch
    calls, us = 0, 0.0

    def walk(e):
        nonlocal calls, us
        calls += len(e.kernels)
        us += sum(k.duration for k in e.kernels)
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type == torch.autograd.DeviceType.CPU:
            walk(e)
    return calls, us / 1e3


def phase_profile_state(model, params, config, mode, per_step, scan, mark,
                        prompt_len=16, graphs=True, prefill=False):
    """Steady bf16 decode of a model with recurrent state (recurrentgemma-2b:
    ``scan`` the ``rglru`` module; mamba2-130m: ``ssd``): 8 slots after
    prompts of ``prompt_len`` tokens, 6 engine steps timed, 6 more under
    ``torch.profiler``, through the graphs or eagerly (``prefill``: 2 and
    2 of the prompts' 32-token prefill steps instead, after one warm-up
    step; ``prompt_len`` ≥ 5·32): wall, device busy
    and idle share a step, kernel time by name, the launches a step
    (``ops.launches``: ``per_step``), the tile kernel's calls and ms a step
    and, with a ring (the hybrid), the ring kernel's.  Eagerly, the
    recurrence (``scan._scan``) runs under the ``record_function`` range
    ``mark``: its kernels and their device ms a step.  Every BLAST launch
    must run the tile kernel and every attention launch the ring
    kernel.  ``mark`` may also be a dict {function name in ``scan``: range
    name} (granite-moe: the routing and dispatch glue and the experts):
    each function runs under its range, and each range's kernels and ms a
    step are printed; ``scan`` and ``mark`` may be tuples of modules and
    their dicts (deepseek: the MoE glue and MLA's absorbed matrices).  The
    MLA kernel's calls and ms a step are printed where it runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, Request
    pairs = (list(zip(scan, mark)) if isinstance(scan, tuple)
             else [(scan, {"_scan": mark} if isinstance(mark, str)
                    else dict(mark))])
    marks = {name: name_ for _, m in pairs for name, name_ in m.items()}
    inner = {(mod, attr): getattr(mod, attr) for mod, m in pairs
             for attr in m}

    def marked(fn, name):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    if not graphs:
        for mod, m in pairs:
            for attr, name in m.items():
                setattr(mod, attr, marked(inner[mod, attr], name))
    try:
        engine = Engine(model, params, config, device=DEVICE,
                        step_fn=None if graphs else model.prefill_chunk)
        for i in range(8):
            engine.submit(Request(uid=i, prompt=list(range(1, prompt_len + 1)),
                                  max_new_tokens=64))
        n_steps = 2 if prefill else 6
        if prefill and prompt_len < 32 * (1 + 2 * n_steps):
            raise ValueError(f"a prefill profile needs prompts of at least "
                             f"{32 * (1 + 2 * n_steps)} tokens")
        engine.run(max_iters=1 if prefill else -(-prompt_len // 32) + 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run(max_iters=n_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.run(max_iters=n_steps)
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        launched = {k: v / n_steps for k, v in ops.launches.items() if v}
    finally:
        for (mod, attr), fn in inner.items():
            setattr(mod, attr, fn)
    kernels = {k: v for k, v in _device_kernels(prof).items()
               if k not in marks.values()}
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    by_name = tile_blast(kernels)["blast_tile_kernel"]["calls"] > 0
    if launched != per_step:
        raise RuntimeError(f"{mode} decode: launches a step {launched} != "
                           f"{per_step}")
    row = {"phase": "profile", "mode": mode, "arch": model.cfg.name,
           "layers": model.cfg.n_layers,
           "path": "graphs" if graphs else "eager", "prompt_len": prompt_len,
           "step": "prefill (C=32)" if prefill else "decode",
           "steps": n_steps, "slots": 8,
           "graphs": engine.stats["graphs"],
           "launches_per_step": launched,
           "wall_ms_per_step": wall_ms / n_steps,
           "traced_wall_ms_per_step": traced_ms / n_steps,
           "device_busy_ms_per_step": busy / n_steps if kernels else None,
           "device_idle_share": 1 - busy / wall_ms if kernels else None,
           "traced_idle_share": 1 - busy / traced_ms if kernels else None,
           "device_ops_per_step": (sum(v[0] for v in kernels.values())
                                   / n_steps),
           "kernels_by_name": by_name}
    if by_name:
        ring = {}
        for name in RING_KERNELS:
            mine = [v for k, v in kernels.items() if name in k]
            ring[name] = {"calls": sum(v[0] for v in mine) / n_steps,
                          "ms": sum(v[1] for v in mine) / n_steps}
        other = sorted(k for k in kernels if ("attn" in k and not any(
            t in k for t in RING_KERNELS)) or ("blast" in k and not any(
                t in k for t in ("blast_tile_kernel", "blast_split_sum"))))
        want = per_step.get("flash_attention_ring", 0)
        if other or ring[RING_KERNELS[0]]["calls"] != want:
            short = not other and ring[RING_KERNELS[0]]["calls"] < want
            raise (TraceShort if short else RuntimeError)(
                f"{mode} decode: attention did not run the ring kernel "
                f"alone: {ring}, other {other}")
        row["tile_blast_per_step"] = {
            k: ({"calls": v["calls"] / n_steps, "ms": v["ms"] / n_steps}
                if isinstance(v, dict) else v / n_steps)
            for k, v in tile_blast(kernels).items()}
        if "flash_attention_ring" in per_step:
            row["ring_per_step"] = ring
        if "mla_attention" in per_step:
            mine = [v for k, v in kernels.items() if "mla_tile_kernel" in k]
            row["mla_per_step"] = {"calls": sum(v[0] for v in mine) / n_steps,
                                   "ms": sum(v[1] for v in mine) / n_steps}
            calls, want = row["mla_per_step"]["calls"], per_step[
                "mla_attention"]
            if calls != want:
                raise (TraceShort if calls < want else RuntimeError)(
                    f"{mode} decode: the MLA kernel ran {calls} times a "
                    f"step, want {want}")
    if not graphs:
        for name in dict.fromkeys(marks.values()):
            calls, ms = _annotated(prof, name)
            row[f"{name}_per_step"] = {"kernels": calls / n_steps,
                                       "ms": ms / n_steps}
    row["top"] = [{"name": n[:80], "calls_per_step": c / n_steps,
                   "ms_per_step": t / n_steps} for n, (c, t) in top]
    emit(row)
    return row


# depth cut of the hybrid's int4 run and long runs, for the script's time:
# 2 of its 8 cycles
HYBRID_CUT_LAYERS = 6
HYBRID_SPEC_LAYERS = 3    # the bf16 spec run's depth: one cycle
HYBRID_SNAP_SLOTS = 8     # snapshot slots of the prefix-sharing runs
# every hybrid serving run draws the embedding at this fraction of its init
# scale: at init (0.02, times √2560 on the way in) a token's own embedding
# dominates the residual stream, the tied head gives it back, and every
# request repeats its last prompt token whatever the layers compute, so
# that a token comparison would hold for a wrong cache, state or codec,
# and every draft is accepted (acceptance 1.0 at frac 0.5 at init)
HYBRID_EMBED_SCALE = 0.03


def hybrid_weights(params):
    """``params`` with the embedding scaled by ``HYBRID_EMBED_SCALE``, so
    that the layers decide the tokens and a truncated draft is rejected."""
    return {**params, "embed": params["embed"] * HYBRID_EMBED_SCALE}


def varied(outputs, what) -> None:
    """Every request of a hybrid run emitted more than one distinct token
    (at the init's embedding scale each repeats its last prompt token);
    prints the least and the mean count a request."""
    outs = list(outputs.values() if isinstance(outputs, dict) else outputs)
    distinct = [len(set(o)) for o in outs]
    emit({"phase": "varied", "run": what, "requests": len(outs),
          "distinct_tokens_min": min(distinct),
          "distinct_tokens_mean": statistics.mean(distinct)})
    if min(distinct) < 2:
        raise RuntimeError(f"{what}: a request repeats one token: the "
                           "layers did not decide its tokens")


def phase_hybrid(hyb) -> dict:
    """recurrentgemma-2b at full width (26 layers: 8 cycles of rglru, rglru,
    local_attn and a 2-layer RG-LRU tail; d_model 2560, vocab 256000, 10/1
    heads of 256, window 2048; bf16, seeded random weights ``LM.init(SEED)``
    drawn tensor by tensor, 1,419,506,176 params, the embedding scaled by
    ``HYBRID_EMBED_SCALE``) served slot-static with float and (at
    ``HYBRID_CUT_LAYERS`` layers) with int8 weights, each through the
    graphs and eagerly (greedy tokens equal bit
    for bit, launches steps × ``hybrid_per_step``, every request's tokens
    ``varied``): the usual run (``serve_prompts``: 16 prompts of 16–200
    tokens, 32 new, 8 slots, chunk 32, max_len 512) and, at
    ``HYBRID_CUT_LAYERS`` layers for the script's time, a long run that
    wraps every ring (``long_prompts``: 4 prompts of 2,100–2,600 tokens, 32
    new, max_len 4096); then the float decode profile, graphs and eager;
    then the serving modes of ``phase_hybrid_modes`` (``cut``,
    ``cut_params``: the model cut to ``HYBRID_CUT_LAYERS`` layers).
    Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    model = build_model(hyb, device=DEVICE)
    params = hybrid_weights(model.init(card_seed()))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init = {"init_params": n_params, "init_bytes": quant.tree_nbytes(params),
            "init_s": time.perf_counter() - t0,
            "embed_scale": HYBRID_EMBED_SCALE}
    if n_params != HYBRID_PARAMS:
        raise RuntimeError(f"{HYBRID}: {n_params} parameters, want "
                           f"{HYBRID_PARAMS}")
    launches = {}
    long = long_prompts(hyb.vocab)
    cuts, cut_params = cut_models(hyb, params, HYBRID_CUT_LAYERS,
                                  {"none": "none", "int8": "int8"})
    cut = cuts["none"]
    for weights, label in (("none", "float"), ("int8", "int8")):
        mode = f"hybrid:{label}"
        # int8 weights at the cut depth, for the script's time
        serving, serving_params = ((model, params) if weights == "none"
                                   else (cut, cut_params))
        launches[mode], _, outputs = timed(
            f"serve {mode}", phase_serve, serving, serving_params, mode,
            serve_config(None, weights=weights),
            hybrid_per_step(serving.cfg, weights),
            **(init if weights == "none" else {}))
        varied(outputs, f"serve {mode}")
        launches[f"{mode}:long"], _, outputs = timed(
            f"serve {mode}:long", phase_serve, cut, cut_params,
            f"{mode}:long", serve_config(None, weights=weights,
                                         max_len=LONG_MAX_LEN),
            hybrid_per_step(cut.cfg, weights), prompts=long,
            positions_past_window=min(map(len, long)) - hyb.window)
        varied(outputs, f"serve {mode}:long")
    from repro_torch.models import rglru
    # the decode profile at the cut depth, for the script's time
    for graphs in (True, False):
        timed("profile hybrid:float", retried(phase_profile_state), cut,
              cut_params, serve_config(None, weights="none"),
              "hybrid:float", hybrid_per_step(cut.cfg, "none"), rglru,
              "rglru_recurrence", graphs=graphs)
    launches.update(phase_hybrid_modes(hyb, cuts, cut_params))
    return launches


def phase_hybrid_modes(hyb, cuts, cut_params) -> dict:
    """The hybrid in the serving modes ROADMAP A7 completes, bf16 at full
    width, each through ``phase_serve``, ``phase_paged``,
    ``phase_paged_prefix`` or ``phase_spec``, every run's tokens
    ``varied``; ``cuts`` (a model each of the float and the int8 cache)
    and ``cut_params`` (``hybrid_weights``): the model cut to
    ``HYBRID_CUT_LAYERS`` layers, for the script's time:

    - ``hybrid paged`` (cut): at max_len 512 (≤ the window: the rings are
      paged leaves beside the slot-resident RG-LRU state; prefix sharing
      off, ``unshared``) paged = slot-static (a slot-static float run at
      the cut depth) and captured = eager bit for bit; at max_len 4096 (the rings are state leaves, the pool
      nominal): 16 requests sharing a 256-token prefix through snapshot
      slots, ≥ 15·256 prefix-hit tokens, tokens equal the unshared run's
      up to each first near-tie; the same in fp32 at 3 layers and a
      window of 64 (``phase_paged_prefix_hybrid_fp32``);
    - ``hybrid spec`` (``HYBRID_SPEC_LAYERS`` layers; max_len 512,
      prefix sharing off, ``unshared``): k = 4 at frac 0.5, slot-static and paged, drafts
      rejected, tokens equal plain decoding's up to each first near-tie,
      captured = eager and paged = slot-static bit for bit; then fp32 at 3
      layers and a window of 64 (rounds across the rings' wraps, rings as
      state leaves when paged) at frac 0.5 and 1.0: the 1e-4 margin alone,
      acceptance ≥ 0.9 at frac 1.0;
    - ``hybrid int8 cache`` (cut): the int8 cache alone and with int8
      weights, captured = eager bit for bit, launches with B3 over the
      int8 ring; the card against the CPU in fp32 (``phase_reference_hybrid
      (cache="int8")``, in ``main``);
    - ``hybrid:int4`` (cut): int4 weights, captured = eager, launches as
      reckoned.

    Returns each run's launch counts."""
    cut, cut_q8 = cuts["none"], cuts["int8"]
    launches = {}
    float_config = serve_config(None, weights="none")
    _, row, outputs = timed(
        "serve hybrid:float:cut", phase_serve, cut, cut_params,
        f"hybrid:float:{HYBRID_CUT_LAYERS}L", float_config,
        hybrid_per_step(cut.cfg, "none"))
    varied(outputs, "serve hybrid:float:cut")
    launches["paged:hybrid:float"] = timed(
        "paged hybrid:float", phase_paged, cut, cut_params, "hybrid:float",
        unshared(float_config), hybrid_per_step(cut.cfg, "none"),
        (row, outputs))
    for weights, label in (("none", "int8_cache"), ("int8", "int8_int8_cache")):
        mode = f"hybrid:{label}"
        launches[mode], _, outputs = timed(
            f"serve {mode}", phase_serve, cut_q8, cut_params, mode,
            serve_config(None, weights=weights),
            hybrid_per_step(cut.cfg, weights, "int8"))
        varied(outputs, f"serve {mode}")
    launches["hybrid:int4"], _, outputs = timed(
        "serve hybrid:int4", phase_serve, cut, cut_params, "hybrid:int4",
        serve_config(None, weights="int4"), hybrid_per_step(cut.cfg, "int4"))
    varied(outputs, "serve hybrid:int4")
    long = dataclasses.replace(float_config, memory=dataclasses.replace(
        float_config.memory, max_len=LONG_MAX_LEN,
        snap_slots=HYBRID_SNAP_SLOTS))
    varied(timed("paged prefix hybrid:float", phase_paged_prefix, cut,
                 cut_params, "hybrid:float", long),
           "paged prefix hybrid:float")
    timed("paged prefix hybrid:fp32", phase_paged_prefix_hybrid_fp32, hyb)
    spec, spec_params = cut_models(hyb, cut_params, HYBRID_SPEC_LAYERS,
                                   {"none": "none"})
    rows = timed("spec hybrid:float", phase_spec, spec["none"], spec_params,
                 "hybrid:float", unshared(float_config),
                 hybrid_per_step(spec["none"].cfg, "none"),
                 fracs=SPEC_FRACS[:1])
    spec_checks(rows, "hybrid:float")
    timed("spec hybrid:fp32", phase_spec_hybrid_fp32, hyb)
    return launches


def spec_checks(rows, what) -> None:
    """A hybrid speculative phase's first frac (0.5) rejected some drafts,
    so its rounds rolled the verify's cache and state back, and every
    request of its plain run emitted more than one distinct token."""
    g = rows[0]["graphs"]
    if not g["spec_accepted"] < g["spec_drafted"]:
        raise RuntimeError(f"spec {what}: every draft was accepted at frac "
                           f"{SPEC_FRACS[0]}: no rollback of a rejection")
    if rows[0]["distinct_tokens_min"] < 2:
        raise RuntimeError(f"spec {what}: a request repeats one token: the "
                           "layers did not decide its tokens")


def unshared(config):
    """``config`` with prefix sharing off, for the paged and speculative
    runs of a model with state leaves that are held to a slot-static run
    bit for bit: with sharing, a paged engine clips its prefill chunks to
    land on each request's prefix boundary, so its steps are not the
    slot-static run's, and another chunking rounds bf16 otherwise; and the
    draft never sees a shared prefix (ROADMAP C7)."""
    return dataclasses.replace(config, memory=dataclasses.replace(
        config.memory, prefix_sharing=False))


def hybrid_fp32(hyb):
    """(model, params) of recurrentgemma-2b at full width in fp32, cut to 3
    layers (rglru, rglru, local_attn) and a window of 64, the embedding
    scaled by ``HYBRID_EMBED_SCALE``."""
    from repro_torch.models import build_model
    small = dataclasses.replace(hyb, n_layers=3, window=64,
                                param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(small, device=DEVICE)
    return model, hybrid_weights(model.init(SEED))


def phase_paged_prefix_hybrid_fp32(hyb):
    """``phase_paged_prefix`` on ``hybrid_fp32`` at max_len 512 (the
    64-slot rings are state leaves, snapshotted with the RG-LRU state; the
    256-token prefix wraps them four times): in fp32 the tokens are held to
    the unshared run's under the 1e-4 margin alone, so a snapshot restored
    wrong shows."""
    model, params = hybrid_fp32(hyb)
    config = serve_config(None, weights="none")
    config = dataclasses.replace(config, memory=dataclasses.replace(
        config.memory, snap_slots=HYBRID_SNAP_SLOTS))
    varied(phase_paged_prefix(model, params, "hybrid:fp32", config),
           "paged prefix hybrid:fp32")


def phase_spec_hybrid_fp32(hyb):
    """``hybrid_fp32`` speculative at each of ``SPEC_FRACS``, slot-static
    and paged (the 64-slot rings are state leaves there): the serve
    prompts (16–200 tokens) put the rounds past the rings' wraps; the
    tokens are held to the plain engine's under the 1e-4 margin alone,
    frac 0.5 rejects drafts and at frac 1.0 at least 90% of the drafts are
    accepted."""
    model, params = hybrid_fp32(hyb)
    rows = phase_spec(model, params, "hybrid:fp32",
                      unshared(serve_config(None, weights="none")),
                      hybrid_per_step(model.cfg, "none"), eager=False)
    spec_checks(rows, "hybrid:fp32")
    full = rows[SPEC_FRACS.index(1.0)]["graphs"]["acceptance_rate"]
    if full < 0.9:
        raise RuntimeError(f"spec hybrid:fp32: acceptance {full} at frac 1.0")


# -- the ssm family: mamba2-130m ------------------------------------------------

SSM = "mamba2-130m"
SSM_PARAMS = 83_176_896        # the reference's LM.init, eval_shape
SSM_T = (8, 256)               # decode; a prefill step of 8 rows of 32
SSM_CUT_LAYERS = 2             # the fp32 runs' depth
# depth of the quantized and int8-cache serving runs, the bf16 long run,
# speculative run and prefill profile, for the script's time
SSM_SHORT_LAYERS = 6
SSM_SPEC_FRAC = 0.4            # the reference's _SPEC_FRAC["ssd"]
SSM_LONG_PROMPTS = (2000, 3500)
SSM_LONG_CONTEXT = 3000        # the long decode profile's prompts
# mode → (``MODES`` key of its weights and activations, cache)
SSM_MODES = {"float": ("none", "none"), "int8": ("int8", "none"),
             "w8a8": ("w8a8", "none"), "int4": ("int4", "none"),
             "w4a8": ("w4a8", "none"), "int8_cache": ("none", "int8"),
             "int8_int8_cache": ("int8", "int8")}


def ssd_blast_shapes(cfg):
    """(name, n, m, b, r, G) of mamba2-130m's two BLAST launches a layer:
    in_proj (768 → 3352: b = 8, p = 419) and out_proj (1536 → 768)."""
    from repro_torch.models.transformer import make_block
    mx = make_block(cfg, "ssd").mixer
    return [(name, spec.d_in, spec.d_out, spec.meta["b"], spec.meta["r"], 1)
            for name, spec in (("in_proj", mx.in_proj),
                               ("out_proj", mx.out_proj))]


def ssd_per_step(cfg, mode) -> dict:
    """Launches a serving step of mamba2-130m makes with the weights of
    ``MODES[mode]``: in_proj and out_proj, 2 B1 (B5, B7, B9, B10) a layer,
    48 at 24 layers."""
    return {MODES[mode][1][0]: 2 * cfg.n_layers}


def phase_kernels_ssd(ssm, errs) -> None:
    """mamba2-130m's BLAST kernels against their plain versions on the card:
    B1, B5, B7, B9 and B10 at in_proj's shape (b = 8, odd p = 419: the
    epilogue stores column by column) and out_proj's, T = 8 and 256, fp32
    and bf16; two launches of each at T = 8 bit for bit."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 40)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, n, m, b, r, G in ssd_blast_shapes(ssm):
            _, U, S_, V = make_blast_inputs(n, m, b, r, G, 1, dtype, gen,
                                            DEVICE)
            for T in SSM_T:
                x = torch.randn((T, n), generator=gen).to(DEVICE, dtype)
                linear = f"{SSM} {name} {n}->{m} b={b} r={r}"
                for call in blast_calls(x, U, S_, V, r, QUANT_MODES):
                    kname, kern, plain = call
                    if T == SSM_T[0]:
                        repeat_identical(call, linear, T, dname)
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    e = check_close(f"{kname}[{linear} T={T}]",
                                    got.reshape(want.shape), want, dname)
                    if dname == "bfloat16":
                        errs[kname] = max(errs[kname], e)
            del U, S_, V


# mode → (weights, activations, cache) of the reference phase
SSM_REFERENCE = {"float": ("none", "none", "none"),
                 "int8": ("int8", "none", "none"),
                 "w8a8": ("int8", "int8", "none"),
                 "int4": ("int4", "none", "none"),
                 "w4a8": ("int4", "int8", "none"),
                 "int8_cache": ("none", "none", "int8")}


def phase_reference_ssd(ssm):
    """mamba2-130m at full width (d_model 768, vocab 50280, 24 heads of 64,
    d_state 128), fp32, cut to ``SSM_CUT_LAYERS`` layers: card (kernels)
    vs CPU (plain), prompts of 200, 120 and 40 tokens in ragged chunks of
    32, then 4 decode steps (``_prompt_rows``), in each of
    ``SSM_REFERENCE``'s modes from one init: every live logit row within
    1e-3 + 1e-3·max|logit|, every cache leaf (``conv``, ``h`` and their
    scales) within 1e-3 + 1e-3·max|leaf|; the weight codes (int4: packed
    bytes) and scales equal on both; with int8 activations the CPU takes
    the card's activation codes (``SharedActCodes``), with the int8 cache
    its state codes (``SharedRowCodes``, ROADMAP C6), each after checking
    they differ only by boundary flips.  In float also ``LM.apply`` (the
    chunked dual form, chunk 128) against ``prefill_chunk`` (the
    per-token recurrence) on the card over a 200-token prompt, every
    position's logits within the same limit."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    def models(cache):
        small = dataclasses.replace(
            ssm, n_layers=SSM_CUT_LAYERS, param_dtype="float32",
            compute_dtype="float32", quant=quant.QuantConfig(cache=cache))
        return (build_model(small, device=DEVICE),
                build_model(small, device="cpu"))

    built = {"none": models("none")}
    base = built["none"][1].init(SEED)
    for mode, (weights, act, cache) in SSM_REFERENCE.items():
        if cache not in built:
            built[cache] = models(cache)
        gpu, cpu = built[cache]
        qcfg = quant.QuantConfig(weights=weights, activations=act)
        params_cpu = cpu.quantize_params(base, qcfg)
        params_gpu = gpu.quantize_params(
            tree_map(lambda t: t.to(DEVICE), base), qcfg)
        pairs = list(zip(qarrays(params_gpu), qarrays(params_cpu)))
        if any(not (torch.equal(a.q.cpu(), b_.q)
                    and torch.equal(a.scale.cpu(), b_.scale))
               for a, b_ in pairs):
            raise RuntimeError(f"reference[{SSM} {mode}]: codes or scales "
                               "differ between the card and the CPU")
        shared = ([SharedActCodes()] if act == "int8" else []) + (
            [SharedRowCodes()] if cache == "int8" else [])
        err, lim, chunks, _, caches = _prompt_rows(
            gpu, cpu, params_gpu, params_cpu, SEED + 4, act, shared)
        leaves = _leaf_report(*caches)
        past = int((err > lim).sum())
        bad = [k for k, v in leaves.items() if not v["ok"]]
        row = {"phase": "reference", "arch": SSM, "mode": f"mamba2:{mode}",
               "layers": SSM_CUT_LAYERS, "d_model": ssm.d_model,
               "vocab": ssm.vocab, "dtype": "float32", "weights": weights,
               "activations": act, "cache": cache,
               "qarrays_equal": len(pairs),
               "prompt_tokens": list(REFERENCE_PROMPTS), "chunks": chunks,
               "decode_steps": 4, "max_abs_logit_err": float(err.max()),
               "rows": len(err), "rows_past_limit": past,
               "cache_leaves": leaves,
               **{c.CODEC: _codec_report(c) for c in shared},
               "limit": "1e-3 + 1e-3*max|logit| per row"}
        if mode == "float":
            toks = torch.randint(0, ssm.vocab, (2, REFERENCE_PROMPTS[0]),
                                 generator=torch.Generator().manual_seed(
                                     SEED + 5))
            full = gpu.apply(params_gpu, toks.to(DEVICE)).logits
            chunked, _ = gpu.prefill_chunk(
                params_gpu, gpu.init_cache(2, 256), toks,
                torch.zeros(2, dtype=torch.int64), None, all_logits=True)
            d = (full - chunked).abs().amax(dim=-1).flatten()
            limit = 1e-3 + 1e-3 * float(chunked.abs().max())
            row["apply_vs_prefill"] = {"positions": int(d.numel()),
                                       "max_abs_logit_err": float(d.max()),
                                       "limit": limit}
            if float(d.max()) > limit:
                bad.append("apply_vs_prefill")
        emit(row)
        if past or bad:
            raise RuntimeError(f"reference[{SSM} {mode}]: card differs from "
                               f"the CPU plain path: row errors "
                               f"{err.tolist()}, limits {lim.tolist()}, "
                               f"past the limit {bad}")
        del params_gpu, params_cpu


def ssm_long_prompts(vocab, n=4):
    """``n`` seeded prompts of ``SSM_LONG_PROMPTS`` tokens."""
    import numpy as np
    rng = np.random.default_rng(SEED + 6)
    lo, hi = SSM_LONG_PROMPTS
    return [[int(t) for t in rng.integers(0, vocab, size=int(L))]
            for L in rng.integers(lo, hi + 1, size=n)]


def ssm_fp32(ssm):
    """(model, params) of mamba2-130m at full width in fp32, cut to
    ``SSM_CUT_LAYERS`` layers."""
    from repro_torch.models import build_model
    small = dataclasses.replace(ssm, n_layers=SSM_CUT_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    model = build_model(small, device=DEVICE)
    return model, model.init(SEED)


def phase_ssm(ssm) -> dict:
    """mamba2-130m at full width (24 SSD layers, d_model 768, vocab 50280
    tied, bf16, seeded random weights ``LM.init(SEED)``, 83,176,896 params)
    in every serving mode, every run's requests ``varied``:

    - ``serve mamba2:<mode>`` (``SSM_MODES``: float, and at
      ``SSM_SHORT_LAYERS`` layers int8, W8A8, int4, W4A8 weights, the
      int8 cache alone and with int8 weights), 16
      prompts of 16–200 tokens, 32 new, 8 slots, chunk 32, max_len 512:
      captured = eager token for token, launches steps × 48 in the mode's
      kernel, the others 0 (``phase_serve``);
    - ``serve mamba2:float:long`` (``SSM_SHORT_LAYERS`` layers): 4
      prompts of 2,000–3,500 tokens at max_len 4096;
    - ``paged mamba2:float`` (prefix sharing off, ``unshared``: every leaf
      a state leaf, the pool nominal): paged = slot-static bit for bit;
    - ``paged prefix mamba2:float``: 16 requests sharing a 256-token
      prefix with ``Request.prefix_len`` = 256, through snapshot slots:
      ≥ 15·256 hit tokens, tokens equal the unshared run's up to each
      first near-tie; the same in fp32 at ``SSM_CUT_LAYERS`` layers under
      the 1e-4 margin alone;
    - ``spec mamba2:float`` (``SSM_SHORT_LAYERS`` layers): k = 4 at frac
      ``SSM_SPEC_FRAC``, graphs, eager and paged (``phase_spec``, sharing
      off); fp32 at
      ``SSM_CUT_LAYERS`` layers at frac 0.4 and 1.0: the 1e-4 margin,
      acceptance ≥ 0.9 at 1.0;
    - ``profile mamba2:float``: captured decode at context 64 and
      ``SSM_LONG_CONTEXT``; eagerly, decode at 64 and (at
      ``SSM_SHORT_LAYERS`` layers) the 32-token prefill steps of
      160-token prompts, with the state update (``ssd._scan``) under a
      ``record_function`` range.

    Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model, ssd
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    model = build_model(ssm, device=DEVICE)
    params = model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init = {"init_params": n_params, "init_bytes": quant.tree_nbytes(params),
            "init_s": time.perf_counter() - t0}
    if n_params != SSM_PARAMS:
        raise RuntimeError(f"{SSM}: {n_params} parameters, want "
                           f"{SSM_PARAMS}")
    # float at full depth; the other modes at the short depth, for the time
    shorts, short_params = cut_models(ssm, params, SSM_SHORT_LAYERS,
                                      {"none": "none", "int8": "int8"})
    launches = {}
    for label, (mode, cache) in SSM_MODES.items():
        what = f"mamba2:{label}"
        serving, serving_params = ((model, params) if label == "float"
                                   else (shorts[cache], short_params))
        launches[what], row, outputs = timed(
            f"serve {what}", phase_serve, serving, serving_params,
            what if label == "float" else f"{what}:{SSM_SHORT_LAYERS}L",
            serve_config(mode), ssd_per_step(serving.cfg, mode),
            **(init if label == "float" else {}))
        varied(outputs, f"serve {what}")
        if label == "float":
            static = (row, outputs)
    per_step = ssd_per_step(ssm, "none")
    float_config = serve_config("none")
    short = shorts["none"]
    launches["mamba2:float:long"], _, outputs = timed(
        "serve mamba2:float:long", phase_serve, short, short_params,
        f"mamba2:float:long:{SSM_SHORT_LAYERS}L",
        serve_config("none", max_len=LONG_MAX_LEN),
        ssd_per_step(short.cfg, "none"), prompts=ssm_long_prompts(ssm.vocab))
    varied(outputs, "serve mamba2:float:long")
    launches["paged:mamba2:float"] = timed(
        "paged mamba2:float", phase_paged, model, params, "mamba2:float",
        unshared(float_config), per_step, static)
    snap = dataclasses.replace(float_config, memory=dataclasses.replace(
        float_config.memory, snap_slots=HYBRID_SNAP_SLOTS))
    varied(timed("paged prefix mamba2:float", phase_paged_prefix, model,
                 params, "mamba2:float", snap, prefix_len=256),
           "paged prefix mamba2:float")
    small, small_params = ssm_fp32(ssm)
    varied(timed("paged prefix mamba2:fp32", phase_paged_prefix, small,
                 small_params, "mamba2:fp32", snap, prefix_len=256),
           "paged prefix mamba2:fp32")
    rows = timed("spec mamba2:float", phase_spec, short, short_params,
                 f"mamba2:float:{SSM_SHORT_LAYERS}L", unshared(float_config),
                 ssd_per_step(short.cfg, "none"), fracs=(SSM_SPEC_FRAC,))
    spec_checks(rows, "mamba2:float")
    rows = timed("spec mamba2:fp32", phase_spec, small, small_params,
                 "mamba2:fp32", unshared(float_config),
                 ssd_per_step(small.cfg, "none"), paged=False, eager=False,
                 fracs=(SSM_SPEC_FRAC, 1.0))
    spec_checks(rows, "mamba2:fp32")
    if rows[1]["graphs"]["acceptance_rate"] < 0.9:
        raise RuntimeError(f"spec mamba2:fp32: acceptance "
                           f"{rows[1]['graphs']['acceptance_rate']} at frac "
                           "1.0")
    del small, small_params
    for graphs, context, prefill in ((True, 64, False),
                                     (True, SSM_LONG_CONTEXT, False),
                                     (False, 64, False), (False, 160, True)):
        # the eager prefill profile at the short depth, for the time
        prof, prof_params = ((short, short_params) if prefill
                             else (model, params))
        timed("profile mamba2:float", retried(phase_profile_state), prof,
              prof_params, serve_config("none", max_len=LONG_MAX_LEN),
              "mamba2:float",
              ssd_per_step(prof.cfg, "none"), ssd, "ssd_state_update",
              prompt_len=context, graphs=graphs, prefill=prefill)
    return launches


# -- the moe family: granite-moe-1b-a400m ---------------------------------------

MOE = "granite-moe-1b-a400m"
MOE_PARAMS = 682_381_312      # the reference's LM.init, eval_shape
# rows a layer's batched expert launch gives each of the 32 experts: the
# capacity ceil(Tl·k·cf/E) of a decode step of 8 slots (Tl = 8) and of a
# 32-token chunk over 8 rows (Tl = 256), at k = 8, cf = 1.25
MOE_ROWS = {8: 3, 256: 80}
# rows of every expert in a training step: the capacity at batch 8 × 256
MOE_TRAIN_ROWS = 640
MOE_DROPLESS = 8.0            # benchmarks/serving_throughput.py:246-257
# the reference, the fp32 runs and the bf16 dropless preemption and
# speculative runs
MOE_FP32_LAYERS = 2
# depth of the quantized-weight serving runs, the paged run and the decode
# profile, for the script's time
MOE_CUT_LAYERS = 4
ROUTE_TIE = 1e-5              # SharedRouting's near-tie limit
# mode → (``MODES`` key of its weights and activations, cache)
MOE_MODES = {"float": ("none", "none"), "int8": ("int8", "none"),
             "w8a8": ("w8a8", "none"), "int4": ("int4", "none"),
             "w4a8": ("w4a8", "none"), "int8_cache": ("none", "int8")}
# the batched expert launch's key in ``ops.launches`` per ``MODES`` key
MOE_BATCHED = {"none": "blast_matmul_batched",
               "int8": "blast_matmul_batched_q",
               "w8a8": "blast_matmul_batched_w8a8",
               "int4": "blast_matmul_batched_q4",
               "w4a8": "blast_matmul_batched_w4a8"}
# the routing and dispatch glue and the experts, each under its range in
# the eager profile (``phase_profile_state``)
MOE_MARKS = {"_route": "moe_route", "_dispatch_indices": "moe_dispatch",
             "_gather": "moe_gather", "_expert_ffn": "moe_experts",
             "_combine": "moe_combine"}
# every granite-moe serving run draws its attention's out projection at
# this fraction of its init scale: at init each layer's attention averages
# its context almost uniformly and its output (~4× the experts') sets the
# residual stream, so a request's hidden state moves by ~1/T a token and
# every request repeats one token whatever its experts compute (1–2.4
# distinct tokens of 32 a request, the embedding scaled ×0.1 to ×30 or
# not); at 0.3 the per-token expert path decides the tokens (≥ 27 of 32;
# ``scripts/moe_init_tokens.py``)
MOE_ATTN_OUT_SCALE = 0.3
# In bf16 a batch shape other than the plain run's (a verify chunk, a
# resumed request's chunks) rounds the residual stream otherwise, and at
# 24 layers that re-routes 1,700–1,900 of a 100-token prompt's 2,400 expert
# choices (gaps up to 0.007 between the k-th and (k+1)-th probability)
# and moves its last logits by 0.46–1.75; in fp32 0–1 (gaps ≤ 5.4e-7,
# logits 2e-5; ``scripts/moe_routing_flips.py``).  So the bf16 speculative and preemption runs report their
# tokens against the plain run's, and the fp32 runs at
# ``MOE_FP32_LAYERS`` layers gate them under the 1e-4 margin.


def moe_shapes(cfg):
    """(name, n, m, b, r) of granite-moe's two expert linears: ``wi`` (1024
    → 1024, gate ‖ up) and ``wo`` (512 → 1024), b = 16."""
    from repro_torch.models.moe import make_moe
    spec = make_moe(cfg)
    return [(name, lin.d_in, lin.d_out, lin.meta["b"], lin.meta["r"])
            for name, lin in (("wi", spec.wi), ("wo", spec.wo))]


def moe_per_step(cfg, mode, cache="none") -> dict:
    """Launches a serving step of granite-moe makes with the weights of
    ``MODES[mode]``: a layer's qkv and out (2 B1, B5, B7, B9 or B10), its
    experts' wi and wo (2 batched launches) and B3 by key position (over
    the int8 cache: its int8-K/V instantiation); 48 + 48 + 24 at 24
    layers."""
    L = cfg.n_layers
    attn = ("flash_attention_ring_q8" if cache == "int8"
            else "flash_attention_ring")
    return {MODES[mode][1][0]: 2 * L, MOE_BATCHED[mode]: 2 * L, attn: L}


def batched_calls(x, U, S, V, r, modes):
    """(kernel name, kernel call, plain call) of the batched expert launch
    (x (E, T, n): each expert on its own rows) in float and in the
    quantized ``modes``, on the stacked factors' per-expert codes."""
    from repro_torch import quant
    from repro_torch.kernels import ops, ref
    calls = [("blast_matmul_batched",
              lambda: ops.blast_matmul_batched(x, U, S, V),
              lambda: ref.blast_matmul_batched_ref(x, U, S, V))]
    for mode in modes:
        bits, act = mode_bits_act(mode)
        (Uc, Sc, Vc), scales = quantize_factors(U, S, V, bits=bits)
        kern_fn = (ops.blast_matmul_batched_q4 if bits == 4
                   else ops.blast_matmul_batched_q)
        kern = functools.partial(kern_fn, x, Uc, Sc, Vc, *scales, act=act)
        if act == "int8":
            plain_a8 = (ref.blast_matmul_batched_a4_ref if bits == 4
                        else ref.blast_matmul_batched_a8_ref)

            def plain(plain_a8=plain_a8, codes=(Uc, Sc, Vc), scales=scales):
                xq, sx = quant.quantize_act(x)    # the wrapper's prologue
                return plain_a8(xq, sx, *codes, *scales).to(x.dtype)
        else:
            plain = functools.partial(
                ref.blast_matmul_batched_q4_ref if bits == 4
                else ref.blast_matmul_batched_q_ref, x, Uc, Sc, Vc, *scales)
        calls.append((MOE_BATCHED[mode], kern, plain))
    return calls


def moe_inputs(n, m, b, r, E, rows, dtype, gen):
    """x (E, rows, n) with each expert's last row zero (an empty capacity
    slot), and E stacked factor sets."""
    x, U, S, V = make_blast_inputs(n, m, b, r, E, E * rows, dtype, gen,
                                   DEVICE)
    x = x.reshape(E, rows, n)
    x[:, -1] = 0
    return x, U, S, V


def phase_kernels_moe(moe, errs) -> None:
    """The batched expert kernel against its plain version on the card at
    granite-moe's ``wi`` and ``wo`` shapes, E = 32 experts, 3 rows each
    (decode) and 80 (a chunk), fp32 and bf16, in the five storages (float,
    int8, W8A8, int4, W4A8; each kernel and its plain version get the same
    activation codes); two launches of each at 3 rows bit for bit."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 50)
    E = moe.moe.n_experts
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, n, m, b, r in moe_shapes(moe):
            for rows in MOE_ROWS.values():
                x, U, S_, V = moe_inputs(n, m, b, r, E, rows, dtype, gen)
                linear = f"{MOE} {name} {n}->{m} b={b} r={r} E={E}"
                for call in batched_calls(x, U, S_, V, r, QUANT_MODES):
                    kname, kern, plain = call
                    if rows == MOE_ROWS[8]:
                        repeat_identical(call, linear, rows, dname)
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    e = check_close(f"{kname}[{linear} rows={rows}]", got,
                                    want, dname)
                    if dname == "bfloat16":
                        errs[kname] = max(errs[kname], e)
                del x, U, S_, V


class SharedRouting:
    """While active, the router's top-k (``models/moe.py::_top_k``) records
    each call's expert ids on the card, and the CPU run that follows takes
    the card's ids call by call, with its own probabilities at them as
    gates — after checking that its own ids differ from the card's only at
    near-ties: in every token whose k ids (in order) differ, two of its k +
    1 largest probabilities lie within ``ROUTE_TIE`` of each other.  A fp32
    summation-order difference of ~1e-7 upstream swaps two such experts,
    and one changed id moves every later position in its expert; sharing
    the ids keeps one swap from hiding, or being taken for, a fault
    elsewhere on the path."""

    def __init__(self):
        self.card: list = []
        self.recording = True
        self.calls = self.tokens = self.flips = 0
        self.max_gap = 0.0

    def __enter__(self):
        from repro_torch.models import moe
        self.real = real = moe._top_k

        def shared(probs, k):
            vals, idx = real(probs, k)
            if self.recording:
                self.card.append(idx)
                return vals, idx
            card = self.card.pop(0).cpu()
            self.check(probs, idx, card, k)
            return probs.gather(-1, card), card

        moe._top_k = shared
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._top_k = self.real
        if exc[0] is None and self.card:
            raise RuntimeError(f"{len(self.card)} card routing calls had no "
                               "CPU counterpart")

    def check(self, probs, idx, card, k):
        import torch
        differ = (idx != card).any(dim=-1)
        if bool(differ.any()):
            top = torch.sort(probs[differ], dim=-1,
                             descending=True).values[:, :k + 1]
            gap = float((top[:, :-1] - top[:, 1:]).amin(dim=-1).max())
            if gap > ROUTE_TIE:
                raise RuntimeError(f"expert ids differ between the card and "
                                   f"the CPU past a near-tie: gap {gap}")
            self.max_gap = max(self.max_gap, gap)
        self.calls += 1
        self.tokens += idx.shape[0]
        self.flips += int(differ.sum())


# mode → (weights, activations, cache) of the reference phase
MOE_REFERENCE = {"float": ("none", "none", "none"),
                 "int8": ("int8", "none", "none"),
                 "w8a8": ("int8", "int8", "none"),
                 "int8_cache": ("none", "none", "int8")}


def phase_reference_moe(moe):
    """granite-moe at full width (d_model 1024, vocab 49155, 32 experts
    top-8 of 512, capacity 1.25), fp32, cut to ``MOE_FP32_LAYERS`` layers:
    card (kernels) vs CPU (plain) over three ragged chunks of 16 with idle
    rows and dead columns (``_reference_rows``: every one of the 48 tokens
    a step routed, capacity 15), and ``LM.apply`` over 2 × 48 tokens
    (logits and ``aux``), in each of ``MOE_REFERENCE``'s modes from one
    init: every live logit row within 1e-3 + 1e-3·max|logit|, ``aux``
    within 1e-5 relative; the weight codes and scales equal on both.  The
    CPU takes the card's expert ids (``SharedRouting``, after checking that
    its own differ only at near-ties), with int8 activations the card's
    activation codes (``SharedActCodes``) and with the int8 cache its K/V
    rows (``SharedRowCodes``), each after its own check; every cache leaf
    ends equal where the cache is int8."""
    import contextlib
    import torch
    from repro_torch import quant
    from repro_torch.core import structures
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    def models(cache):
        small = dataclasses.replace(
            moe, n_layers=MOE_FP32_LAYERS, param_dtype="float32",
            compute_dtype="float32", quant=quant.QuantConfig(cache=cache))
        return (build_model(small, device=DEVICE),
                build_model(small, device="cpu"))

    built = {"none": models("none")}
    base = built["none"][1].init(SEED)
    toks = torch.randint(0, moe.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(SEED + 7))
    for mode, (weights, act, cache) in MOE_REFERENCE.items():
        if cache not in built:
            built[cache] = models(cache)
        gpu, cpu = built[cache]
        qcfg = quant.QuantConfig(weights=weights, activations=act)
        params_cpu = cpu.quantize_params(base, qcfg)
        params_gpu = gpu.quantize_params(
            tree_map(lambda t: t.to(DEVICE), base), qcfg)
        pairs = list(zip(qarrays(params_gpu), qarrays(params_cpu)))
        if any(not (torch.equal(a.q.cpu(), b_.q)
                    and torch.equal(a.scale.cpu(), b_.scale))
               for a, b_ in pairs):
            raise RuntimeError(f"reference[{MOE} {mode}]: codes or scales "
                               "differ between the card and the CPU")
        routing = SharedRouting()
        shared = [routing] + ([SharedActCodes()] if act == "int8" else []) + (
            [SharedRowCodes()] if cache == "int8" else [])
        err, lim, caches = _reference_rows(gpu, cpu, params_gpu, params_cpu,
                                           act, shared)
        with structures.activations(act), contextlib.ExitStack() as stack:
            for codec in shared[:2 if act == "int8" else 1]:
                stack.enter_context(codec)
                codec.recording = True
            out_g = gpu.apply(params_gpu, toks.to(DEVICE))
            for codec in shared:
                codec.recording = False
            out_c = cpu.apply(params_cpu, toks)
        a_err = (out_g.logits.float().cpu() - out_c.logits).abs().amax(
            dim=-1).flatten()
        a_lim = 1e-3 + 1e-3 * float(out_c.logits.abs().max())
        aux_g, aux_c = float(out_g.aux), float(out_c.aux)
        aux_rel = abs(aux_g - aux_c) / abs(aux_c)
        bad = []
        if cache == "int8":
            bad = [f"{i}.{n}" for i, (c_g, c_c) in enumerate(zip(*caches))
                   for n, leaf in c_g.items()
                   if not torch.equal(leaf.cpu(), c_c[n])]
        past = int((err > lim).sum()) + int((a_err > a_lim).sum())
        emit({"phase": "reference", "arch": MOE, "mode": f"moe:{mode}",
              "layers": MOE_FP32_LAYERS, "d_model": moe.d_model,
              "vocab": moe.vocab, "experts": moe.moe.n_experts,
              "top_k": moe.moe.top_k, "dtype": "float32", "weights": weights,
              "activations": act, "cache": cache, "chunks": 3,
              "qarrays_equal": len(pairs),
              "max_abs_logit_err": float(err.max()), "rows": len(err),
              "apply_max_abs_logit_err": float(a_err.max()),
              "apply_positions": int(a_err.numel()), "apply_limit": a_lim,
              "rows_past_limit": past, "aux_card": aux_g, "aux_cpu": aux_c,
              "aux_rel_err": aux_rel,
              "routing": {"calls": routing.calls, "tokens": routing.tokens,
                          "tokens_with_swapped_experts": routing.flips,
                          "max_gap_at_swaps": routing.max_gap,
                          "near_tie_limit": ROUTE_TIE},
              **{c.CODEC: _codec_report(c) for c in shared[1:]},
              "cache_leaves_equal": not bad if cache == "int8" else None,
              "limit": "1e-3 + 1e-3*max|logit| per row; aux 1e-5 relative"})
        if past or aux_rel > 1e-5 or bad:
            raise RuntimeError(f"reference[{MOE} {mode}]: card differs from "
                               f"the CPU plain path: row errors "
                               f"{err.tolist()}, limits {lim.tolist()}, apply "
                               f"{float(a_err.max())} (limit {a_lim}), aux "
                               f"{aux_g} vs {aux_c}, leaves {bad}")
        del params_gpu, params_cpu


def moe_weights(params):
    """``params`` with every attention out projection's U scaled by
    ``MOE_ATTN_OUT_SCALE``, so that the per-token path decides the
    tokens."""
    def layer(p):
        out = p["mixer"]["out"]
        return {**p, "mixer": {**p["mixer"], "out": {
            **out, "U": out["U"] * MOE_ATTN_OUT_SCALE}}}
    return {**params, "layers": [layer(p) for p in params["layers"]]}


def dropless(cfg):
    """``cfg`` with capacity past every assignment (``MOE_DROPLESS``): no
    token's output depends on the other tokens of its step."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DROPLESS))


def phase_moe(moe) -> dict:
    """granite-moe-1b-a400m at full width (24 layers, d_model 1024, 16/8
    heads of 64, 32 experts top-8 of 512, capacity 1.25, vocab 49155 tied,
    bf16, seeded random weights ``LM.init(SEED)``, 682,381,312 params, the
    attention's out projections scaled by ``MOE_ATTN_OUT_SCALE``) in every
    serving mode, every run's requests ``varied``:

    - ``serve moe:<mode>`` (``MOE_MODES``: float at full depth; the int8
      cache and int8, W8A8, int4 and W4A8 weights at ``MOE_CUT_LAYERS``
      layers), 16 prompts of 16–200 tokens, 32 new, 8 slots, chunk 32,
      max_len 512: captured = eager token for token, launches steps ×
      ``moe_per_step`` in the mode's kernels, the others 0
      (``phase_serve``);
    - dropless (``MOE_DROPLESS``), where other batch shapes change no
      token's routing by capacity: ``paged prefix moe:dropless`` (16
      requests sharing a 256-token prefix; its steps have the plain run's
      shapes) held to its plain run up to each first near-tie;
    - at ``MOE_CUT_LAYERS`` layers, for the script's time: ``paged
      moe:float``, paged = slot-static bit for bit at the default capacity
      (the same (B, C) steps, so the same routing); at
      ``MOE_FP32_LAYERS``: ``paged preempt moe:dropless`` and ``spec
      moe:dropless`` (k = 4 at frac 0.5, graphs, eager and paged: captured
      = eager and paged = slot-static bit for bit), their tokens against
      the plain run's reported (other batch shapes re-route bf16 tokens:
      ``MOE_ATTN_OUT_SCALE``'s note);
    - ``paged preempt moe:fp32`` and ``spec moe:fp32`` at
      ``MOE_FP32_LAYERS`` layers, frac 0.5 and 1.0, gated under the 1e-4
      margin (acceptance ≥ 0.9 at 1.0);
    - ``profile moe:float`` (``MOE_CUT_LAYERS`` layers): captured and
      eager decode (8 slots after 16-token prompts), eagerly with the
      routing, dispatch, gather, experts and combine each under a
      ``record_function`` range.

    Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model, moe as moe_lib
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    model = build_model(moe, device=DEVICE)
    params = moe_weights(model.init(card_seed()))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    init = {"init_params": n_params, "init_bytes": quant.tree_nbytes(params),
            "init_s": time.perf_counter() - t0,
            "attn_out_scale": MOE_ATTN_OUT_SCALE}
    if n_params != MOE_PARAMS:
        raise RuntimeError(f"{MOE}: {n_params} parameters, want "
                           f"{MOE_PARAMS}")
    cuts, cut_params = cut_models(moe, params, MOE_CUT_LAYERS,
                                  {"none": "none", "int8": "int8"})
    cut = cuts["none"]
    launches = {}
    for label, (mode, cache) in MOE_MODES.items():
        what = f"moe:{label}"
        # float at full depth; the int8 cache and the quantized weights at
        # the cut depth, for the script's time
        full = label == "float"
        serving, serving_params = ((model, params) if full
                                   else (cuts[cache], cut_params))
        launches[what], _, outputs = timed(
            f"serve {what}", phase_serve, serving, serving_params,
            what if full else f"{what}:{MOE_CUT_LAYERS}L",
            serve_config(mode), moe_per_step(serving.cfg, mode, cache),
            **(init if full else {}))
        varied(outputs, f"serve {what}")
    del cuts["int8"]
    config = serve_config("none")
    free = build_model(dropless(moe), device=DEVICE)
    varied(timed("paged prefix moe:dropless", phase_paged_prefix, free,
                 params, "moe:dropless", config),
           "paged prefix moe:dropless")
    del free
    cut_step = moe_per_step(cut.cfg, "none")
    static = timed("serve moe:float:cut", phase_serve, cut, cut_params,
                   f"moe:float:{MOE_CUT_LAYERS}L", config, cut_step)[1:]
    launches["paged:moe:float"] = timed(
        "paged moe:float", phase_paged, cut, cut_params, "moe:float", config,
        cut_step, static)
    # bf16: tokens reported against the plain run's (MOE_ATTN_OUT_SCALE's
    # note); the fp32 runs below gate them.  At ``MOE_FP32_LAYERS``
    # layers, for the script's time
    free = build_model(dropless(dataclasses.replace(
        moe, n_layers=MOE_FP32_LAYERS)), device=DEVICE)
    free_params = {**params, "layers": params["layers"][:MOE_FP32_LAYERS]}
    varied(timed("paged preempt moe:dropless", phase_paged_preempt, free,
                 free_params, "moe:dropless", config, gate_tokens=False),
           "paged preempt moe:dropless")
    rows = timed("spec moe:dropless", phase_spec, free, free_params,
                 "moe:dropless", config, moe_per_step(free.cfg, "none"),
                 fracs=SPEC_FRACS[:1], gate_tokens=False)
    spec_checks(rows, "moe:dropless")
    # the decode profile at the cut depth too, for the script's time
    for graphs in (True, False):
        timed("profile moe:float", retried(phase_profile_state), cut,
              cut_params, config, "moe:float", cut_step, moe_lib, MOE_MARKS,
              graphs=graphs)
    del free, free_params, cuts, cut, cut_params
    small = build_model(dropless(dataclasses.replace(
        moe, n_layers=MOE_FP32_LAYERS, param_dtype="float32",
        compute_dtype="float32")), device=DEVICE)
    small_params = moe_weights(small.init(SEED))
    varied(timed("paged preempt moe:fp32", phase_paged_preempt, small,
                 small_params, "moe:fp32", config), "paged preempt moe:fp32")
    rows = timed("spec moe:fp32", phase_spec, small, small_params,
                 "moe:fp32", config, moe_per_step(small.cfg, "none"),
                 paged=False, eager=False)
    spec_checks(rows, "moe:fp32")
    if rows[1]["graphs"]["acceptance_rate"] < 0.9:
        raise RuntimeError(f"spec moe:fp32: acceptance "
                           f"{rows[1]['graphs']['acceptance_rate']} at frac "
                           "1.0")
    del small, small_params
    return launches


DEEPSEEK = "deepseek-v3-671b"
# depth of the float serving run (dense first layers, MoE layers: ≈ 28 GB of
# bf16 params) and of every other deepseek run and the reference, for the
# card's 80 GB and the script's time; full width always
DS_SERVE = (3, 2)
DS_CUT = (1, 1)
DS_PROMPTS = 8           # requests of a deepseek serving run (8 slots)
DS_NEW = 16              # new tokens a request, for the script's time
# rows a set of the batched expert kernel checks: a decode step's capacity,
# ceil(8·8·1.25/256) = 1, and about a dropless 8-token chunk's per expert
DS_ROWS = (1, 40)
# capacity ≥ every assignment (Tl ≤ C): a factor of E / top_k = 32; the
# reference benchmark's 8 gives 2 rows a decode step, not dropless at 256
# experts
DS_DROPLESS = 32.0
DS_SPEC_FRAC = 0.7       # benchmarks/serving_throughput.py: _SPEC_FRAC["mla"]
# the fp32 speculative run's requests: a fp32 round at 1 + 1 layers takes
# ~1.5 s (its 256 experts' factors are 22 GB, read by every launch)
DS_FP32_PROMPTS = 4
DS_SPEC_PROMPT = 32      # the speculative runs' prompt tokens: one chunk
# MLA kernel cases (B = 8, 128 heads, S = 512): (C, offsets, options) —
# anywhere; the last slot; dead columns (rows of 0 to C live tokens, their
# unwritten slots empty) with an empty row; kv_len < S with live-looking
# positions past it
MLA_CASES = [(1, None, {}), (32, None, {}), (1, (511, 511), {}),
             (32, None, {"dead": True}), (20, (0, 200), {"kv_len": 256})]
MLA_MARKS = {"_absorbed": "mla_absorb"}


def ds_config(ds, dense, moe_layers, **over):
    """deepseek-v3-671b at full width cut to ``dense`` first dense layers
    and ``moe_layers`` MoE layers; ``over`` replaces config fields."""
    return dataclasses.replace(
        ds, n_layers=dense + moe_layers,
        moe=dataclasses.replace(ds.moe, first_dense_layers=dense), **over)


def ds_cut_params(params, dense):
    """The cut model's layers, shared with the ``DS_SERVE`` run's: its
    first ``dense`` dense layers and its first MoE layer."""
    layers, first_moe = params["layers"], DS_SERVE[0]
    return {**params, "layers": layers[:dense] + [layers[first_moe]]}


def ds_per_step(cfg, mode) -> dict:
    """Launches a serving step of deepseek makes in ``MODES[mode]``: every
    layer B2 for ``wq_a`` + ``wkv_a`` and for its FFN's gate+up (the dense
    FFN or the shared expert), B1 for ``wq_b``, ``out``, the FFN's ``wo``
    and ``wkv_b``'s densification (T = 512), the MLA kernel; a MoE layer
    also its experts' ``wi`` and ``wo`` (two batched launches).  The int8
    cache changes none: its latent is dequantized and read by the same
    kernel."""
    blast, grouped = MODES[mode][1]
    L, moe_layers = cfg.n_layers, cfg.n_layers - cfg.moe.first_dense_layers
    return {blast: 4 * L, grouped: 2 * L, "mla_attention": L,
            MOE_BATCHED[mode]: 2 * moe_layers}


def ds_blast_shapes(cfg):
    """(name, n, m, b, r, G, T) of deepseek's B1 and B2 launches: the MLA
    projections (``wq_a`` + ``wkv_a`` grouped, padded to 1536 outputs and
    the larger rank), ``wkv_b``'s densification (T = 512 identity rows),
    the shared expert's and the dense FFN's; T = 8 a decode step."""
    from repro_torch.models import layers as L
    from repro_torch.models.mla import make_mla
    from repro_torch.models.moe import make_moe
    mla, moe = make_mla(cfg), make_moe(cfg)
    dense = L.make_ffn(cfg.d_model, cfg.moe.dense_d_ff, cfg.ffn_kind,
                       cfg.ffn_structure)
    r = lambda s: s.meta["r"]        # noqa: E731
    out = [("wq_a+wkv_a", cfg.d_model, mla.wq_a.d_out, mla.wq_a.meta["b"],
            max(r(mla.wq_a), r(mla.wkv_a)), 2, 8)]
    for name, s, G, T in (("wq_b", mla.wq_b, 1, 8), ("out", mla.out, 1, 8),
                          ("wkv_b dense", mla.wkv_b, 1, 512),
                          ("shared gate+up", moe.shared.gate, 2, 8),
                          ("shared wo", moe.shared.wo, 1, 8),
                          ("dense gate+up", dense.gate, 2, 8),
                          ("dense wo", dense.wo, 1, 8)):
        out.append((name, s.d_in, s.d_out, s.meta["b"], r(s), G, T))
    return out


def make_mla_inputs(B, C, H, S, dtype, gen, offsets=None, dead=False,
                    kv_len=None):
    """q_lat (B, C, H, 512), q_rope (B, C, H, 64), the cache leaves latent
    (B, S, 512) and k_rope (B, S, 64) as [:, :S] views of spare-slot
    buffers, each slot's position (B, S) int32 — slot j holds position j up
    to the row's last live token, -1 past it — the rows' offsets and the
    kv_len a step passes (its bucket).  ``dead``: rows of 0 to C live
    tokens, row 0 empty (every slot -1: its queries see no key, and read
    0).  ``kv_len``: the slots past it hold live-looking positions, which
    the kernel must not read."""
    import torch
    from repro_torch.kernels.flash_attention import kv_bucket
    lo, hi = offsets or (0, S - C)
    dev = dict(device=DEVICE)
    q_lat = torch.randn((B, C, H, 512), generator=gen, **dev).to(dtype)
    q_rope = torch.randn((B, C, H, 64), generator=gen, **dev).to(dtype)
    latent = torch.randn((B, S + 1, 512), generator=gen, **dev).to(
        dtype)[:, :S]
    k_rope = torch.randn((B, S + 1, 64), generator=gen, **dev).to(
        dtype)[:, :S]
    offs = torch.randint(lo, hi + 1, (B,), generator=gen, **dev)
    n = (torch.randint(0, C + 1, (B,), generator=gen, **dev) if dead
         else torch.full((B,), C, **dev))
    slots = torch.arange(S, **dev)[None]
    pos = torch.where(slots < (offs + n)[:, None], slots, -1)
    if dead:
        pos[0] = -1
    need = int((offs + n).max())
    kv = kv_bucket(need, S) if kv_len is None else kv_len
    if kv_len is not None:
        pos[:, kv_len:] = slots[:, kv_len:]
    return (q_lat, q_rope, latent, k_rope, pos.to(torch.int32).contiguous(),
            offs.to(torch.int32), kv)


def mla_cost(q_lat, pos, offs, kv):
    """(bytes, flops) of the MLA kernel: q read once (bf16, 576 a row), o
    written once (fp32, 512 a row), each row's slots a query can see read
    once (1152 bytes) with their positions; 2·(576 + 512) flops a visible
    (query head, slot) pair."""
    import torch
    B, C, H, _ = q_lat.shape
    p = pos[:, :kv].cpu()
    qpos = offs.cpu()[:, None] + torch.arange(C)[None]
    seen = (p[:, None, :] >= 0) & (p[:, None, :] <= qpos[:, :, None])
    keys = int(seen.any(dim=1).sum())
    pairs = int(seen.sum()) * H
    return (B * C * H * (576 * 2 + 512 * 4) + keys * (1152 + 4),
            {"bfloat16": 2 * 1088 * pairs})


def mla_calls(inputs, scale):
    """(kernel call, plain call) of the MLA kernel on ``make_mla_inputs``'
    tensors."""
    from repro_torch.kernels import ops, ref
    q_lat, q_rope, latent, k_rope, pos, offs, kv = inputs
    return (functools.partial(ops.mla_attention, q_lat, q_rope, latent,
                              k_rope, pos, offs, scale=scale, kv_len=kv),
            functools.partial(ref.mla_attention_ref, q_lat, q_rope, latent,
                              k_rope, pos, offs, scale=scale, kv_len=kv))


def chunked_plain(plain, x, *factors, chunk=32):
    """A batched plain version over ``chunk`` experts at a time (each
    expert's rows its own, so the result is the same; 256 experts' fp32
    or float64 copies at once would not fit): x (E, …) and each factor
    (E, …)."""
    import torch
    E = x.shape[0]
    return torch.cat([plain(x[e:e + chunk], *(f[e:e + chunk] for f in
                                              factors))
                      for e in range(0, E, chunk)])


def ds_batched_calls(x, U, S, V, r):
    """(kernel name, kernel call, plain call) of the batched expert launch
    in the five storages at 256 experts; the plain versions run 32 experts
    at a time (the W8A8 / W4A8 ones in float64)."""
    from repro_torch import quant
    from repro_torch.kernels import ops, ref
    calls = [("blast_matmul_batched",
              lambda: ops.blast_matmul_batched(x, U, S, V),
              lambda: chunked_plain(ref.blast_matmul_batched_ref, x, U, S,
                                    V))]
    for mode in QUANT_MODES:
        bits, act = mode_bits_act(mode)
        codes, scales = quantize_factors(U, S, V, bits=bits)
        kern_fn = (ops.blast_matmul_batched_q4 if bits == 4
                   else ops.blast_matmul_batched_q)
        kern = functools.partial(kern_fn, x, *codes, *scales, act=act)
        if act == "int8":
            plain_a8 = (ref.blast_matmul_batched_a4_ref if bits == 4
                        else ref.blast_matmul_batched_a8_ref)

            def plain(plain_a8=plain_a8, codes=codes, scales=scales):
                xq, sx = quant.quantize_act(x)    # the wrapper's prologue
                return chunked_plain(plain_a8, xq, sx, *codes,
                                     *scales).to(x.dtype)
        else:
            plain = functools.partial(
                chunked_plain, ref.blast_matmul_batched_q4_ref if bits == 4
                else ref.blast_matmul_batched_q_ref, x, *codes, *scales)
        calls.append((MOE_BATCHED[mode], kern, plain))
    return calls


def ds_expert_shapes(ds):
    """(name, n, m, b, r) of deepseek's expert linears: ``wi`` (7168 →
    4096, gate ‖ up) and ``wo`` (2048 → 7168), b = 16."""
    from repro_torch.models.moe import make_moe
    spec = make_moe(ds)
    return [(name, lin.d_in, lin.d_out, lin.meta["b"], lin.meta["r"])
            for name, lin in (("wi", spec.wi), ("wo", spec.wo))]


def phase_kernels_deepseek(ds, errs) -> None:
    """deepseek-v3-671b's kernels against their plain versions on the card:
    the MLA kernel at full width (B = 8, 128 heads, S = 512; ``MLA_CASES``:
    C = 1 and 32 at random offsets, the last slot, dead columns with an
    empty row, kv_len < S), fp32 and bf16, two launches at decode bit for
    bit; B1 and B2 at the MLA, shared-expert and dense-FFN shapes (T = 8)
    and at ``wkv_b``'s densification (T = 512: the identity in bf16 for
    float bf16 weights, in fp32 — the scales' type — for the quantized
    ones), bf16 in five storages and fp32 float, two launches at T = 8 bit
    for bit; the batched expert kernel at 256 experts, 1 and 40 rows a set
    (at 40, each set's last row zero), bf16 in five storages, two launches
    at 1 row bit for bit."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 60)
    H = ds.n_heads
    scale = 1.0 / math.sqrt(ds.mla.nope_head_dim + ds.mla.rope_head_dim)
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for C, offsets, opts in MLA_CASES:
            inputs = make_mla_inputs(8, C, H, 512, dtype, gen, offsets,
                                     **opts)
            kern, plain = mla_calls(inputs, scale)
            label = (f"{DEEPSEEK} mla B=8 H={H} C={C} S=512 "
                     f"kv_len={inputs[-1]} {opts or ''}")
            if C == 1 and offsets is None:
                repeat_identical(("mla_attention", kern, None), label, C,
                                 dname)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if opts.get("dead") and bool(got[0].abs().max() != 0):
                raise RuntimeError("mla_attention: the empty row is not 0")
            e = check_close(f"mla_attention[{label}]", got, want, dname,
                            scaled=True)
            if dname == "bfloat16":
                errs["mla_attention"] = max(errs["mla_attention"], e)
            del inputs
    for name, n, m, b, r, G, T in ds_blast_shapes(ds):
        linear = f"{DEEPSEEK} {name} {n}->{m} b={b} r={r} G={G}"
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            x, U, S_, V = make_blast_inputs(n, m, b, r, G, T, dtype, gen,
                                            DEVICE)
            if T == n:        # the densification's identity
                x = torch.eye(n, dtype=dtype, device=DEVICE)
            # fp32: the float kernel, and at the densification the
            # quantized ones (their identity is in the scales' fp32)
            modes = (QUANT_MODES if dname == "bfloat16" and T != 512
                     or dname == "float32" and T == 512 else ())
            for call in blast_calls(x, U, S_, V, r, modes):
                kname, kern, plain = call
                if T == 8:
                    repeat_identical(call, linear, T, dname)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                e = check_close(f"{kname}[{linear} T={T}]", got, want, dname)
                if dname == "bfloat16":
                    errs[kname] = max(errs[kname], e)
            del x, U, S_, V
    E = ds.moe.n_experts
    for name, n, m, b, r in ds_expert_shapes(ds):
        for rows in DS_ROWS:
            x, U, S_, V = moe_inputs(n, m, b, r, E, rows, torch.bfloat16,
                                     gen)
            if rows == 1:     # its one row live, not the empty slot
                x.normal_(generator=gen)
            linear = f"{DEEPSEEK} {name} {n}->{m} b={b} r={r} E={E}"
            for call in ds_batched_calls(x, U, S_, V, r):
                kname, kern, plain = call
                if rows == DS_ROWS[0]:
                    repeat_identical(call, linear, rows, "bfloat16")
                got, want = kern(), plain()
                torch.cuda.synchronize()
                e = check_close(f"{kname}[{linear} rows={rows}]", got, want,
                                "bfloat16")
                errs[kname] = max(errs[kname], e)
                del got, want
            del x, U, S_, V
            torch.cuda.empty_cache()


def phase_reference_deepseek(ds):
    """deepseek-v3-671b at full width (d_model 7168, 128 heads, MLA 1536 /
    512 / 128 + 64 / 128, vocab 129280, 256 experts top-8 of 2048 and a
    shared expert, capacity 1.25), fp32, cut to one dense and one MoE
    layer (``DS_CUT``): the card (kernels) against the CPU (plain
    versions) from one init, drawn on the card and copied to the host
    (~31 GB a side), over three ragged chunks of 16 with idle rows and
    dead columns (``_reference_rows``) with the float cache and the int8
    latent cache, and ``LM.apply`` over 2 × 48 tokens (no cache: once): every live logit row
    within 1e-3 + 1e-3·max|logit|, ``aux`` within 1e-5 relative; the cache
    leaves: ``pos`` equal, the latent and k_rope within 1e-3 + 1e-3·max
    (float) or equal (int8: the CPU takes the card's codes,
    ``SharedRowCodes``).  The CPU takes the card's expert ids
    (``SharedRouting``, after its near-tie check)."""
    import contextlib
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    small = ds_config(ds, *DS_CUT, param_dtype="float32",
                      compute_dtype="float32")
    gpu = build_model(small, device=DEVICE)
    params_gpu = gpu.init(card_seed())
    t0 = time.perf_counter()
    params_cpu = tree_map(lambda t: t.cpu(), params_gpu)
    copy_s = time.perf_counter() - t0
    toks = torch.randint(0, ds.vocab, (2, 48),
                         generator=torch.Generator().manual_seed(SEED + 7))
    for cache in ("none", "int8"):
        cfg = dataclasses.replace(small, quant=quant.QuantConfig(cache=cache))
        gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg,
                                                                device="cpu")
        routing = SharedRouting()
        shared = [routing] + ([SharedRowCodes()] if cache == "int8" else [])
        t0 = time.perf_counter()
        err, lim, (c_g, c_c) = _reference_rows(gpu, cpu, params_gpu,
                                               params_cpu, "none", shared)
        rows_s = time.perf_counter() - t0
        if cache == "none":      # no cache: the same in both modes
            with contextlib.ExitStack() as stack:
                stack.enter_context(routing)
                routing.recording = True
                out_g = gpu.apply(params_gpu, toks.to(DEVICE))
                routing.recording = False
                out_c = cpu.apply(params_cpu, toks)
            a_err = (out_g.logits.float().cpu() - out_c.logits).abs().amax(
                dim=-1).flatten()
            a_lim = 1e-3 + 1e-3 * float(out_c.logits.abs().max())
            aux_g, aux_c = float(out_g.aux), float(out_c.aux)
            aux_rel = abs(aux_g - aux_c) / abs(aux_c)
            applied = {"apply_max_abs_logit_err": float(a_err.max()),
                       "apply_positions": int(a_err.numel()),
                       "apply_limit": a_lim, "aux_card": aux_g,
                       "aux_cpu": aux_c, "aux_rel_err": aux_rel}
            a_past = int((a_err > a_lim).sum())
        leaves, bad = {}, []
        for i, (lg, lc) in enumerate(zip(c_g, c_c)):
            for name, leaf in lg.items():
                g, c = leaf.cpu(), lc[name]
                if name == "pos" or cache == "int8":
                    ok = torch.equal(g, c)
                    e = float((g.float() - c.float()).abs().max())
                else:
                    e = float((g - c).abs().max())
                    ok = e <= 1e-3 + 1e-3 * float(c.abs().max())
                leaves[f"{i}.{name}"] = e
                if not ok:
                    bad.append(f"{i}.{name}")
        past = int((err > lim).sum()) + a_past
        emit({"phase": "reference", "arch": DEEPSEEK,
              "mode": f"deepseek:{'int8_cache' if cache == 'int8' else 'float'}",
              "layers": small.n_layers, "dense_layers": DS_CUT[0],
              "d_model": ds.d_model, "vocab": ds.vocab,
              "experts": ds.moe.n_experts, "top_k": ds.moe.top_k,
              "shared_experts": ds.moe.n_shared, "dtype": "float32",
              "cache": cache, "chunks": 3, "copy_to_host_s": copy_s,
              "ragged_chunks_s": rows_s,
              "param_bytes": quant.tree_nbytes(params_gpu),
              "max_abs_logit_err": float(err.max()), "rows": len(err),
              **(applied if cache == "none" else {}),
              "rows_past_limit": past, "cache_leaf_max_abs_err": leaves,
              "routing": {"calls": routing.calls, "tokens": routing.tokens,
                          "tokens_with_swapped_experts": routing.flips,
                          "max_gap_at_swaps": routing.max_gap,
                          "near_tie_limit": ROUTE_TIE},
              **{c.CODEC: _codec_report(c) for c in shared[1:]},
              "limit": "1e-3 + 1e-3*max|logit| per row; aux 1e-5 relative; "
                       "leaves 1e-3 + 1e-3*max (int8, pos: equal)"})
        if past or aux_rel > 1e-5 or bad:
            raise RuntimeError(f"reference[{DEEPSEEK} {cache}]: card differs "
                               f"from the CPU plain path: row errors "
                               f"{err.tolist()}, limits {lim.tolist()}, apply "
                               f"{float(a_err.max())} (limit {a_lim}), aux "
                               f"{aux_g} vs {aux_c}, leaves {bad}")
        del gpu, cpu, c_g, c_c
    del params_gpu, params_cpu
    torch.cuda.empty_cache()


def ds_dropless(cfg):
    """``cfg`` with capacity past every assignment (``DS_DROPLESS``)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=DS_DROPLESS))


def phase_deepseek(ds) -> dict:
    """deepseek-v3-671b at full width (d_model 7168, 128 heads, MLA with a
    512 + 64 latent cache, 256 experts top-8 of 2048, a shared expert of
    2048, dense first layers of 18432, vocab 129280 untied, bf16, seeded
    random weights drawn on the card) in every serving mode, 8 prompts of
    16–200 tokens (``DS_PROMPTS``), 16 new (``DS_NEW``), 8 slots, chunk 32,
    every run's requests ``varied``:

    - ``serve deepseek:float`` at 3 dense + 2 MoE layers (``DS_SERVE``:
      ≈ 28 GB of params), captured = eager token for token, launches
      steps × ``ds_per_step``; the int8, W8A8, int4 and W4A8 weights and
      the int8 latent cache at 1 + 1 (``DS_CUT``, the same layers);
    - ``paged deepseek:float`` (1 + 1): paged = slot-static bit for bit
      (capacity 1.25: the same steps route the same);
    - ``paged preempt deepseek:float`` (1 + 1, capacity 1.25: its bf16
      tokens against the roomy run's reported);
    - dropless (capacity factor ``DS_DROPLESS``): ``paged prefix`` (16
      requests sharing 256 tokens, ≥ 15·256 hit tokens) and ``spec
      deepseek:dropless`` (frac ``DS_SPEC_FRAC``;
      graphs, eager, paged: captured = eager and paged = slot-static bit
      for bit; prompts cut to ``DS_SPEC_PROMPT`` tokens), their bf16
      tokens against the plain run's reported; in fp32 (1 + 1,
      ``DS_FP32_PROMPTS`` of those prompts, chunks of 8) speculation at
      frac 1.0
      gated under the 1e-4 margin, acceptance ≥ 0.9 (a rejected draft's
      rollback is held to plain decoding in fp32 by the CPU tests);
    - ``profile deepseek:float`` (1 + 1): captured and eager decode, the
      routing glue and the absorbed matrices under ``record_function``
      ranges, the MLA kernel's calls and ms a step.

    Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.models import mla as mla_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    full_cfg = ds_config(ds, *DS_SERVE)
    model = build_model(full_cfg, device=DEVICE)
    params = model.init(card_seed())
    torch.cuda.synchronize()
    init = {"init_params": sum(t.numel() for t in leaves(params)),
            "init_bytes": quant.tree_nbytes(params),
            "init_s": time.perf_counter() - t0,
            "dense_layers": DS_SERVE[0], "moe_layers": DS_SERVE[1]}
    prompts = serve_prompts(ds.vocab, n=DS_PROMPTS)
    config = serve_config("none")
    launches = {}
    launches["deepseek:float"], _, outputs = timed(
        "serve deepseek:float", phase_serve, model, params, "deepseek:float",
        config, ds_per_step(full_cfg, "none"), prompts=prompts,
        max_new=DS_NEW, **init)
    varied(outputs, "serve deepseek:float")
    cut_cfg = ds_config(ds, *DS_CUT)
    cut_params = ds_cut_params(params, DS_CUT[0])
    del model, params
    cut = build_model(cut_cfg, device=DEVICE)
    for label, (mode, cache) in MOE_MODES.items():
        if label == "float":
            continue
        what = f"deepseek:{label}"
        serving = cut if cache == "none" else build_model(
            dataclasses.replace(cut_cfg, quant=quant.QuantConfig(
                cache=cache)), device=DEVICE)
        launches[what], _, outputs = timed(
            f"serve {what}", phase_serve, serving, cut_params,
            f"{what}:{sum(DS_CUT)}L", serve_config(mode),
            ds_per_step(cut_cfg, mode), prompts=prompts, max_new=DS_NEW)
        varied(outputs, f"serve {what}")
        del serving
    cut_step = ds_per_step(cut_cfg, "none")
    static = timed("serve deepseek:float:cut", phase_serve, cut, cut_params,
                   f"deepseek:float:{sum(DS_CUT)}L", config, cut_step,
                   prompts=prompts, max_new=DS_NEW)[1:]
    launches["paged:deepseek:float"] = timed(
        "paged deepseek:float", phase_paged, cut, cut_params,
        "deepseek:float", config, cut_step, static, prompts=prompts,
        max_new=DS_NEW)
    # preemption at the default capacity: its bf16 tokens are reported
    # against the roomy run's either way (a resumed request's chunks
    # round otherwise), and dropless its 256-row prefill steps took 40 s
    # of the script's time
    varied(timed("paged preempt deepseek:float", phase_paged_preempt, cut,
                 cut_params, "deepseek:float", config, gate_tokens=False),
           "paged preempt deepseek:float")
    free = build_model(ds_dropless(cut_cfg), device=DEVICE)
    varied(timed("paged prefix deepseek:dropless", phase_paged_prefix, free,
                 cut_params, "deepseek:dropless", config),
           "paged prefix deepseek:dropless")
    # dropless, a step routes every one of its B·C token slots to every
    # expert's buffer (capacity Tl), so a 32-wide prefill step costs ~40
    # decode steps: the speculative runs take prompts of one chunk
    short = [p[:DS_SPEC_PROMPT] for p in prompts]
    rows = timed("spec deepseek:dropless", phase_spec, free, cut_params,
                 "deepseek:dropless", config, cut_step,
                 fracs=(DS_SPEC_FRAC,), gate_tokens=False, prompts=short,
                 max_new=DS_NEW)
    spec_checks(rows, "deepseek:dropless")
    for graphs in (True, False):
        timed("profile deepseek:float", retried(phase_profile_state), cut,
              cut_params, config, "deepseek:float", cut_step,
              (moe_lib, mla_lib), (MOE_MARKS, MLA_MARKS), graphs=graphs)
    del free, cut, cut_params
    torch.cuda.empty_cache()
    small = build_model(ds_dropless(ds_config(
        ds, *DS_CUT, param_dtype="float32", compute_dtype="float32")),
        device=DEVICE)
    small_params = small.init(card_seed())
    # chunks of 8: a fp32 step over 256 experts costs by its B·C token
    # slots, and each captured bucket runs it twice
    narrow = dataclasses.replace(config, scheduler=dataclasses.replace(
        config.scheduler, chunk_size=8))
    rows = timed("spec deepseek:fp32", phase_spec, small, small_params,
                 "deepseek:fp32", narrow, ds_per_step(small.cfg, "none"),
                 paged=False, eager=False, fracs=(1.0,),
                 prompts=short[:DS_FP32_PROMPTS], max_new=DS_NEW)
    if rows[0]["graphs"]["acceptance_rate"] < 0.9:
        raise RuntimeError(f"spec deepseek:fp32: acceptance "
                           f"{rows[0]['graphs']['acceptance_rate']} at frac "
                           "1.0")
    del small, small_params
    torch.cuda.empty_cache()
    return launches


def ds_timing_rows(ds, flush) -> list:
    """deepseek's rows (bf16): the MLA kernel at decode (B = 8, C = 1, 128
    heads, S = 512, random offsets) and at a 32-token chunk (library: the
    reference's einsums as ``torch.matmul`` on the card — scores over
    [latent ‖ k_rope], the position mask, softmax, P·latent — same work);
    B1 at ``wkv_b``'s densification (512 → 32768, T = 512) and B2 at
    ``wq_a`` + ``wkv_a`` (T = 8); the batched expert kernel at ``wi`` and
    ``wo``, 256 experts at 1 row a set (decode) in float and int8
    (library: ``torch.bmm`` over the dense experts, by 32
    at a time, dense work)."""
    import torch
    from repro_torch.core import blast as blast_lib
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 70)
    H = ds.n_heads
    scale = 1.0 / math.sqrt(ds.mla.nope_head_dim + ds.mla.rope_head_dim)
    rows = []
    for C, T in ((1, 8), (32, 256)):
        inputs = make_mla_inputs(8, C, H, 512, torch.bfloat16, gen)
        q_lat, q_rope, latent, k_rope, pos, offs, kv = inputs
        kern, plain = mla_calls(inputs, scale)
        qpos = offs[:, None].long() + torch.arange(C, device=DEVICE)[None]
        ok = ((pos[:, None, :kv] >= 0)
              & (pos[:, None, :kv] <= qpos[:, :, None]))     # (B, C, kv)
        lat, rope = latent[:, :kv], k_rope[:, :kv]

        def lib(q_lat=q_lat, q_rope=q_rope, lat=lat, rope=rope, ok=ok):
            s = (torch.matmul(q_lat, lat[:, None].transpose(-1, -2))
                 + torch.matmul(q_rope, rope[:, None].transpose(-1, -2)))
            s = s.float() * scale
            s = s.masked_fill(~ok[:, :, None], float("-inf"))
            return torch.matmul(torch.softmax(s, -1).to(lat.dtype),
                                lat[:, None])
        rows.append(timing_row(
            "mla_attention", f"mla C={C}", T,
            f"B=8 C={C} H={H} S=512 kv={kv} 576/512", kern, plain, lib,
            "torch.matmul: the reference's einsums (same work)",
            mla_cost(q_lat, pos, offs, kv), flush, arch=DEEPSEEK,
            offsets="random"))
        del inputs, ok
    lib_name = "torch.matmul(x, to_dense(A).T) (dense work)"
    for name, n, m, b, r, G, T in ds_blast_shapes(ds):
        if name not in ("wq_a+wkv_a", "wkv_b dense"):
            continue
        x, U, S_, V = make_blast_inputs(n, m, b, r, G, T, torch.bfloat16,
                                        gen, DEVICE)
        if T == n:
            x = torch.eye(n, dtype=torch.bfloat16, device=DEVICE)
        dense = torch.cat([blast_lib.to_dense(blast_lib.BlastParams(
            U[g], S_[g], V[g])) for g in range(G)], dim=0)
        kname, kern, plain = blast_calls(x, U, S_, V, r, ())[0]
        rows.append(timing_row(
            kname, name, T, f"{n}->{m} b={b} r={r} G={G}", kern, plain,
            lambda: torch.matmul(x, dense.T), lib_name,
            blast_cost(n, m, b, r, G, T, 2), flush, arch=DEEPSEEK))
        del x, U, S_, V, dense
    E = ds.moe.n_experts
    for name, n, m, b, r in ds_expert_shapes(ds):
        _, U, S_, V = make_blast_inputs(n, m, b, r, E, 1, torch.bfloat16,
                                        gen, DEVICE)
        dense = torch.empty((E, n, m), dtype=torch.bfloat16, device=DEVICE)
        for g in range(E):
            dense[g] = blast_lib.to_dense(blast_lib.BlastParams(
                U[g], S_[g], V[g])).T
        for rows_ in DS_ROWS[:1]:     # decode: one row a set
            x = torch.randn((E, rows_, n), generator=gen,
                            device=DEVICE).to(torch.bfloat16)
            lib = functools.partial(torch.bmm, x, dense)
            for kname, kern, plain in ds_batched_calls(x, U, S_, V, r):
                # float and int8: the other plain versions at 256 experts
                # take seconds a call
                if kname not in ("blast_matmul_batched",
                                 "blast_matmul_batched_q"):
                    continue
                mode = next(k for k, v in MOE_BATCHED.items() if v == kname)
                rows.append(timing_row(
                    kname, name, 8 if rows_ == 1 else 8 * rows_,
                    f"{n}->{m} b={b} r={r} E={E} rows={rows_}", kern, plain,
                    lib, "torch.bmm(x, dense experts) (dense work)",
                    blast_cost(n, m, b, r, E, rows_, 2, mode, batched=True),
                    flush, arch=DEEPSEEK, rows=rows_))
            del x
        del U, S_, V, dense
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    dev, smi = phase_device()
    import torch
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    cfg = configs.get(SMOLLM)
    llama, gpt2 = configs.get(LLAMA), configs.get("gpt2-blast")
    hyb, ssm, moe = configs.get(HYBRID), configs.get(SSM), configs.get(MOE)
    ds = configs.get(DEEPSEEK)
    from repro_torch.models import build_model
    timed("build", phase_build)
    errs = timed("kernels", phase_kernels, cfg)
    timed("kernels llama7b-blast", phase_kernels_llama, llama, errs)
    timed(f"kernels {HYBRID}", phase_kernels_hybrid, hyb, errs)
    timed(f"kernels {SSM}", phase_kernels_ssd, ssm, errs)
    timed(f"kernels {MOE}", phase_kernels_moe, moe, errs)
    timed("grads", phase_grads, cfg, moe)
    for mode in MODES:
        timed(f"reference {mode}", phase_reference, cfg, mode,
              *MODES[mode][0])
    timed("reference llama7b-blast, gpt2-blast", phase_reference_dense,
          llama, gpt2)
    timed(f"reference {HYBRID}", phase_reference_hybrid, hyb)
    timed(f"reference {HYBRID} int8 cache", phase_reference_hybrid, hyb,
          cache="int8")
    timed(f"reference {SSM}", phase_reference_ssd, ssm)
    timed(f"reference {MOE}", phase_reference_moe, moe)
    for arch, (layers, seq, over) in TRAIN_REFERENCE.items():
        timed(f"train_reference {arch}", phase_train_reference,
              configs.get(arch), layers, seq, **over)
    timed("optimizer_and_last_only", phase_optimizer_and_last_only, cfg)
    model = build_model(cfg, device=DEVICE)
    params = model.init(SEED)
    launches, rows = {}, {}
    for mode in MODES:
        launches[mode], rows[mode], _ = timed(
            f"serve {mode}", phase_serve, model, params, mode,
            serve_config(mode), smollm_per_step(cfg, mode))
    cut, cut_params = cut_models(cfg, params, SMOLLM_CUT_LAYERS,
                                 {"none": "none"})
    cut = cut["none"]
    # paged = slot-static and prefix sharing at the cut depth, for the
    # script's time
    for mode in ("none", "int8"):
        _, *static = timed(
            f"serve {mode}:cut", phase_serve, cut, cut_params,
            f"{mode}:{SMOLLM_CUT_LAYERS}L", serve_config(mode),
            smollm_per_step(cut.cfg, mode))
        launches[f"paged:{mode}"] = timed(
            f"paged {mode}", phase_paged, cut, cut_params, mode,
            serve_config(mode), smollm_per_step(cut.cfg, mode), static)
    timed("paged prefix none", phase_paged_prefix, cut, cut_params, "none",
          serve_config("none"))
    for mode in ("none", "int8"):
        timed(f"spec {mode}", phase_spec, cut, cut_params, mode,
              serve_config(mode), smollm_per_step(cut.cfg, mode),
              eager=False, pad_check=True)
    for mode in MODES:
        for graphs in (True, False):
            timed(f"profile {mode}", retried(phase_profile), cut,
                  cut_params, mode, serve_config(mode), graphs=graphs)
    for graphs in (True, False):
        timed("profile long prompt", retried(phase_profile), cut,
              cut_params, "none", serve_config("none"),
              prompt_len=LONG_PROMPT, graphs=graphs)
    del model, params, cut, cut_params
    # the paper's baseline structures (configs.VARIANTS) and compression
    timed("reference structures", phase_reference_structures, cfg)
    launches.update(timed("smollm variants", phase_variants, cfg,
                          rows["none"]))
    timed("spec low_rank50", phase_spec_low_rank, cfg)
    launches["compress:blast"] = timed("compress", phase_compress, llama)
    launches.update(timed("train structures", phase_train_structures, gpt2))
    launches.update(timed("llama7b-blast and gpt2-blast serving",
                          phase_dense_serving, llama, gpt2))
    launches.update(timed(f"{HYBRID} serving", phase_hybrid, hyb))
    launches.update(timed(f"{SSM} serving", phase_ssm, ssm))
    launches.update(timed(f"{MOE} serving", phase_moe, moe))
    launches["train"] = timed("train", phase_train, cfg)
    for arch, (layers, steps) in TRAIN_RUNS.items():
        arch_cfg = configs.get(arch)
        launches[f"train:{arch}"] = timed(
            f"train {arch}", phase_train, dataclasses.replace(
                arch_cfg, n_layers=min(layers, arch_cfg.n_layers)),
            steps, profile=False)
    # deepseek after the training runs (run after deepseek's phases, the
    # training step's trace lost one of its 60 B4 records in every try),
    # the earlier families' engines and graph pools gone
    gc.collect()
    torch.cuda.empty_cache()
    timed(f"kernels {DEEPSEEK}", phase_kernels_deepseek, ds, errs)
    timed(f"reference {DEEPSEEK}", phase_reference_deepseek, ds)
    launches.update(timed(f"{DEEPSEEK} serving", phase_deepseek, ds))
    rows = timed("timing", phase_timing, cfg, llama, hyb, ssm, moe, ds)
    emit({"kernels": summary(rows, errs, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
