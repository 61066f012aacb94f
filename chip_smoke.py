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
   for bit) and kv_len < S, fp32 and bf16.
4. grads — fp32 gradients of the three autograd Functions on the training
   path (B1, B2, B4) against torch.autograd through the plain versions, at
   2048 tokens: within 1e-4 × each gradient's largest entry.
5. reference — the full-width model (fp32, depth cut to 2 layers) on the
   card through the kernels against the same model on the CPU through the
   plain versions, over ragged multi-chunk steps, in each serving mode:
   float, int8 weights, W8A8, int4 weights and W4A8; every quantized
   weight's codes (int4: packed bytes) and scales equal on both.  With
   int8 activations the gated run shares the card's activation codes with
   the CPU, after checking that the two differ only by boundary flips.
   llama7b-blast the same way (d_model 4096, vocab 32000, the untied head)
   in three modes from one init: float; the int8 cache; int8 weights and
   the int8 cache — the cache's K/V rows shared the same way
   (``SharedRowCodes``, after the CPU's codec on the card's inputs gives
   the card's codes bit for bit), and every cache leaf equal on both; and
   gpt2-blast (LayerNorm, learned positions, GELU), float.
6. train_reference — the same 2-layer fp32 model, one training batch:
   loss, every gradient and the parameters after one AdamW step on the
   card against the CPU; ``LM.apply(last_only=True)`` against
   ``prefill_chunk`` (B4 against B3).
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
   torch.profiler (8 slots, prompts of 16 tokens): wall, device busy and
   idle share per step, kernel time by name; on every profile whose trace names the kernels (the eager
   one always; ``kernels_by_name``) every BLAST launch runs the tile
   kernel's two ``__global__``s and no other, and attention the bf16
   attention kernel (30 a step) and no other (``attn_per_step``).  One
   more float profile each way decodes after prompts of 192 tokens, where
   B3 splits the keys: the split combine must run 30 times a step.
   Then llama7b-blast at full width (32 layers, vocab 32000, bf16, seeded
   random weights drawn tensor by tensor; the init's 3,278,639,104
   parameters counted before the pre-stack) in three modes — float, the
   int8 cache, int8 weights with the int8 cache — the same way, launches
   steps × (96, 32, 32) with attention in the int8-K/V kernel under the
   int8 cache, and the int8-cache run's peak memory below the float run's;
   temperature sampling (T = 0.8) twice with one seed (identical tokens)
   and once with another (different); the decode profile in float and
   with the int8 cache, both ways; gpt2-blast at full width, float.
8. train — full-width smollm-135m trained by the port's ``Trainer`` for 20
   steps through the captured step (bf16, remat, batch 8 × seq 256 of the
   Markov ``TokenStream``, lr 3e-4 with warmup 5; one eager warm-up step,
   then one CUDA graph of the whole step): per step loss, grad norm,
   skipped flag, time and launches; the median step time, training
   tokens/s, peak device memory, launches per step, and one more step
   under torch.profiler each way.  Every loss finite, no step skipped, the
   last 5 losses' mean below the first, B4 launched 30 × 2 times a step,
   no serving-only kernel; the profiled step's attention is the bf16 tile
   kernel alone, 60 launches.  A ``Trainer(jit=False)`` from the same init
   on the same batches: loss, grad norm and every parameter equal the
   captured run's bit for bit after each of 3 steps.  One more captured
   step whose loss is made non-finite (NaN in the embedding row of its
   first token) reports skipped, leaves params, m and v bit for bit and
   still counts.
9. timing — CUDA events, median of 25 runs after warm-up with the L2 cache
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
   of the same values).  The profiles of phases 7 and 8 also sum the BLAST tile kernel's two
   ``__global__``s (``blast_tile_kernel``, ``blast_split_sum``) and the
   attention kernel's (``attn_tile_kernel``, ``attn_split_combine``).

Each phase's seconds are printed on a ``{"phase": "seconds"}`` line.  The
last lines are the per-kernel JSON summary, the ``nvidia-smi`` line, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
# the training run: the launcher's defaults (batch 8 × seq 256, lr 3e-4),
# warmup 5, 20 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 256, 20, 3e-4, 5
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


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_close(name: str, got, want, dtype: str) -> float:
    """Max |got - want|; raises past ``atol + rtol·|want|`` (atol = rtol)."""
    import torch
    tol = TOL[dtype]
    g, w = got.float(), want.float()
    if g.shape != w.shape or not torch.isfinite(g).all():
        raise RuntimeError(f"{name}: shape {tuple(g.shape)} vs "
                           f"{tuple(w.shape)} or non-finite output")
    err = (g - w).abs()
    bad = err > tol + tol * w.abs()
    max_err = float(err.max())
    emit({"phase": "kernels", "case": name, "dtype": dtype,
          "max_abs_err": max_err, "rtol": tol, "atol": tol,
          "ok": not bool(bad.any())})
    if bad.any():
        raise RuntimeError(f"{name}: kernel disagrees with its plain version"
                           f" (max abs err {max_err}, tol {tol})")
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
    import torch
    from repro_torch.core import blast as blast_lib
    x = torch.randn((T, n), generator=gen).to(device=device, dtype=dtype)
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


def blast_cost(n, m, b, r, G, T, elt, mode="none"):
    """(bytes, {dtype: operations}) of one BLAST call taking x of ``elt``
    bytes and writing y of that type: every input read once, the output
    written once.  Quantized factors are 1-byte int8 codes or ⌈r/2⌉ bytes
    of packed int4 per factor row, plus fp32 scales (2b + b² per set);
    the W8A8 and W4A8 stage 1 runs at the int8 rate."""
    p, q = m // b, n // b
    rows = G * b * (p + b + q)            # factor rows of r ranks each
    bits, act = mode_bits_act(mode)
    if bits is None:
        bytes_ = (T * n + rows * r + G * T * m) * elt
    else:
        row_bytes = (r + 1) // 2 if bits == 4 else r
        bytes_ = ((T * n + G * T * m) * elt + rows * row_bytes
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

        def shared(x):
            xq, sx = real(x)
            if self.recording:
                self.card.append((x, xq, sx))
                return xq, sx
            xg, qg, sg = (t.cpu() for t in self.card.pop(0))
            self.check(x, xq, sx, xg, qg, sg)
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
    """The same for ``quantize_rows``, the int8 KV cache's write.  Each CPU
    call first runs the CPU's codec on the card's own input: codes and bf16
    scales must equal the card's bit for bit (the codec across devices).
    On its own input the CPU's codes must be within one step of the card's
    and its bf16 scales equal or one bf16 step apart (a scale near a bf16
    rounding boundary, which moves its row's codes by up to one step); the
    rows whose scale moved are counted.  The CPU then writes the card's
    codes, so the two caches must end equal."""

    CODEC = "quantize_rows"

    def __init__(self):
        super().__init__()
        self.moved_scales = 0

    def check(self, x, xq, sx, xg, qg, sg):
        import torch
        qs, ss = self.real(xg)
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
                    base=None):
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
    every row by O(1).  ``base``: the CPU float params of the 2-layer model
    (default its ``init(SEED)``), moved to the card for the card's run."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map
    qcfg = quant.QuantConfig(weights=weights, activations=act)
    small = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
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
    emit({"phase": "reference", "mode": mode, "arch": cfg.name, "layers": 2,
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
        llama, n_layers=2, param_dtype="float32", compute_dtype="float32"),
        device="cpu").init(SEED)
    for mode, (weights, cache) in LLAMA_MODES.items():
        phase_reference(llama, f"llama:{mode}", weights=weights, cache=cache,
                        base=base)
    del base
    phase_reference(gpt2, "gpt2:float")


def serve_config(mode, weights=None, **kw):
    """The serving runs' engine: 8 slots, chunk 32, max_len 512, weights
    (and activations) of a smollm-135m ``mode``, or ``weights``."""
    from repro_torch import quant
    from repro_torch.serve import EngineConfig, MemoryConfig, SchedulerConfig
    (w, act), _ = MODES[mode] if weights is None else ((weights, "none"),
                                                       None)
    return EngineConfig(scheduler=SchedulerConfig(slots=8, chunk_size=32),
                        memory=MemoryConfig(max_len=512),
                        quant=quant.QuantConfig(weights=w, activations=act),
                        **kw)


def smollm_per_step(cfg, mode) -> dict:
    """Launches a serving step of smollm-135m makes in ``mode``."""
    blast, grouped = MODES[mode][1]
    L = cfg.n_layers
    return {blast: 3 * L, grouped: L, "flash_attention_prefill": L}


def llama_per_step(cfg, mode) -> dict:
    """Launches a serving step of llama7b-blast makes in ``mode``: 96 BLAST
    (qkv, out, down), 32 grouped (gate+up), 32 attention, in the mode's
    own kernels."""
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


def phase_serve(model, params, mode, config, per_step, **extra):
    """One full-width serving run of ``model`` in ``mode`` through the
    captured engine (CUDA graphs, the default) and one through an eager
    engine (``step_fn``, which observes every step): identical greedy
    tokens, and each run's launch counts steps × ``per_step`` (every other
    kernel 0).  Returns (the captured run's launch counts, its row)."""
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
        live = int((steps + n_tokens)[n_tokens > 0].max())    # syncs
        splits.append([fa.split_plan(B, cfg.n_kv_heads, G, C, kv, sms)[2]
                       for kv in (kv_len, live)])
        logits, cache = model.prefill_chunk(params, cache, tokens, steps,
                                            n_tokens, kv_len=kv_len)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    prompts = serve_prompts(cfg.vocab)
    max_new = 32
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
    bucket, live = zip(*splits)
    row = {"phase": "serve", "mode": mode, "arch": cfg.name,
           "layers": cfg.n_layers, "vocab": cfg.vocab,
           "dtype": cfg.param_dtype, "weights": config.quant.weights,
           "activations": config.quant.activations,
           "cache": cfg.quant.cache, "slots": 8, "chunk": 32,
           "max_len": 512, "requests": len(prompts),
           "prompt_tokens": sum(map(len, prompts)),
           "new_tokens": len(prompts) * max_new,
           # engine params (quantized, the pre-stacked bundle included)
           "param_bytes": param_bytes, "cache_bytes": cache_bytes, **extra,
           "graphs": runs["graphs"]["row"], "eager": runs["eager"]["row"],
           "greedy_tokens_identical": True,
           "launches": {k: v for k, v in runs["graphs"]["launches"].items()
                        if v},
           "per_step": per_step,
           "attn_split_steps": sum(k > 1 for k in bucket),
           "attn_splits_max": max(bucket),
           # what the kv bucket costs against the live key range: B3 key
           # splits summed over steps (× the layers a step) and the steps
           # whose launches add a combine
           "attn_splits_sum": {"bucket": sum(bucket), "live": sum(live)},
           "attn_combine_steps": {"bucket": sum(k > 1 for k in bucket),
                                  "live": sum(k > 1 for k in live)}}
    emit(row)
    return runs["graphs"]["launches"], row


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
    if (other or out["attn_tile_kernel"]["calls"] * per != want_tile
            or out["attn_split_combine"]["calls"] * per != want_combine):
        raise RuntimeError(f"bf16 attention did not run the tile kernel "
                           f"alone: {out}, other kernels {other}")
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


def phase_grads(cfg):
    """fp32 gradients of the three autograd Functions on the card (kernel
    forward, B1 for BLAST dx, explicit backward) against torch.autograd
    through the plain versions on the same inputs, at smollm-135m's
    training shapes (2048 tokens): each gradient within 1e-4 × its largest
    entry."""
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 3)
    T = TRAIN_BATCH * TRAIN_SEQ
    cases = []
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
        a = [t.detach().clone().requires_grad_(True) for t in inputs]
        b_ = [t.detach().clone().requires_grad_(True) for t in inputs]
        y = fn(*a)
        dy = torch.randn(y.shape, generator=gen).to(DEVICE)
        got = torch.autograd.grad(y, a, dy)
        want = torch.autograd.grad(plain(*b_), b_, dy)
        torch.cuda.synchronize()
        errs = {n_: _rel_grad_err(g, w) for n_, g, w in zip(names, got, want)}
        ok = all(e <= 1e-4 for e in errs.values())
        emit({"phase": "grads", "case": name, "dtype": "float32",
              "max_err_over_max_grad": errs, "limit": 1e-4, "ok": ok})
        if not ok:
            raise RuntimeError(f"grads[{name}]: {errs} past 1e-4")


ADAM_NOISE = 1e-3   # see phase_train_reference


def phase_train_reference(cfg):
    """Full width, 2 layers, fp32, one batch of 2 × 128 tokens: the card
    (kernels) against the CPU (plain versions) from the same seeded
    weights.  Loss within 1e-5 relative; every gradient within 1e-4 × its
    leaf's largest entry.  One AdamW step on each device's own gradients:
    every parameter within 1e-6, except entries whose CPU gradient is below
    ``ADAM_NOISE`` × its leaf's largest, bounded by 2 × lr.  There AdamW's
    first step, lr·g/(|g| + eps) on the clipped gradient, turns the
    gradients' rounding into step differences above 1e-6 (the clipped |g|
    is within a few tens of eps); the error at the narrower cut of 1e-6 ×
    the leaf's largest is reported beside it.  And the optimizer alone:
    the card's step against the CPU's AdamW on the card's gradients, every
    parameter within 1e-6.  Then ``LM.apply(last_only=True)`` against
    ``prefill_chunk`` on the card (B4 against B3), logits within 1e-4."""
    import torch
    from repro_torch.data import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, constant_schedule
    from repro_torch.train import make_loss_fn
    from repro_torch.tree import leaves
    small = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    lr = 1e-3
    batch = TokenStream(vocab=cfg.vocab, seq_len=128, global_batch=2,
                        seed=SEED).batch(0)
    def adamw_step(params: list, grads) -> float:
        """One AdamW step in place; returns the skipped flag."""
        opt = adamw(constant_schedule(lr))
        return float(opt.update(list(grads), opt.init(params), params)[2][
            "skipped"])

    out = []
    for dev in (DEVICE, "cpu"):
        model = build_model(small, device=dev)
        params = model.init(SEED)
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss, _ = make_loss_fn(model)(params, batch)
        grads = torch.autograd.grad(loss, flat)
        skipped = adamw_step(flat, grads)
        out.append((model, float(loss.detach()), [g.cpu() for g in grads],
                    [p.detach().cpu() for p in flat], skipped))
    (model, loss_g, grads_g, after_g, skip_g), (_, loss_c, grads_c, after_c,
                                                skip_c) = out
    same_grads = [p.detach() for p in leaves(out[1][0].init(SEED))]
    adamw_step(same_grads, grads_g)
    optimizer_err = max(float((a - c).abs().max())
                        for a, c in zip(after_g, same_grads))
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
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
    # B4 (apply, last_only) against B3 (prefill_chunk) on the card
    params = model.init(SEED)
    toks = batch["tokens"][:, :128]
    with torch.no_grad():
        last = model.apply(params, toks, last_only=True).logits
    pre, _ = model.prefill_chunk(params, model.init_cache(2, 128), toks,
                                 [0, 0], [128, 128])
    lo_err = float((last - pre).abs().max())
    held = by_cut[ADAM_NOISE]
    ok = (loss_rel <= 1e-5 and grad_err <= 1e-4 and optimizer_err <= 1e-6
          and held["max_param_err"] <= 1e-6
          and held["max_noise_entry_err"] <= 2 * lr and lo_err <= 1e-4
          and skip_g == skip_c == 0)
    emit({"phase": "train_reference", "layers": 2, "d_model": cfg.d_model,
          "vocab": cfg.vocab, "dtype": "float32", "tokens": [2, 128],
          "loss_card": loss_g, "loss_cpu": loss_c, "loss_rel_err": loss_rel,
          "max_grad_err_over_leaf_max": grad_err,
          "after_step_by_noise_cut": {str(k): v for k, v in by_cut.items()},
          "params": sum(a.numel() for a in after_c),
          "same_grads_optimizer_max_param_err": optimizer_err,
          "last_only_vs_prefill_chunk_max_abs_err": lo_err,
          "limits": {"loss_rel": 1e-5, "grad": 1e-4, "param": 1e-6,
                     "same_grads_optimizer": 1e-6,
                     "noise_cut": ADAM_NOISE, "noise": 2 * lr,
                     "last_only": 1e-4}, "ok": ok})
    if not ok:
        raise RuntimeError("train_reference: the card's training step "
                           "differs from the CPU's past its limits")


def _bits(t):
    """A float tensor's bit patterns (NaNs compare equal to themselves)."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def _trainer(cfg, jit, log):
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
    opt = adamw(cosine_schedule(TRAIN_LR, TRAIN_STEPS, TRAIN_WARMUP))
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


def phase_train(cfg, eager_steps=3):
    """Full-width smollm-135m trained by the port's ``Trainer`` (30 layers,
    bf16, remat, seeded ``LM.init``, the ``TokenStream`` at the launcher's
    batch 8 × seq 256, AdamW with a cosine schedule): 20 steps through the
    captured step (``jit=True``, the default: one eager warm-up step, then
    a CUDA graph), then ``eager_steps`` steps of a ``jit=False`` trainer
    from the same init on the same batches, whose loss, grad norm and every
    parameter must equal the captured run's bit for bit after each of the
    first 3 steps.  One profiled step each way; then one captured step
    whose loss is made non-finite (NaN in the embedding row of the batch's
    first token) must be skipped, leave params, m and v bit for bit and
    still count.  Returns the launch counts of the captured run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.tree import leaves
    logs = {path: {"rows": [], "params": [], "keep": 3}
            for path in ("graphs", "eager")}
    trainer = _trainer(cfg, True, logs["graphs"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = trainer.run(TRAIN_STEPS, seed=SEED)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    L = cfg.n_layers
    want_b4 = L * (1 + int(cfg.remat))
    prof = _profile_train_step(trainer, result, TRAIN_STEPS, want_b4)
    ms = statistics.median(r["ms"] for r in
                           logs["graphs"]["rows"][3:TRAIN_STEPS])
    prof["device_idle_share_of_median_step"] = 1 - prof[
        "device_busy_ms"] / ms
    per_step = logs["graphs"]["rows"][:TRAIN_STEPS]
    # the NaN step: a replay of the captured graph
    params, state = result["params"], result["opt_state"]
    batch = trainer.data.batch(TRAIN_STEPS + 1)
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
    # the eager trainer, from the same init on the same batches
    eager = _trainer(cfg, False, logs["eager"])
    eager_result = eager.run(eager_steps, seed=SEED)
    prof_eager = _profile_train_step(eager, eager_result, eager_steps,
                                     want_b4, eager=True)
    # the eager steps' median, the first (cold allocator) left out
    eager_ms = statistics.median(r["ms"] for r in
                                 logs["eager"]["rows"][1:eager_steps])
    prof_eager["device_idle_share_of_median_step"] = 1 - prof_eager[
        "device_busy_ms"] / eager_ms
    del eager, eager_result
    ga, ea = logs["graphs"], logs["eager"]
    same = [ga["rows"][i]["loss"] == ea["rows"][i]["loss"]
            and ga["rows"][i]["grad_norm"] == ea["rows"][i]["grad_norm"]
            and all(torch.equal(x, y) for x, y in zip(ga["params"][i],
                                                     ea["params"][i]))
            for i in range(min(3, eager_steps))]
    losses = [r["loss"] for r in per_step]
    eager_rows = ea["rows"][:eager_steps]
    trained = {"blast_matmul", "blast_matmul_grouped", "flash_attention",
               "blast_matmul_dx"}
    stray = {k: v for k, v in launches.items() if v and k not in trained}
    emit({"phase": "train", "arch": cfg.name, "layers": L,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "dtype": cfg.param_dtype,
          "remat": cfg.remat, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "steps": TRAIN_STEPS, "lr": TRAIN_LR, "warmup": TRAIN_WARMUP,
          "graphs": graphs, "capture_s": capture_s,
          "first_loss": losses[0], "last5_mean_loss":
              statistics.fmean(losses[-5:]),
          "median_step_ms_after_3": ms,
          "train_tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
          "max_memory_allocated_bytes": peak,
          "launches_per_step": {k: v / TRAIN_STEPS
                                for k, v in launches.items() if v},
          "eager_steps": eager_steps,
          "eager_step_ms": [r["ms"] for r in eager_rows],
          "eager_median_step_ms_after_1": eager_ms,
          "graphs_equal_eager_bitwise_per_step": same,
          "nan_step": {"skipped": nan_skipped, "held": nan_held,
                       "counted": nan_counted},
          "profile": prof, "profile_eager": prof_eager})
    bad = []
    if not all(map(math.isfinite, losses)) or len(losses) != TRAIN_STEPS:
        bad.append(f"losses {losses}")
    if any(r["skipped"] for r in per_step + eager_rows):
        bad.append("a step was skipped")
    if not statistics.fmean(losses[-5:]) < losses[0]:
        bad.append(f"the last 5 losses' mean is not below the first "
                   f"({losses})")
    if launches["flash_attention"] != want_b4 * TRAIN_STEPS:
        bad.append(f"B4 launched {launches['flash_attention']} times, want "
                   f"{want_b4 * TRAIN_STEPS}")
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
        raise RuntimeError("train: " + "; ".join(bad))
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


def phase_timing(cfg, llama):
    """bf16 timings.  ``ms`` times the wrapper the model calls (for W8A8 and
    W4A8 it includes the per-token quantize prologue; ``launch_only_ms``
    times the kernel alone on ready codes).  Library: ``torch.matmul`` on
    the dense (dequantized) matrix — dense work, not the same
    operations.  llama7b-blast's rows (``arch``): its BLAST shapes, float
    and int8 weights, and B3 over int8 K/V (library: ``dequantize_rows``
    then masked SDPA)."""
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
    return rows


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
        "llama:int8_cache", LLAMA),
    "flash_attention": (
        _ATTN_CU, "src/repro/kernels/flash_attention.py:98", "train", SMOLLM),
}


def summary(rows, errs, launches):
    """One entry per kernel.  Its numbers are one layer's calls of that
    kernel in one decode step (T = 8 slots, C = 1) of its own arch's
    serving run, summed — for B4, which only training runs, one call at the
    training step's shape (B = 8, T = 256); ``cases`` holds every timed
    shape, llama7b-blast's too.  ``launches`` is the count from the run of
    the kernel's own path (its serving mode, or training);
    ``launches_by_run`` has every run's count that is not 0, and B1 its
    backward-dx launches (``train_dx_launches``, timed as the
    ``blast_matmul_dx`` cases)."""
    out = []
    for kname, (src, replaces, mode, arch) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == kname]
        if kname == "blast_matmul":
            mine += [r for r in rows if r["kernel"] == "blast_matmul_dx"]
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
    three modes from one init, with each mode's own model (the cache mode
    is the model's): captured = eager greedy tokens, launches steps × (96,
    32, 32) in the mode's kernels, the init's parameter count (before the
    pre-stack) = ``LLAMA_PARAMS``, the int8-cache runs' peak memory below
    the float run's; temperature sampling; the decode profile in float and
    with the int8 cache, through the graphs and eagerly.  Then gpt2-blast
    (12 layers, vocab 50257, LayerNorm, learned positions, GELU), float,
    captured = eager.  Returns each run's launch counts."""
    import torch
    from repro_torch import quant
    from repro_torch.models import build_model
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    models = {mode: build_model(dataclasses.replace(
        llama, quant=quant.QuantConfig(cache=cache)), device=DEVICE)
        for mode, (_, cache) in LLAMA_MODES.items()}
    params = models["float"].init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    init = {"init_params": n_params, "init_bytes": quant.tree_nbytes(params),
            "init_s": init_s}
    if n_params != LLAMA_PARAMS:
        raise RuntimeError(f"llama7b-blast: {n_params} parameters, want "
                           f"{LLAMA_PARAMS}")
    launches, peaks = {}, {}
    for mode, (weights, _) in LLAMA_MODES.items():
        launches[f"llama:{mode}"], row = timed(
            f"serve llama:{mode}", phase_serve, models[mode], params,
            f"llama:{mode}", serve_config(None, weights=weights),
            llama_per_step(llama, mode), **init)
        peaks[mode] = row["graphs"]["max_memory_allocated_bytes"]
    if not peaks["int8_cache"] < peaks["float"]:
        raise RuntimeError(f"llama7b-blast: the int8-cache run's peak memory "
                           f"is not below the float run's: {peaks}")
    timed("temperature", phase_temperature, models["float"], params)
    for mode in ("float", "int8_cache"):
        for graphs in (True, False):
            timed(f"profile llama:{mode}", phase_profile, models[mode],
                  params, f"llama:{mode}", serve_config(None, weights="none"),
                  graphs=graphs)
    del models, params
    model = build_model(gpt2, device=DEVICE)
    params = model.init(SEED)
    L = gpt2.n_layers
    launches["gpt2:float"], _ = timed(
        "serve gpt2:float", phase_serve, model, params, "gpt2:float",
        serve_config("none"),
        {"blast_matmul": 4 * L, "flash_attention_prefill": L},
        init_params=sum(t.numel() for t in leaves(params)))
    return launches


def main() -> int:
    dev, smi = phase_device()
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    cfg = configs.get(SMOLLM)
    llama, gpt2 = configs.get(LLAMA), configs.get("gpt2-blast")
    from repro_torch.models import build_model
    timed("build", phase_build)
    errs = timed("kernels", phase_kernels, cfg)
    timed("kernels llama7b-blast", phase_kernels_llama, llama, errs)
    timed("grads", phase_grads, cfg)
    for mode in MODES:
        timed(f"reference {mode}", phase_reference, cfg, mode,
              *MODES[mode][0])
    timed("reference llama7b-blast, gpt2-blast", phase_reference_dense,
          llama, gpt2)
    timed("train_reference", phase_train_reference, cfg)
    model = build_model(cfg, device=DEVICE)
    params = model.init(SEED)
    launches = {mode: timed(f"serve {mode}", phase_serve, model, params,
                            mode, serve_config(mode),
                            smollm_per_step(cfg, mode))[0]
                for mode in MODES}
    for mode in MODES:
        for graphs in (True, False):
            timed(f"profile {mode}", phase_profile, model, params, mode,
                  serve_config(mode), graphs=graphs)
    for graphs in (True, False):
        timed("profile long prompt", phase_profile, model, params, "none",
              serve_config("none"), prompt_len=LONG_PROMPT, graphs=graphs)
    del model, params
    launches.update(timed("llama7b-blast and gpt2-blast serving",
                          phase_dense_serving, llama, gpt2))
    launches["train"] = timed("train", phase_train, cfg)
    rows = timed("timing", phase_timing, cfg, llama)
    emit({"kernels": summary(rows, errs, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
