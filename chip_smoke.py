#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

1. device — name, ``nvidia-smi`` name and power limit, torch/CUDA versions.
   Without a CUDA device, or without the port's sources beside this file,
   the script stops here with exit code 1 and prints no result.
2. build — nvcc builds every kernel under ``src/repro_torch/kernels/csrc``.
3. kernels — each kernel against its plain PyTorch version on the card, at
   the full-width smollm-135m shapes, fp32 and bf16, max error vs tolerance.
4. reference — the full-width model (fp32, depth cut to 2 layers) on the
   card through the kernels against the same model on the CPU through the
   plain versions, over ragged multi-chunk steps.
5. serve — full-width smollm-135m (30 layers, vocab 49152, bf16, seeded
   random weights) served by the engine: 16 prompts of 16-200 tokens, 32
   new tokens each; the kernels' launch counters must equal steps × (90,
   30, 30).  Then six steady decode steps (8 slots) under torch.profiler:
   device busy and idle share per step, kernel time by name.
6. timing — CUDA events, median of 25 runs after warm-up with the L2 cache
   flushed before each run: kernel, plain version and one PyTorch library
   call (a yardstick only; the port never calls it), at decode and prefill
   shapes, beside each call's bound on the H100.

The last lines are the per-kernel JSON summary, the ``nvidia-smi`` line,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12               # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12,         # no tensor cores
              "bfloat16": 989e12}       # dense tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SEED = 0
DEVICE = "cuda"


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


def make_attn_inputs(B, Hq, Hkv, C, S, D, dtype, gen, device):
    """q (B, Hq, C, D) as the model's transposed view, the cache in its
    (B, S, Hkv, D) layout viewed as (B, Hkv, S, D), random row offsets."""
    import torch
    q = torch.randn((B, C, Hq, D), generator=gen).to(device=device, dtype=dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen).to(device=device, dtype=dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen).to(device=device, dtype=dtype)
    offs = torch.randint(0, S - C + 1, (B,), generator=gen).to(device=device,
                                                                dtype=torch.int32)
    return (q.transpose(1, 2), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
            offs)


def blast_cost(n, m, b, r, G, T, elt):
    p, q = m // b, n // b
    bytes_ = (T * n + G * (b * p * r + b * b * r + b * q * r) + G * T * m) * elt
    flops = 2 * G * T * ((m + n) * r + b * b * r)
    return bytes_, flops


def attn_cost(q, k, offs, elt):
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    offs = [int(o) for o in offs.cpu()]
    keys = sum(min(S, o + C) for o in offs)                    # visible rows
    pairs = sum(min(S, o + t + 1) for o in offs for t in range(C))
    bytes_ = (2 * B * Hq * C * D + 2 * keys * Hkv * D) * elt + 4 * B
    flops = 4 * D * Hq * pairs
    return bytes_, flops


def bound(bytes_, flops, dtype):
    """(bytes time, operations time) in ms on the H100."""
    return bytes_ / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


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


def phase_build():
    from repro_torch.kernels import blast_matmul, build, flash_attention
    t0 = time.perf_counter()
    paths = build.build_all()
    blast_matmul.tiles()          # loads and types the libraries
    flash_attention._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.build_seconds,
          "libraries": {k: str(v.relative_to(ROOT)) for k, v in paths.items()}})


def phase_kernels(cfg):
    import torch
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED)
    errs = {"blast_matmul": 0.0, "blast_matmul_grouped": 0.0,
            "flash_attention_prefill": 0.0}
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for name, n, m, b, r, G in blast_shapes(cfg):
            for T in (8, 256):
                x, U, S, V = make_blast_inputs(n, m, b, r, G, T, dtype, gen,
                                               DEVICE)
                if G == 1:
                    got = ops.blast_matmul(x, U[0], S[0], V[0])
                    want = ref.blast_matmul_ref(x, U[0], S[0], V[0])
                    kname = "blast_matmul"
                else:
                    got = ops.blast_matmul_grouped(x, U, S, V)
                    want = ref.blast_matmul_grouped_ref(x, U, S, V)
                    kname = "blast_matmul_grouped"
                torch.cuda.synchronize()
                e = check_close(f"{kname}[{name} {n}->{m} b={b} r={r} G={G} "
                                f"T={T}]", got, want, dname)
                if dname == "bfloat16":
                    errs[kname] = max(errs[kname], e)
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        for C in (1, 32):
            q, k, v, offs = make_attn_inputs(8, hq, hkv, C, 512, hd, dtype,
                                             gen, DEVICE)
            got = ops.flash_attention_prefill(q, k, v, offs)
            want = ref.attention_prefill_ref(q, k, v, offs)
            torch.cuda.synchronize()
            e = check_close(f"flash_attention_prefill[B=8 Hq={hq} Hkv={hkv} "
                            f"C={C} S=512 D={hd}]", got, want, dname)
            if dname == "bfloat16":
                errs["flash_attention_prefill"] = max(
                    errs["flash_attention_prefill"], e)
    return errs


def phase_reference(cfg):
    """Full-width fp32 model, 2 layers: card (kernels) vs CPU (plain)."""
    import torch
    from repro_torch.models import build_model
    small = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                compute_dtype="float32")
    gpu = build_model(small, device=DEVICE)
    cpu = build_model(small, device="cpu")
    params_cpu = cpu.init(SEED)
    params_gpu = gpu.init(SEED)
    cache_g, cache_c = gpu.init_cache(3, 64), cpu.init_cache(3, 64)
    rng = torch.Generator().manual_seed(SEED + 1)
    steps = torch.tensor([0, 0, 0])
    worst = 0.0
    for n_tok in ([16, 5, 0], [7, 16, 3], [1, 1, 16]):
        n_tok = torch.tensor(n_tok)
        toks = torch.randint(0, small.vocab, (3, 16), generator=rng)
        lg, cache_g = gpu.prefill_chunk(params_gpu, cache_g, toks, steps, n_tok)
        lc, cache_c = cpu.prefill_chunk(params_cpu, cache_c, toks, steps, n_tok)
        live = n_tok > 0
        got, want = lg.float().cpu()[live], lc[live]
        if not torch.isfinite(got).all():
            raise RuntimeError("reference: non-finite logits on the card")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if err > 1e-3 + 1e-3 * float(want.abs().max()):
            raise RuntimeError(f"reference: card logits differ from the CPU "
                               f"plain path by {err}")
        steps = steps + n_tok
    emit({"phase": "reference", "layers": 2, "d_model": small.d_model,
          "vocab": small.vocab, "dtype": "float32", "chunks": 3,
          "max_abs_logit_err": worst, "atol": 1e-3, "rtol": 1e-3})


def phase_serve(cfg):
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                                   SamplingParams, SchedulerConfig)
    model = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    params = model.init(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    finite = []

    def step(*args):
        logits, cache = model.prefill_chunk(*args)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    engine = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=8, chunk_size=32),
        memory=MemoryConfig(max_len=512)), device=DEVICE, step_fn=step)
    rng = np.random.default_rng(SEED)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab, size=int(L))]
               for L in rng.integers(16, 201, size=16)]
    max_new = 32
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = engine.generate_batch(prompts, SamplingParams(max_new_tokens=max_new))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    steps = engine.stats["steps"]
    L = cfg.n_layers
    want = {"blast_matmul": 3 * L * steps, "blast_matmul_grouped": L * steps,
            "flash_attention_prefill": L * steps}
    if launches != want:
        raise RuntimeError(f"launch counts {launches} != {want} "
                           f"({steps} steps × (90, 30, 30))")
    bad = [r.uid for r in reqs
           if not r.done or len(r.output) != max_new or r.stop_reason != "length"]
    if bad:
        raise RuntimeError(f"requests did not finish with {max_new} tokens: "
                           f"{bad}")
    if not bool(torch.stack(finite).all()):
        raise RuntimeError("non-finite logits in the serving run")
    tp = engine.throughput()
    emit({"phase": "serve", "arch": cfg.name, "layers": L, "vocab": cfg.vocab,
          "dtype": cfg.param_dtype, "slots": 8, "chunk": 32, "max_len": 512,
          "requests": len(reqs), "prompt_tokens": sum(map(len, prompts)),
          "new_tokens": sum(len(r.output) for r in reqs), "steps": steps,
          "decode_only_steps": len(engine.stats["decode_step_s"]),
          "wall_s": wall, "init_s": init_s,
          "prefill_tok_s": tp["prefill_tok_s"],
          "decode_tok_s": tp["decode_tok_s"],
          "decode_step_ms_median": 1e3 * statistics.median(
              engine.stats["decode_step_s"]),
          "launches": launches, "per_step": [90, 30, 30]})
    return launches, model, params


def phase_profile(model, params):
    """Device busy share of steady decode: 8 slots in decode, 6 engine
    steps under ``torch.profiler``; kernel time by name from the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                                   Request, SchedulerConfig)
    engine = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=8, chunk_size=32),
        memory=MemoryConfig(max_len=512)), device=DEVICE)
    for i in range(8):
        engine.submit(Request(uid=i, prompt=list(range(1, 17)),
                              max_new_tokens=64))
    engine.run(max_iters=3)          # prefill, then warm decode
    n_steps = 6
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(max_iters=n_steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    emit({"phase": "profile", "decode_steps": n_steps, "slots": 8,
          "wall_ms_per_step": wall_ms / n_steps,
          "device_busy_ms_per_step": busy / n_steps if kernels else None,
          "device_idle_share": 1 - busy / wall_ms if kernels else None,
          "device_ops_per_step": (sum(v[0] for v in kernels.values())
                                  / n_steps),
          "top": [{"name": n[:80], "calls_per_step": c / n_steps,
                   "ms_per_step": t / n_steps} for n, (c, t) in top]})


def phase_timing(cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import blast as blast_lib
    from repro_torch.kernels import ops, ref
    gen = torch.Generator().manual_seed(SEED + 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEVICE)
    dt, dname, elt = torch.bfloat16, "bfloat16", 2
    rows = []
    for name, n, m, b, r, G in blast_shapes(cfg):
        for T in (8, 256):
            x, U, S, V = make_blast_inputs(n, m, b, r, G, T, dt, gen, DEVICE)
            dense = torch.cat([blast_lib.to_dense(
                blast_lib.BlastParams(U[g], S[g], V[g])) for g in range(G)],
                dim=0)                                   # (G·m, n)
            if G == 1:
                kname = "blast_matmul"
                kern = lambda: ops.blast_matmul(x, U[0], S[0], V[0])  # noqa: E731
                plain = lambda: ref.blast_matmul_ref(x, U[0], S[0], V[0])  # noqa: E731
            else:
                kname = "blast_matmul_grouped"
                kern = lambda: ops.blast_matmul_grouped(x, U, S, V)  # noqa: E731
                plain = lambda: ref.blast_matmul_grouped_ref(x, U, S, V)  # noqa: E731
            lib = lambda: torch.matmul(x, dense.T)  # noqa: E731
            bytes_, flops = blast_cost(n, m, b, r, G, T, elt)
            t_bytes, t_ops = bound(bytes_, flops, dname)
            rows.append({"kernel": kname, "linear": name, "T": T,
                         "shape": f"{n}->{m} b={b} r={r} G={G}",
                         "ms": time_ms(kern, flush),
                         "plain_ms": time_ms(plain, flush),
                         "library_ms": time_ms(lib, flush),
                         "library": "torch.matmul(x, to_dense(A).T) (dense work)",
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                         "bytes_ms": t_bytes, "ops_ms": t_ops,
                         "bytes": bytes_, "flops": flops})
            emit({"phase": "timing", **rows[-1]})
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    for C in (1, 32):
        q, k, v, offs = make_attn_inputs(8, hq, hkv, C, 512, hd, dt, gen, DEVICE)
        kc, vc = k.contiguous(), v.contiguous()
        qpos = offs[:, None].long() + torch.arange(C, device=DEVICE)[None]
        mask = (torch.arange(512, device=DEVICE)[None, None]
                <= qpos[:, :, None])[:, None]           # (B, 1, C, S)
        kern = lambda: ops.flash_attention_prefill(q, k, v, offs)  # noqa: E731
        plain = lambda: ref.attention_prefill_ref(q, k, v, offs)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kc, vc, attn_mask=mask, enable_gqa=True)
        want = ref.attention_prefill_ref(q, k, v, offs)
        check_close(f"sdpa yardstick C={C}", lib(), want, dname)
        bytes_, flops = attn_cost(q, k, offs, elt)
        t_bytes, t_ops = bound(bytes_, flops, dname)
        rows.append({"kernel": "flash_attention_prefill", "linear": "attn",
                     "T": 8 * C, "shape": f"B=8 Hq={hq} Hkv={hkv} C={C} "
                     f"S=512 D={hd}",
                     "ms": time_ms(kern, flush),
                     "plain_ms": time_ms(plain, flush),
                     "library_ms": time_ms(lib, flush),
                     "library": "scaled_dot_product_attention (masked, GQA)",
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes_ms": t_bytes, "ops_ms": t_ops,
                     "bytes": bytes_, "flops": flops})
        emit({"phase": "timing", **rows[-1]})
    return rows


SOURCES = {
    "blast_matmul": ("src/repro_torch/kernels/csrc/blast_matmul.cu",
                     "src/repro/kernels/blast_matmul.py:285"),
    "blast_matmul_grouped": ("src/repro_torch/kernels/csrc/blast_matmul.cu",
                             "src/repro/kernels/blast_matmul.py:324"),
    "flash_attention_prefill": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:155"),
}


def summary(rows, errs, launches):
    """One entry per kernel.  Its numbers are one layer's calls of that
    kernel in one decode step (T = 8 slots, C = 1), summed; ``cases`` holds
    every timed shape."""
    out = []
    for kname, (src, replaces) in SOURCES.items():
        mine = [r for r in rows if r["kernel"] == kname]
        dec = [r for r in mine if r["T"] == 8]
        tot = {k: sum(r[k] for r in dec)
               for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        out.append({"name": kname, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches[kname],
                    "max_abs_err": errs[kname], "ms": tot["ms"],
                    "plain_ms": tot["plain_ms"],
                    "bound_ms": max(tot["bytes_ms"], tot["ops_ms"]),
                    "bound_by": ("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                                 else "operations"),
                    "library_ms": tot["library_ms"],
                    "per": "one layer's calls in one decode step (T=8)",
                    "cases": [{k: r[k] for k in ("linear", "T", "shape", "ms",
                                                 "plain_ms", "library_ms",
                                                 "bound_ms", "bound_by")}
                              for r in mine]})
    return out


def main() -> int:
    dev, smi = phase_device()
    sys.path.insert(0, str(SRC))
    from repro_torch import configs
    cfg = configs.get("smollm-135m")
    phase_build()
    errs = phase_kernels(cfg)
    phase_reference(cfg)
    launches, model, params = phase_serve(cfg)
    phase_profile(model, params)
    del model, params
    rows = phase_timing(cfg)
    emit({"kernels": summary(rows, errs, launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": dev})
    return 0


if __name__ == "__main__":
    sys.exit(main())
