#!/usr/bin/env python3
"""Run one tree's end-to-end phases of ``chip_smoke.py``, so that serving
and training through the CUDA graphs and eagerly, or two trees, can be
compared on one card.

    python3 scripts/e2e_ab.py --root PATH --label NAME [--modes none w4a8]

Imports ``chip_smoke`` and ``repro_torch`` from the tree at ``--root`` (its
own phases, with its own checks), builds that tree's kernels and runs, on
full-width smollm-135m with seeded random weights: the serving phase in
each of ``--modes`` (16 requests, 32 new tokens each, through the captured
engine and an eager one: decode tok/s and the median decode step of each),
the decode profile in each mode through the graphs and eagerly, in turns
(8 slots, 6 steps under torch.profiler: wall and device-busy ms a step)
and the training phase (20 captured steps and ``EAGER_STEPS`` eager ones:
median step ms each, one profiled step each); and the host's time per call
of the B3 wrapper at a decode step's shape, early (positions 16–32) and
past one key tile (192–200) (``host``: the median of 5 rounds of 200
calls, each round's wall time over its calls, so that the host's enqueue
cost and not the card sets it).  Every JSON line carries ``--label``.  Host
speed moves between calls, so run a tree several times, or two trees in
turns (A, B, B, A), within one call.  A tree from before the compiled step
runs with its own copy of this script.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

EAGER_STEPS = 10    # eager training steps; the first 3 are held to the
#                     captured run's bit for bit


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the tree's root directory")
    ap.add_argument("--label", required=True, help="name printed on each line")
    ap.add_argument("--modes", nargs="+", default=["none", "w4a8"],
                    help="serving modes (chip_smoke.MODES)")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import statistics
    import time

    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    if not torch.cuda.is_available():
        raise SystemExit("e2e_ab: no CUDA device")
    emit = cs.emit
    cs.emit = lambda obj: emit({"label": args.label, **obj})
    build.build_all()
    cfg = configs.get("smollm-135m")
    model = build_model(cfg, device=cs.DEVICE)
    params = model.init(cs.SEED)
    for mode in args.modes:
        cs.phase_serve(cfg, model, params, mode)
    for mode in args.modes:
        for graphs in (True, False):
            cs.phase_profile(model, params, mode, graphs=graphs)
    del model, params
    cs.phase_train(cfg, eager_steps=EAGER_STEPS)
    # B3 at decode: 8 slots of a 512-slot cache, kv_len as the attention
    # layer passes it (the bucket of the live key range)
    gen = torch.Generator().manual_seed(cs.SEED)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = torch.randn((8, 1, hq, hd), generator=gen).to("cuda", torch.bfloat16)
    k, v = (torch.randn((8, 512, hkv, hd), generator=gen).to(
        "cuda", torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    for lo, hi in ((16, 32), (192, 200)):
        offs = torch.randint(lo, hi + 1, (8,), generator=gen).to(
            "cuda", torch.int32)
        kv_len = fa.kv_bucket(int(offs.max()) + 1, 512)
        rounds = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                ops.flash_attention_prefill(q.transpose(1, 2), k, v, offs,
                                            kv_len=kv_len)
            torch.cuda.synchronize()
            rounds.append((time.perf_counter() - t0) / 200 * 1e6)
        cs.emit({"phase": "host", "kernel": "flash_attention_prefill",
                 "shape": f"B=8 C=1 S=512 offsets {lo}-{hi} kv_len={kv_len}",
                 "us_per_call": statistics.median(rounds[1:]),
                 "rounds_us": rounds[1:]})
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
