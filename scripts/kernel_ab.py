#!/usr/bin/env python3
"""Time the kernels of the smollm-135m main path from one source tree, so
that two trees can be compared on one card.

    python3 scripts/kernel_ab.py --src PATH/src --label NAME

Imports ``repro_torch`` from ``--src``, and the timing harness of
``chip_smoke.py`` from this checkout, builds that tree's kernels, and
prints one JSON line per row: bf16, the L2 cache flushed, the median of 25
runs (``chip_smoke.time_ms``) of each BLAST wrapper in every serving mode
at decode (T = 8) and prefill (T = 256) shapes, of the W8A8 and W4A8
kernels alone on ready activation codes there (``... launch_only``: the
tree's own ``launch_w8a8`` / ``launch_w4a8``: xq, sx, the codes padded to
the rank granule, their scales and out_dtype), of
the float BLAST kernels at the training step's 2048 tokens, and of prefill
(C = 1, 32) and full-sequence (B = 8 × T = 256, B = 1 × T = 2048)
attention.  Every tree gets the same inputs (one seed).  Two calls may land on two cards, so run
the trees in turns (A, B, B, A) within one process group on one card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="the tree's src directory")
    ap.add_argument("--label", required=True, help="name printed on each row")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import torch

    import chip_smoke as cs
    from repro_torch import configs, quant
    from repro_torch.kernels import blast_matmul as bm
    from repro_torch.kernels import build, ops
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    build.build_all()
    cfg = configs.get("smollm-135m")
    gen = torch.Generator().manual_seed(cs.SEED + 2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    dt = torch.bfloat16

    def row(kernel, linear, T, fn):
        print(json.dumps({"label": args.label, "kernel": kernel,
                          "linear": linear, "T": T,
                          "ms": cs.time_ms(fn, flush)}), flush=True)

    def launch_only(name, T, x, U, S, V):
        xq, sx = quant.quantize_act(x)
        for mode in ("w8a8", "w4a8"):
            bits = cs.mode_bits_act(mode)[0]
            codes, scales = cs.quantize_factors(U, S, V, bits=bits)
            _, stored = bm.padded_rank(codes[0].shape[-1], bits,
                                       bm.float_tiles()[1])
            padded = [ops._pad_last(a, stored) for a in codes]
            launch = bm.launch_w4a8 if bits == 4 else bm.launch_w8a8
            row(f"{cs.MODES[mode][1][U.shape[0] > 1]} launch_only", name, T,
                lambda: launch(xq, sx, *padded, *scales, out_dtype=dt))

    train_t = cs.TRAIN_BATCH * cs.TRAIN_SEQ
    for name, n, m, b, r, G in cs.blast_shapes(cfg):
        for T in (8, 256, train_t):
            x, U, S, V = cs.make_blast_inputs(n, m, b, r, G, T, dt, gen,
                                              "cuda")
            modes = cs.QUANT_MODES if T != train_t else ()
            for kname, kern, _ in cs.blast_calls(x, U, S, V, r, modes):
                row(kname, name, T, kern)
            if T != train_t:
                launch_only(name, T, x, U, S, V)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    for C in (1, 32):
        q, k, v, offs = cs.make_attn_inputs(8, hq, hkv, C, 512, hd, dt, gen,
                                            "cuda")
        row("flash_attention_prefill", "attn", 8 * C,
            lambda: ops.flash_attention_prefill(q, k, v, offs))
    for B, T in ((8, 256), (1, 2048)):
        q, k, v = cs.make_full_attn_inputs(B, hq, hkv, T, T, hd, dt, gen,
                                           "cuda")
        row("flash_attention", "attn", B * T,
            lambda: ops.flash_attention(q, k, v))
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
