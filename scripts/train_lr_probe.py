#!/usr/bin/env python3
"""Whether a family's captured training lowers the loss of data it has not
seen, at a few learning rates and run lengths, on one card:

    python3 scripts/train_lr_probe.py [--arch gpt2-blast] [--layers 12]

Runs ``chip_smoke.py``'s ``train`` phase (full width, bf16, remat, batch
8 × 256 of the Markov ``TokenStream``, AdamW with a cosine schedule over
the run's steps, warmup 5) once per (lr, steps) of ``GRID`` and prints, per
run: the loss of a batch no step sees (``HELDOUT_BATCH``) before and after
the run, the first step's loss and the mean of the last 5, and the median
step ms.  A run whose held-out loss does not fall is reported, not raised.
Then the card's name and power limit.  It builds the kernels as
``chip_smoke.py`` does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (lr, steps)
GRID = ((3e-4, 60), (1e-3, 20), (1e-3, 60), (3e-3, 20), (3e-3, 60))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gpt2-blast")
    ap.add_argument("--layers", type=int, default=12)
    args = ap.parse_args()
    import chip_smoke as cs
    _, smi = cs.phase_device()
    from repro_torch import configs
    rows = []
    cs.emit = lambda obj: (rows.append(obj) if obj.get("phase") == "train"
                           else None)
    cs.phase_build()
    cfg = configs.get(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=min(args.layers, cfg.n_layers))
    for lr, steps in GRID:
        try:
            cs.phase_train(cfg, steps, profile=False, lr=lr)
            note = "ok"
        except RuntimeError as exc:
            note = str(exc)
        r = rows[-1]
        print(json.dumps({
            "arch": args.arch, "layers": cfg.n_layers, "lr": lr,
            "steps": steps, "heldout_before": r["heldout_loss_before"],
            "heldout_after": r["heldout_loss_after"],
            "first_loss": r["losses"][0],
            "last5_mean_loss": statistics.fmean(r["losses"][-5:]),
            "median_step_ms_after_3": r["median_step_ms_after_3"],
            "phase": note}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
