"""Training launcher of the port, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 100 --batch 8 --seq 256 [--reduced] [--ckpt DIR]

``--reduced`` runs the small test variant; ``--device cpu`` runs the plain
PyTorch path on the host, eagerly (without it, a machine with no GPU
raises).  On the card the trainer captures its step as a CUDA graph after
one eager warm-up step and replays it (``Trainer(jit=True)``).
Weights are random, drawn from ``--seed``; the data is the synthetic Markov
``TokenStream``.
"""

from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.data import TokenStream
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    opt = adamw(cosine_schedule(args.lr, args.steps, args.warmup))
    data = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                       global_batch=args.batch, seed=args.seed)
    trainer = Trainer(model, opt, data, checkpoint_dir=args.ckpt,
                      checkpoint_every=args.ckpt_every,
                      microbatch=args.microbatch)
    result = trainer.run(args.steps, seed=args.seed)
    hist = result["history"]
    print(f"[train] {args.arch} ({cfg.structure.kind}): "
          f"loss {hist[0]:.4f} → {hist[-1]:.4f} over {len(hist)} steps; CUDA "
          f"graphs captured: {trainer.stats['graphs']} in "
          f"{trainer.stats['capture_s']:.3f}s")
    return result


if __name__ == "__main__":
    main()
