"""Many AdamW steps of one architecture on the CPU, the port against the JAX
package, from the same weights on the same batches:

    PYTHONPATH=src python tests/test_torch_train_witness.py gpt2-blast \
        --layers 2 --seq 64 --grid 3e-4:20,1e-3:20,3e-4:60,1e-3:60

Full width, cut to ``--layers``, fp32 (``--set field=value``: other config
fields, in both packages, e.g. ``--set pos_embed=none``), batch 8 ×
``--seq`` of the port's Markov ``TokenStream`` (the same numpy tokens fed
to both), AdamW with a cosine schedule over each run's steps, warmup 5. The
port's params are the reference's ``LM.init(PRNGKey(0))``
(``weights.from_jax_params``). For each ``lr:steps`` of ``--grid`` it
prints one JSON line: the loss of a batch no step sees (step 10**6) before
and after the run in each package, the first step's loss and the mean of
the last 5 in each, and the largest difference of a step's loss between the
two.

It is the CPU witness for how a family's loss moves over a run (the card's
``train`` phase trains the port alone).  As a test, at gpt2-blast's
reduced widths and one layer, the reference compiled without XLA's backend
optimizations: ten steps of each package at lr 1e-3 give the same losses
(1e-5 relative) and held-out losses.
"""

import argparse
import ast
import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.train import make_train_step as jmake_train_step
from repro.train.loss import make_loss_fn as jmake_loss_fn

from repro_torch import configs, weights
from repro_torch.data import TokenStream
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import make_loss_fn, make_train_step
from test_torch_hybrid import _unoptimized

HELDOUT = 10 ** 6


def run(arch: str, layers: int, seq: int, grid, jit=jax.jit, **over):
    """Yields one row a (lr, steps) of ``grid``: held-out losses before and
    after in each package, and each package's step losses.  ``jit``
    compiles the reference's programs."""
    over = dict(n_layers=layers, param_dtype="float32",
                compute_dtype="float32", remat=False, **over)
    jmodel = jbuild_model(dataclasses.replace(jconfigs.get(arch), **over))
    model = build_model(dataclasses.replace(configs.get(arch), **over),
                        device="cpu")
    tree = jax.tree.map(np.asarray, jit(jmodel.init)(jax.random.PRNGKey(0)))
    data = TokenStream(vocab=model.cfg.vocab, seq_len=seq, global_batch=8,
                       seed=0)
    held = data.batch(HELDOUT)["tokens"]
    jheld = {"tokens": jnp.asarray(held.numpy().astype(np.int32))}
    jloss = jit(lambda p, b: jmake_loss_fn(jmodel)(p, b)[0])
    loss = make_loss_fn(model)
    for lr, steps in grid:
        sched = dict(lr=lr, total_steps=steps, warmup=5)
        jopt, opt = jadamw(jcosine(**sched)), adamw(cosine_schedule(**sched))
        jstep = jit(jmake_train_step(jmodel, jopt, donate=False))
        step = make_train_step(model, opt)
        jp = jax.tree.map(jnp.asarray, tree)
        jo = jopt.init(jp)
        params = weights.from_jax_params(model, tree)
        state = opt.init(params)
        t0 = time.time()
        # the port's run first: once XLA's CPU threads run, torch's first
        # calls slow down
        batches = [data.batch(i)["tokens"] for i in range(steps)]
        pl = []
        with torch.no_grad():
            before = float(loss(params, {"tokens": held})[0])
        for b in batches:
            params, state, m = step(params, state, {"tokens": b})
            pl.append(float(m["loss"]))
        with torch.no_grad():
            after = float(loss(params, {"tokens": held})[0])
        jbefore = float(jloss(jp, jheld))
        jl = []
        for b in batches:
            jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(
                b.numpy().astype(np.int32))})
            jl.append(float(jm["loss"]))
        yield {"lr": lr, "steps": steps,
               "ref_heldout": [jbefore, float(jloss(jp, jheld))],
               "port_heldout": [before, after], "ref_losses": jl,
               "port_losses": pl, "s": time.time() - t0}


def test_gpt2_blast_steps_match_reference():
    (row,) = run("gpt2-blast", 1, 32, [(1e-3, 10)],
                 jit=lambda f: _unoptimized(jax.jit(f)), vocab=512,
                 d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128)
    np.testing.assert_allclose(row["port_losses"], row["ref_losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(row["port_heldout"], row["ref_heldout"],
                               rtol=1e-5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grid", default="3e-4:20,1e-3:20")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    grid = [(float(a), int(b)) for a, b in
            (g.split(":") for g in args.grid.split(","))]
    over = {}
    for item in args.set:
        field, value = item.split("=", 1)
        try:
            over[field] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            over[field] = value
    for row in run(args.arch, args.layers, args.seq, grid, **over):
        jl, pl = row.pop("ref_losses"), row.pop("port_losses")
        print(json.dumps({
            "arch": args.arch, "layers": args.layers, "seq": args.seq,
            "set": args.set, **row,
            "ref_first_last5": [jl[0], float(np.mean(jl[-5:]))],
            "port_first_last5": [pl[0], float(np.mean(pl[-5:]))],
            "max_step_loss_diff": max(abs(a - b) for a, b in zip(jl, pl))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
