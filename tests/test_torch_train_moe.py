"""MoE training on the CPU: the batched expert Function alone, three AdamW
steps and a microbatched step of granite-moe-1b-a400m against the JAX
package's ``make_train_step``, remat, and the launcher.

- ``BlastMatmulBatchedFn`` (``kernels/ops.py``) against torch.autograd
  through the batched plain version: each expert on its own rows, some of
  them zero (empty capacity slots), ranks that the card pads (12, 24); dx
  equal to a per-expert ``_blast_dx`` (B1 over the transposed factors) and
  zero rows adding nothing to dU, dS, dV.  Within 1e-6 × each gradient's
  largest entry.
- Three AdamW steps at the reduced config (4 experts top-2, capacity 1.25)
  within 1e-5 of the reference's ``make_train_step``, as
  ``test_torch_train.py::test_three_train_steps_match_jax`` holds
  smollm-135m, with the trainer's weight-decay rule (``LM.decay_mask``:
  the reference decays the vectors of its stacked cycles, norm scales
  included); then one step at ``microbatch=2``, where each microbatch
  routes with its own capacity.  Entries whose clipped reference gradient
  was below ``NOISE`` = 10 × Adam's eps (1e-8) at some step are bounded by
  lr × steps: there the step g/(|g| + eps) turns rounding of ~1e-9 into
  step differences above 1e-5 (an expert's S entry of 3.95e-8 after
  clipping, 2e-5 × its leaf's largest: 6.37e-8 here before clipping,
  6.53e-8 in the reference, a step 1.18e-5 apart).  They are < 0.1% of
  the entries.
- ``remat=True`` (each layer recomputed in the backward pass, routing
  again) gives the loss and gradients of ``remat=False`` bit for bit.
- ``launch/train.py --arch granite-moe-1b-a400m --reduced --device cpu``
  trains and its loss falls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.train import make_train_step as jmake_train_step
from repro.train.loss import make_loss_fn as jmake_loss_fn

from repro_torch import weights
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model, moe
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import make_loss_fn, make_train_step
from repro_torch.tree import leaves
from test_torch_hybrid import _unoptimized
from test_torch_moe import moe_reference

LR, STEPS = 3e-3, 3
NOISE = 1e-7


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("r", [12, 24])
def test_batched_fn_grads_equal_plain(r):
    rng = np.random.default_rng(r)
    E, T, b, p, q = 3, 7, 4, 6, 8

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, U, S, V = t(E, T, b * q), t(E, b, p, r), t(E, b, b, r), t(E, b, q, r)
    x[0, -2:] = 0.0                    # empty capacity slots
    x[2, -1] = 0.0
    dy = t(E, T, b * p)
    a = [v.clone().requires_grad_(True) for v in (x, U, S, V)]
    w = [v.clone().requires_grad_(True) for v in (x, U, S, V)]
    y = ops.blast_matmul_batched(*a)
    assert y.grad_fn.name() == "BlastMatmulBatchedFnBackward"
    got = torch.autograd.grad(y, a, dy)
    want = torch.autograd.grad(ref.blast_matmul_batched_ref(*w), w, dy)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape
        assert _rel(g, w_) <= 1e-6
    # dx: each expert's own rows, B1 over its transposed factors
    per = torch.stack([ops._blast_dx(dy[e], U[e], S[e], V[e])
                       for e in range(E)])
    assert _rel(got[0], per) <= 1e-6
    # the zero rows add nothing to the factors' gradients
    keep = [torch.arange(T - 2), torch.arange(T), torch.arange(T - 1)]
    for e in range(E):
        one = [v[e:e + 1].clone().requires_grad_(True) for v in (U, S, V)]
        ye = ops.blast_matmul_batched(x[e:e + 1, keep[e]], *one)
        alone = torch.autograd.grad(ye, one, dy[e:e + 1, keep[e]])
        for g, w_ in zip(got[1:], alone):
            assert _rel(g[e:e + 1], w_) <= 1e-6


def _tokens(seed, B=4, T=33):
    return np.random.default_rng(seed).integers(0, 512, (B, T)).astype(
        np.int32)


def _noise(model, g):
    """Entries whose gradient, clipped to norm 1 as AdamW clips it, is
    below ``NOISE``."""
    g = leaves(weights.from_jax_params(model, jax.tree.map(np.asarray, g)))
    scale = min(1.0, 1.0 / float(torch.sqrt(sum((a ** 2).sum() for a in g))))
    return [a.abs() * scale < NOISE for a in g]


def _assert_params_close(params, jp, model, noise, lr_steps):
    want = leaves(weights.from_jax_params(model, jax.tree.map(np.asarray,
                                                              jp)))
    n_noise = 0
    for got, w, nz in zip(leaves(params), want, noise):
        err = (got.detach() - w).abs()
        assert float(torch.where(nz, 0.0, err).max()) <= 1e-5
        assert float(torch.where(nz, err, 0.0).max()) <= lr_steps
        n_noise += int(nz.sum())
    assert n_noise < 1e-3 * sum(w.numel() for w in want)


def test_train_steps_match_jax():
    jmodel, tree, model, _ = moe_reference()
    sched = dict(lr=LR, total_steps=10, warmup=1)
    jopt = jadamw(jcosine(**sched))
    jgrad = _unoptimized(jax.jit(jax.grad(
        lambda p, b: jmake_loss_fn(jmodel)(p, b)[0])))
    opt = adamw(cosine_schedule(**sched))
    jsteps = {mb: _unoptimized(jax.jit(jmake_train_step(
        jmodel, jopt, microbatch=mb, donate=False))) for mb in (0, 2)}
    jp = jax.tree.map(jnp.asarray, tree)
    jo = jopt.init(jp)
    params = weights.from_jax_params(model, tree)     # fresh leaves
    state = opt.init(params)
    noise = None
    for i, mb in enumerate([0] * STEPS + [2]):
        batch = _tokens(10 + i)
        jbatch = {"tokens": jnp.asarray(batch)}
        tiny = _noise(model, jgrad(jp, jbatch))
        noise = tiny if noise is None else [a | b for a, b in zip(noise,
                                                                  tiny)]
        jp, jo, jm = jsteps[mb](jp, jo, jbatch)
        params, state, m = make_train_step(model, opt, microbatch=mb)(
            params, state, {"tokens": torch.from_numpy(batch).long()})
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["skipped"]) == 0.0
        _assert_params_close(params, jp, model, noise, LR * (i + 1))
    assert int(state["count"]) == STEPS + 1


def test_remat_equals_no_remat(monkeypatch):
    """With remat each layer's forward runs again in the backward pass and
    routes again: the same experts and capacity positions, so the loss and
    every gradient equal the run without remat bit for bit."""
    _, tree, model, _ = moe_reference()
    routed = []
    real = moe._route
    monkeypatch.setattr(moe, "_route",
                        lambda *a: routed.append(1) or real(*a))
    toks = torch.from_numpy(_tokens(3)).long()
    out = {}
    for remat in (False, True):
        m = build_model(dataclasses.replace(model.cfg, remat=remat),
                        device="cpu")
        params = weights.from_jax_params(m, tree)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        routed.clear()
        loss, _ = make_loss_fn(m)(params, {"tokens": toks})
        grads = torch.autograd.grad(loss, flat)
        out[remat] = (loss.detach(), grads, len(routed))
    L = model.cfg.n_layers
    assert out[False][2] == L and out[True][2] == 2 * L
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][1], out[True][1]))


def test_launcher_trains_moe_on_cpu(capsys):
    out = train_launch.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                             "--device", "cpu", "--steps", "8", "--batch",
                             "4", "--seq", "32", "--lr", "3e-3", "--warmup",
                             "1"])
    hist = out["history"]
    assert len(hist) == 8 and all(np.isfinite(hist))
    assert np.mean(hist[-3:]) < hist[0]
    assert "over 8 steps" in capsys.readouterr().out
