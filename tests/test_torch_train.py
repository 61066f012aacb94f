"""The port's training path on the CPU against the JAX package: the
full-sequence ``LM.apply``, the loss and its gradients, the schedule and
optimizer, three train steps, and the trainer's behaviours (the reference's
``tests/test_trainer_serve.py::TestTrainer`` run on the port), the data
stream, checkpoints and the launcher.

Both packages get the same weights (the reference's reduced smollm-135m
``LM.init``, carried over by ``weights.from_jax_params``) and the same numpy
tokens.  Tolerances (fp32): logits 1e-4; loss and accuracy 1e-5; each
gradient 1e-4 × its leaf's largest entry; after three AdamW steps every
parameter within 1e-5, except entries whose reference gradient was below
1e-6 × its leaf's largest at some step — there Adam's step is the sign of
rounding noise (|m̂/√v̂| ≈ 1 on a gradient of ~0), so those are bounded by
lr × steps.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine
from repro.optim.adamw import global_norm as jglobal_norm
from repro.train import make_train_step as jmake_train_step
from repro.train.loss import make_loss_fn as jmake_loss_fn

from repro_torch import configs, quant, weights
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save
from repro_torch.data import TokenStream
from repro_torch.launch import train as train_launch
from repro_torch.models import build_model
from repro_torch.optim import (adamw, constant_schedule, cosine_schedule,
                               global_norm)
from repro_torch.train import Trainer, make_loss_fn, make_train_step
from repro_torch.tree import leaves
from torch_parity import reference_lm

TOL = dict(atol=1e-4, rtol=1e-4)
LR, STEPS = 3e-3, 3


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, numpy tree of the params)."""
    jmodel, jparams = reference_lm()
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    return jmodel, jparams, model, jax.tree.map(np.asarray, jparams)


def _tokens(seed, B=2, T=33):
    return np.random.default_rng(seed).integers(0, 512, size=(B, T)).astype(
        np.int32)


def test_reduced_training_fields_match_reference(pair):
    jmodel, _, model, _ = pair
    for f in ("remat", "q_chunk", "kv_chunk"):
        assert getattr(model.cfg, f) == getattr(jmodel.cfg, f), f
    full = configs.get("smollm-135m")
    assert (full.remat, full.q_chunk, full.kv_chunk) == (True, 512, 1024)


def test_apply_logits_match_jax(pair):
    jmodel, jparams, model, tree = pair
    params = weights.from_jax_params(model, tree)
    toks = _tokens(0, T=40)
    want = np.asarray(jax.jit(lambda p, t: jmodel.apply(p, t).logits)(
        jparams, jnp.asarray(toks)))
    with torch.no_grad():
        out = model.apply(params, torch.from_numpy(toks))
    assert out.mtp_logits is None and float(out.aux) == 0.0
    np.testing.assert_allclose(out.logits.numpy(), want, **TOL)


def test_last_only_equals_prefill_chunk(pair):
    """B4's path (apply, last_only) against B3's (prefill_chunk at offset 0
    over the whole prompt)."""
    _, _, model, tree = pair
    params = weights.from_jax_params(model, tree)
    toks = torch.from_numpy(_tokens(1, B=3, T=21))
    with torch.no_grad():
        got = model.apply(params, toks, last_only=True).logits
    want, _ = model.prefill_chunk(params, model.init_cache(3, 21), toks,
                                  [0, 0, 0], [21, 21, 21])
    assert got.shape == want.shape == (3, 1, 512)
    torch.testing.assert_close(got, want, **TOL)


def _jax_loss_and_grads(jmodel, jparams, toks):
    fn = jax.jit(jax.value_and_grad(jmake_loss_fn(jmodel), has_aux=True))
    return fn(jparams, {"tokens": jnp.asarray(toks)})


def _grad_fn_names(t) -> list[str]:
    seen, names, todo = set(), [], [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(fn.name())
        todo += [nxt for nxt, _ in fn.next_functions]
    return names


def test_loss_and_grads_match_jax(pair):
    jmodel, jparams, model, tree = pair
    params = weights.from_jax_params(model, tree)
    toks = _tokens(2)
    (jloss, jmet), jgrads = _jax_loss_and_grads(jmodel, jparams, toks)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, met = make_loss_fn(model)(params, {"tokens": torch.from_numpy(toks)})
    # every BLAST linear, the gate+up bundle and attention go through the
    # three autograd Functions: per layer 3, 1 and 1
    names = _grad_fn_names(loss)
    L = model.cfg.n_layers
    assert names.count("BlastMatmulFnBackward") == 3 * L
    assert names.count("BlastMatmulGroupedFnBackward") == L
    assert names.count("FlashAttentionFnBackward") == L
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for k in ("ce", "acc", "aux", "loss"):
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    grads = torch.autograd.grad(loss, leaves(params))
    want = leaves(weights.from_jax_params(model,
                                          jax.tree.map(np.asarray, jgrads)))
    assert len(grads) == len(want) == 2 + 17 * L
    for g, w in zip(grads, want):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_schedule_and_global_norm_match_jax(pair):
    for args in ((3e-4, 20, 5), (1e-3, 7, 0), (2e-3, 10, 10, 1e-4)):
        j, t = jcosine(*args), cosine_schedule(*args)
        for step in range(0, 25):
            np.testing.assert_allclose(
                float(t(torch.tensor(step, dtype=torch.int32))),
                float(j(jnp.asarray(step, jnp.int32))), rtol=1e-6)
    _, jparams, model, tree = pair
    np.testing.assert_allclose(
        float(global_norm(weights.from_jax_params(model, tree))),
        float(jglobal_norm(jparams)), rtol=1e-6)


def test_three_train_steps_match_jax(pair):
    jmodel, jparams, model, tree = pair
    sched = dict(lr=LR, total_steps=10, warmup=1)
    jopt = jadamw(jcosine(**sched))
    jstep = jax.jit(jmake_train_step(jmodel, jopt))
    jgrad = jax.jit(jax.grad(lambda p, b: jmake_loss_fn(jmodel)(p, b)[0]))
    opt = adamw(cosine_schedule(**sched))
    step = make_train_step(model, opt)
    params = weights.from_jax_params(model, tree)
    state = opt.init(params)
    jp, jo = jparams, jopt.init(jparams)
    noise = None                  # entries with a ~0 reference gradient
    for i in range(STEPS):
        batch = {"tokens": _tokens(10 + i, B=4)}
        g = weights.from_jax_params(model, jax.tree.map(
            np.asarray, jgrad(jp, {"tokens": jnp.asarray(batch["tokens"])})))
        tiny = [a.abs() < 1e-6 * a.abs().max() for a in leaves(g)]
        noise = tiny if noise is None else [a | b for a, b in zip(noise,
                                                                  tiny)]
        jp, jo, jm = jstep(jp, jo, {"tokens": jnp.asarray(batch["tokens"])})
        params, state, m = step(params, state,
                                {"tokens": torch.from_numpy(batch["tokens"])})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["skipped"]) == 0.0
    assert int(state["count"]) == STEPS
    want = leaves(weights.from_jax_params(model, jax.tree.map(np.asarray,
                                                              jp)))
    n_noise = 0
    for got, w, nz in zip(leaves(params), want, noise):
        err = (got.detach() - w).abs()
        assert float(torch.where(nz, 0.0, err).max()) <= 1e-5
        assert float(torch.where(nz, err, 0.0).max()) <= LR * STEPS
        n_noise += int(nz.sum())
    assert n_noise < 0.01 * sum(p.numel() for p in want)


# -- the trainer's behaviours (the reference's TestTrainer, on the port) ------


def tiny_cfg():
    return configs.get("smollm-135m").reduced(
        vocab=64, d_model=32, n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1)


def _data(cfg, batch=8, seq=32):
    return TokenStream(vocab=cfg.vocab, seq_len=seq, global_batch=batch)


def test_loss_decreases_on_markov_stream():
    cfg = tiny_cfg()
    trainer = Trainer(build_model(cfg, device="cpu"),
                      adamw(cosine_schedule(3e-3, 60, 5)), _data(cfg),
                      log_every=1000)
    hist = trainer.run(60)["history"]
    assert hist[-1] < hist[0] - 0.3, (hist[0], hist[-1])


def test_checkpoint_restart_matches_straight_run(tmp_path):
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    opt = adamw(constant_schedule(1e-3))
    ckpt = str(tmp_path / "ckpt")
    Trainer(model, opt, _data(cfg), checkpoint_dir=ckpt, checkpoint_every=2,
            log_every=1000).run(10)
    # keep=3: steps 5, 7 and 9 remain
    assert sorted(os.listdir(ckpt)) == [f"step_{s:08d}" for s in (5, 7, 9)]
    out2 = Trainer(model, opt, _data(cfg), checkpoint_dir=ckpt,
                   checkpoint_every=5, log_every=1000).run(15)
    assert len(out2["history"]) == 5
    out3 = Trainer(model, opt, _data(cfg), log_every=1000).run(15)
    np.testing.assert_allclose(out2["history"], out3["history"][10:],
                               rtol=1e-6)
    assert int(out2["opt_state"]["count"]) == 15
    for a, b in zip(leaves(out2["params"]), leaves(out3["params"])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_nan_guard_skips_update():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    opt = adamw(constant_schedule(1e-3))
    step = make_train_step(model, opt)
    params = model.init(0)
    params["embed"][0, 0] = float("nan")
    before = [p.clone() for p in leaves(params)]
    state = opt.init(params)
    params, state, m = step(params, state,
                            {"tokens": torch.zeros((2, 33), dtype=torch.int64)})
    assert float(m["skipped"]) == 1.0 and int(state["count"]) == 1
    for a, b in zip(leaves(params), before):
        torch.testing.assert_close(a.detach(), b, equal_nan=True, atol=0,
                                   rtol=0)
    assert all(float(t.abs().max()) == 0.0 for t in leaves(state["m"]))


def test_microbatch_accumulation_matches_full():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    opt = adamw(constant_schedule(1e-3))
    batch = _data(cfg).batch(0)
    p1, p2 = model.init(0), model.init(0)
    _, _, m1 = make_train_step(model, opt)(p1, opt.init(p1), batch)
    _, _, m2 = make_train_step(model, opt, microbatch=4)(p2, opt.init(p2),
                                                         batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for a, b in zip(leaves(p1), leaves(p2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_quantized_params_raise():
    cfg = tiny_cfg()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    qp = model.quantize_params(params, quant.QuantConfig(weights="int8"))
    opt = adamw(constant_schedule(1e-3))
    with pytest.raises(NotImplementedError, match="float params"):
        make_train_step(model, opt)(qp, opt.init(params), _data(cfg).batch(0))


def test_token_stream_is_counter_indexed():
    s = TokenStream(vocab=97, seq_len=40, global_batch=8, seed=3)
    a = s.batch(5)["tokens"]
    assert a.shape == (8, 41) and a.dtype == torch.int64
    assert torch.equal(a, s.batch(5)["tokens"])
    assert not torch.equal(a, s.batch(6)["tokens"])
    assert not torch.equal(a, TokenStream(97, 40, 8, seed=4).batch(5)["tokens"])
    sh = [s.batch(5, shard=i, n_shards=2)["tokens"] for i in range(2)]
    assert sh[0].shape == (4, 41) and not torch.equal(sh[0], sh[1])
    assert torch.equal(sh[1], s.batch(5, shard=1, n_shards=2)["tokens"])
    # the law: token t+1 follows the vocab-seeded permutation with
    # probability 1 - noise (+ noise / vocab by chance)
    perm = torch.randperm(97, generator=torch.Generator().manual_seed(97))
    big = TokenStream(vocab=97, seq_len=200, global_batch=64).batch(0)["tokens"]
    follow = (perm[big[:, :-1]] == big[:, 1:]).float().mean()
    assert abs(float(follow) - (0.9 + 0.1 / 97)) < 0.01


def test_checkpoint_format_is_the_reference_one(tmp_path):
    """The port writes the reference's layout (manifest, '/'-joined leaf
    paths, bf16 as u2 bit patterns) — the reference's ``restore`` reads it
    back — and restores into its own tree."""
    tree = {"params": {"w": torch.randn(3, 4).to(torch.bfloat16),
                       "layers": [{"s": torch.arange(5.0)}]},
            "count": torch.tensor(7, dtype=torch.int32)}
    path = save(str(tmp_path), 12, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["leaves"]
    assert meta["params/w"]["dtype"] == "bfloat16"
    assert meta["params/layers/0/s"]["file"] == "params__layers__0__s.npy"
    assert latest_step(str(tmp_path)) == 12
    want = jstore.restore(str(tmp_path), 12, {
        "params": {"w": 0, "layers": [{"s": 0}]}, "count": 0})
    np.testing.assert_array_equal(np.asarray(want["params"]["w"], np.float32),
                                  tree["params"]["w"].float().numpy())
    got = restore(str(tmp_path), 12, tree)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert int(got["count"]) == 7
    mgr = CheckpointManager(str(tmp_path / "m"), keep=2)
    for s in range(4):
        mgr.save(s, tree)
    restored, step = mgr.restore_latest(tree)
    assert step == 3 and torch.equal(restored["params"]["layers"][0]["s"],
                                     tree["params"]["layers"][0]["s"])
    assert sorted(os.listdir(tmp_path / "m")) == ["step_00000002",
                                                  "step_00000003"]


def test_launcher_trains_on_cpu(capsys):
    out = train_launch.main(["--arch", "smollm-135m", "--reduced", "--device",
                             "cpu", "--steps", "3", "--batch", "2", "--seq",
                             "16"])
    assert len(out["history"]) == 3
    assert "over 3 steps" in capsys.readouterr().out


def test_launcher_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launch.main(["--arch", "smollm-135m", "--reduced", "--steps",
                           "1"])
