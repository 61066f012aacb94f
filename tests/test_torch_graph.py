"""The compiled step's CPU side, against the JAX package on
``smollm-135m.reduced()`` with the reference's ``LM.init(PRNGKey(0))``
weights: the fixed-shape cache write and the kv bucket of
``prefill_chunk``, the engine's static-buffer step (run eagerly here, as
on the CPU it always is), and AdamW with its counter on the params' device
and its branchless NaN guard.  The CUDA graphs themselves are tested on
the card (``tests/test_torch_graph_gpu.py``).

Tolerances: logits ``atol = rtol = 1e-4``; AdamW 1e-5 (the reference's
cut for parameters, as ``tests/test_torch_train.py``).  The cache write is
held bit for bit: on integer weights and inputs both packages compute the
same k and v exactly, so the caches must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro.optim import adamw as jadamw
from repro.optim import cosine_schedule as jcosine

from repro_torch import configs, weights
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from repro_torch.tree import leaves
from test_torch_engine import CHUNKS, MAX_NEW, _prompts, reference  # noqa: F401
from torch_parity import reference_lm

TOL = dict(atol=1e-4, rtol=1e-4)
S = 8
# three ragged chunks of width 5 on 3 rows (steps advance by n): an idle
# row in each chunk, and row 2 ends on the last slot, S - 1
CHUNKS_N = ([2, 0, 5], [0, 4, 3], [3, 1, 0])


@pytest.fixture(scope="module")
def pair():
    jmodel, jparams = reference_lm()
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    return jmodel, jparams, model, weights.from_jax_params(model, tree)


def _device_inputs(steps, n, C):
    """``steps`` and ``n`` as the engine hands them to the device step:
    tensors, and the kv bucket of the largest live position."""
    st, nt, kv = L.chunk_inputs(steps, n, len(n), C, S, "cpu")
    return st, nt, kv


def test_fixed_shape_write_matches_reference_bit_for_bit(pair):
    jmodel, _, model, _ = pair
    jspec = JL.make_attention(dataclasses.replace(jmodel.cfg,
                                                  pos_embed="none"))
    spec = L.make_attention(dataclasses.replace(model.cfg, pos_embed="none"))
    rng = np.random.default_rng(4)
    # small integers everywhere: every product and sum is exact in fp32
    lp = {name: {k: rng.integers(-2, 3, size=shape).astype(np.float32)
                 for k, shape in getattr(spec, name).shapes.items()}
          for name in ("qkv", "out")}
    B, C = 3, 5
    jcache = jax.tree.map(lambda a: a[0], jmodel.init_cache(B, S)[
        "cycles"]["blk_0"]["mixer"])
    cache = L.attn_cache_init(spec, B, S, torch.float32, "cpu")
    tlp = jax.tree.map(torch.from_numpy, lp)
    steps = np.zeros(B, np.int32)
    for n in CHUNKS_N:
        n = np.array(n, np.int32)
        x = rng.integers(-2, 3, size=(B, C, 64)).astype(np.float32)
        jy, jcache = JL.attn_prefill(jspec, lp, jcache, jnp.asarray(x),
                                     jnp.asarray(steps), jnp.asarray(n))
        st, nt, kv = _device_inputs(steps, n, C)
        y, cache = L.attn_prefill(spec, tlp, cache, torch.from_numpy(x),
                                  None, None, rg=L.ragged(st, nt, C, S, kv))
        for key in ("pos", "k", "v"):
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]), key)
        live = np.arange(C)[None, :] < n[:, None]
        np.testing.assert_allclose(y.numpy()[live], np.asarray(jy)[live],
                                   **TOL)
        steps = steps + n
    assert steps[2] == S and int(cache["pos"][2, S - 1]) == S - 1


def _prefills(model, params, kv_of):
    """Logits and cache of three ragged ``prefill_chunk`` steps on device
    tensors, with kv_len = ``kv_of(bucket, live)``."""
    rng = np.random.default_rng(3)
    cache = model.init_cache(3, S)
    steps = np.zeros(3, np.int64)
    out = []
    for n in CHUNKS_N:
        n = np.array(n)
        toks = torch.from_numpy(rng.integers(0, 512, size=(3, 5)))
        st, nt, kv = _device_inputs(steps, n, 5)
        live = int((steps + n)[n > 0].max())
        logits, cache = model.prefill_chunk(params, cache, toks, st, nt,
                                            kv_len=kv_of(kv, live))
        out.append((logits, n > 0))
        steps = steps + n
    return out, cache


def test_prefill_chunk_on_device_inputs_matches_jax(pair):
    jmodel, jparams, model, params = pair
    got, cache = _prefills(model, params, lambda kv, live: kv)
    rng = np.random.default_rng(3)
    jcache = jmodel.init_cache(3, S)
    steps = np.zeros(3, np.int32)
    jstep = jax.jit(jmodel.prefill_chunk)
    for (g, live), n in zip(got, CHUNKS_N):
        n = np.array(n, np.int32)
        toks = rng.integers(0, 512, size=(3, 5)).astype(np.int32)
        w, jcache = jstep(jparams, jcache, toks, steps, n)
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live],
                                   **TOL)
        steps = steps + n
    jlayers = jcache["cycles"]["blk_0"]["mixer"]
    for i, c in enumerate(cache):
        np.testing.assert_array_equal(c["pos"].numpy(),
                                      np.asarray(jlayers["pos"][i]))
        for key in ("k", "v"):
            np.testing.assert_allclose(c[key].numpy(),
                                       np.asarray(jlayers[key][i]), **TOL)


def test_kv_bucket_changes_no_live_logits(pair):
    _, _, model, params = pair
    runs = [_prefills(model, params, pick) for pick in (
        lambda kv, live: kv, lambda kv, live: live, lambda kv, live: S)]
    (base, cache), rest = runs[0], runs[1:]
    for other, other_cache in rest:
        for (a, live), (b, _) in zip(base, other):
            assert torch.equal(a[live], b[live])
        for c, d in zip(cache, other_cache):
            assert all(torch.equal(c[k], d[k]) for k in c)


@pytest.mark.parametrize("live,S_,want", [
    (0, 512, 64), (31, 512, 64), (64, 512, 64), (65, 512, 128),
    (129, 512, 256), (200, 512, 256), (257, 512, 512), (512, 512, 512),
    (150, 192, 192), (5, 32, 32)])
def test_kv_bucket(live, S_, want):
    kv = fa.kv_bucket(live, S_)
    assert kv == want and live <= kv <= S_


@pytest.mark.parametrize("chunk", CHUNKS)
def test_static_buffer_engine_matches_jax_engine(pair, reference, chunk):
    _, _, model, params = pair
    _, outs, safe = reference
    seen = []

    def step(params, cache, tokens, steps, n_tokens, kv_len):
        # the engine's static inputs: views of one buffer, and a bucket
        assert tokens.untyped_storage().data_ptr() == \
            steps.untyped_storage().data_ptr()
        seen.append((tokens.shape[1], kv_len))
        return model.prefill_chunk(params, cache, tokens, steps, n_tokens,
                                   kv_len=kv_len)

    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=chunk),
        memory=MemoryConfig(max_len=64)), device="cpu", step_fn=step)
    reqs = eng.generate_batch(_prompts(), SamplingParams(max_new_tokens=MAX_NEW))
    for r, want, n in zip(reqs, outs[chunk], safe):
        assert r.done and len(r.output) == MAX_NEW
        assert r.output[:n] == want[:n]
    assert eng.stats["graphs"] == 0
    assert len(eng.stats["step_s"]) == eng.stats["steps"] == len(seen)
    assert {kv for _, kv in seen} <= {64}
    assert {c for c, _ in seen} <= {1, 2, 4, 8, 16, 32}


def test_launches_apart_and_add_launches():
    kops.reset_launches()
    kops.launches["blast_matmul"] = 2
    with kops.launches_apart() as made:
        kops.launches["blast_matmul"] += 3
        kops.launches["flash_attention_prefill"] += 1
    assert made == {"blast_matmul": 3, "flash_attention_prefill": 1}
    assert kops.launches["blast_matmul"] == 2
    kops.add_launches(made)
    kops.add_launches(made)
    assert kops.launches["blast_matmul"] == 8
    assert kops.launches["flash_attention_prefill"] == 2
    kops.reset_launches()


def _opt_tree(rng):
    """A small param tree: matrices (decayed) and vectors (not)."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": [{"s": rng.standard_normal((7,)).astype(np.float32),
                        "u": rng.standard_normal((3, 4, 2)).astype(
                            np.float32)} for _ in range(2)]}


def test_adamw_matches_jax_over_three_steps():
    rng = np.random.default_rng(11)
    tree = _opt_tree(rng)
    sched = dict(lr=1e-2, total_steps=10, warmup=2)
    jopt, opt = jadamw(jcosine(**sched)), adamw(cosine_schedule(**sched))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    state = opt.init(params)
    assert state["count"].device == params["w"].device
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), tree)
        jp, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, grads),
                                     jstate, jp)
        params, state, m = opt.update(
            jax.tree.map(torch.from_numpy, grads), state, params)
        assert float(m["skipped"]) == 0.0
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(state["count"]) == int(jstate["count"]) == 3
    for name, got, want in (("params", params, jp), ("m", state["m"],
                                                     jstate["m"]),
                            ("v", state["v"], jstate["v"])):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("bad", ["nan_grad", "inf_loss"])
def test_skipped_step_leaves_state_bit_for_bit(bad):
    rng = np.random.default_rng(12)
    tree = _opt_tree(rng)
    opt = adamw(cosine_schedule(1e-2, 10, 2))
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    state = opt.init(params)

    def grads():
        return jax.tree.map(lambda a: torch.from_numpy(
            rng.standard_normal(a.shape).astype(np.float32)), tree)

    opt.update(grads(), state, params, loss=torch.tensor(1.0))
    before = [t.clone() for t in leaves((params, state["m"], state["v"]))]
    g = grads()
    loss = torch.tensor(1.0)
    if bad == "nan_grad":
        g["layers"][1]["s"][3] = float("nan")
    else:
        loss = torch.tensor(float("inf"))
    _, state, m = opt.update(g, state, params, loss=loss)
    assert float(m["skipped"]) == 1.0 and int(state["count"]) == 2
    for a, b in zip(leaves((params, state["m"], state["v"])), before):
        assert torch.equal(a, b)
    _, state, m = opt.update(grads(), state, params, loss=torch.tensor(1.0))
    assert float(m["skipped"]) == 0.0 and int(state["count"]) == 3
    assert not torch.equal(params["w"], before[0])


def test_write_needs_the_spare_slot():
    """A cache leaf without the spare slot raises instead of writing past
    its storage."""
    rg = L.ragged(torch.zeros(2, dtype=torch.int64),
                  torch.tensor([1, 0]), 3, 4, 64)
    with pytest.raises(RuntimeError):
        L._write(torch.zeros((2, 4, 1, 2)), rg, torch.ones((2, 3, 1, 2)))
    cache = torch.zeros((2, 5, 1, 2))[:, :4]
    L._write(cache, rg, torch.ones((2, 3, 1, 2)))
    assert float(cache.sum()) == 2.0 and float(cache[0, 0].sum()) == 2.0
