"""The ssm family's serving modes in the port against the JAX package, in
fp32 on the CPU, on the reduced mamba2-130m of ``tests/test_torch_ssd.py``
(``ssd_reference``: vocab 64, d_model 32, 2 SSD layers, its weights drawn
by numpy in the layout of the reference's ``LM.init``):

- engine tokens equal the JAX engine's at chunk 1, 8 and 32 with float
  weights and at chunk 8 with int8, int4 and W8A8 weights, up to each
  request's first output whose reference margin is below 1e-4;
- the int8 cache: the port's engine ticked beside the JAX engine,
  slot-static and paged, every state within one code step after every
  tick (then shared, ``share_state``, ROADMAP C10) and the tokens equal;
- the paged engine beside the JAX paged engine tick by tick (every leaf a
  state leaf, the pool nominal): tables, free lists, prefix entries and
  their snapshot slots, every state leaf, tokens; a request hits a
  registered prefix and restores its snapshot;
- the reference's ``test_state_family_snapshot_sharing`` case: four
  requests sharing a 16-token prefix through snapshot slots give the
  unshared engine's and the JAX engine's tokens;
- the speculative engine (k = 4, frac 0.2: drafts rejected, so the SSD
  state is rolled back) slot-static and paged, float and over the int8
  cache, ticked beside one JAX paged speculative engine a cache mode:
  counters, slots, every leaf of the target's and the draft's caches,
  tokens;
- the launcher serving ``--arch mamba2-130m`` in every mode, and
  ``_reset_slot`` zeroing a row's state.

The JAX programs compile without backend optimizations, each at one shape
(``_unoptimized``, ``_padded``, ``_fixed``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.core import structures as jstructures
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SpeculativeConfig as JSpeculativeConfig

from repro_torch import quant
from repro_torch.launch import serve
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SamplingParams, SchedulerConfig,
                               SpeculativeConfig)
from test_torch_hybrid import _padded, _unoptimized
from test_torch_hybrid_serving import (_fixed, _leaf_close,
                                        _paged_lockstep, _spec_fixed)
from test_torch_ssd import cache_leaves, share_state, ssd_reference, variant
from torch_parity import MARGIN, MAX_NEW

VOCAB = 64
QUANT = {"none": ("none", "none"), "int8": ("int8", "none"),
         "int4": ("int4", "none"), "w8a8": ("int8", "int8")}


def prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, VOCAB, size=n)]
            for n in (3, 17, 9, 30, 1, 12)]


@functools.lru_cache(maxsize=None)
def _jprograms(jmodel, act: str):
    """The reference's ``prefill_chunk`` and full-sequence logits, compiled
    once per activation mode (it is read when a program is traced; a fresh
    function, so that no trace of another mode is reused)."""
    jstructures.set_activations(act)
    try:
        step = _unoptimized(jax.jit(lambda *a: jmodel.prefill_chunk(*a)))
        logits = _unoptimized(jax.jit(lambda p, t: jmodel.apply(p, t)
                                      .logits))
    finally:
        jstructures.set_activations("none")

    def with_act(fn):
        def call(*args):
            jstructures.set_activations(act)
            try:
                return fn(*args)
            finally:
                jstructures.set_activations("none")
        return call
    return with_act(step), with_act(logits)


def _margins(logits_fn, params, outs):
    """For each prompt, how many leading outputs the reference's
    full-sequence forward predicts with a top-1/top-2 margin >= MARGIN."""
    seqs = [p + o for p, o in zip(prompts(), outs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(logits_fn(params, jnp.asarray(toks)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(prompts()):
        low = np.nonzero(margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
                         < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    return safe


@pytest.mark.parametrize("C,mode", [(1, "none"), (8, "none"), (32, "none"),
                                    (8, "int8"), (8, "int4"), (8, "w8a8")])
def test_engine_tokens_equal_jax(C, mode):
    jmodel, tree, model, params = ssd_reference()
    weights_mode, act = QUANT[mode]
    step, logits = _jprograms(jmodel, act)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=4, chunk_size=C),
        memory=JMemoryConfig(max_len=64),
        quant=jq.QuantConfig(weights=weights_mode, activations=act)),
        step_fn=_padded(step, C))
    want = [list(r.output) for r in jeng.generate_batch(
        prompts(), JSamplingParams(max_new_tokens=MAX_NEW))]
    safe = _margins(logits, jeng.params, want)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=C),
        memory=MemoryConfig(max_len=64),
        quant=quant.QuantConfig(weights=weights_mode, activations=act)),
        device="cpu")
    assert eng.act_mode == act
    got = eng.generate_batch(prompts(), SamplingParams(
        max_new_tokens=MAX_NEW))
    assert all(r.done and len(r.output) == MAX_NEW for r in got)
    for r, w, n in zip(got, want, safe):
        assert r.output[:n] == w[:n], (C, mode, r.output, w, n)


# -- tick by tick ---------------------------------------------------------------


def _jtarget(jeng):
    """The JAX engine's cache tree: slot-static, or the paged pool and
    state leaves merged."""
    pc = jeng._pc
    if pc is None:
        return jeng.cache
    return jax.tree.unflatten(pc.treedef, pc._merge(pc.pool, pc.static))


def _caches_equal(model, cache, jtree, what):
    """Every leaf of the port's per-layer ``cache`` against the reference
    tree's: floats within 1e-4; an int8 state within one code step, then
    shared (``share_state``)."""
    jtree = jax.tree.map(np.asarray, jtree)
    for i, c in enumerate(cache):
        ref = cache_leaves(jtree, i)
        assert set(c) == set(ref), (what, i)
        if model.cfg.cache_quant:
            share_state(c, ref, f"{what} {i}")
            continue
        for name, leaf in c.items():
            _leaf_close(leaf, ref[name], f"{what}: {i}/{name}")


def _requests():
    """(uid, prompt, max_new): prompts of 5–14 tokens, budgets that end
    rows in different ticks."""
    rng = np.random.default_rng(41)
    return [(i, [int(t) for t in rng.integers(0, VOCAB, n)], m)
            for i, (n, m) in enumerate([(14, 9), (5, 13), (10, 8)])]


def _mem(paged, **kw):
    return dict(max_len=64, paged=paged, page_size=8, prefix_sharing=False,
                **kw)


@pytest.mark.parametrize("paged", [False, True],
                         ids=["slot-static", "paged"])
def test_int8_cache_lockstep(paged):
    """The int8 cache: the port's engine ticked beside the JAX engine;
    after every tick each slot's request, output and position and every
    state (shared, ``share_state``) agree; the tokens are equal."""
    _, tree, _, params = ssd_reference()
    jmodel, model = variant("int8")
    sched = dict(slots=2, chunk_size=8)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(**sched),
        memory=JMemoryConfig(**_mem(paged))),
        step_fn=_padded(_jprograms(jmodel, "none")[0], 8))
    if paged:
        jeng._paged_step = _fixed(jeng, 8)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(**sched), memory=MemoryConfig(
            **_mem(paged))), device="cpu")
    for uid, prompt, max_new in _requests():
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    tick = 0
    while True:
        more = jeng.tick()
        assert eng.tick() == more, tick
        assert [None if s.req is None else (s.req.uid, s.req.output, s.pos)
                for s in eng.slots] == [
            None if s.req is None else (s.req.uid, list(s.req.output), s.pos)
            for s in jeng.slots], tick
        _caches_equal(model, eng._pc.view if paged else eng.cache,
                      _jtarget(jeng), f"tick {tick}")
        tick += 1
        if not more:
            break
    assert {r.uid: r.output for r in eng.finished} == {
        r.uid: list(r.output) for r in jeng.finished}


def test_paged_engine_matches_jax():
    """Every leaf a state leaf, so the pool is nominal; request 2 shares
    request 0's registered 16-token prefix and restores its snapshot (the
    default boundary: the prompt less its last token, down to a page)."""
    jmodel, tree, model, params = ssd_reference()
    mem = dict(max_len=64, paged=True, page_size=8, snap_slots=2)
    sched = dict(slots=2, chunk_size=8)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(**sched), memory=JMemoryConfig(**mem)))
    jeng._paged_step = _fixed(jeng, 8)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(**sched), memory=MemoryConfig(**mem)),
        device="cpu")
    pc = eng._pc
    assert pc.has_state and not pc.has_paged and not pc.layers
    rng = np.random.default_rng(5)

    def toks(n):
        return [int(t) for t in rng.integers(0, VOCAB, n)]
    shared = toks(16)
    schedule = {0: [(0, shared + toks(4), 6), (1, toks(11), 5)],
                5: [(2, shared + toks(5), 6), (3, toks(3), 4)]}
    reqs, want = _paged_lockstep(jeng, eng, schedule, leaves=cache_leaves)
    assert eng.stats["prefix_hit_tokens"] == 16
    assert {r.uid: r.output for r in reqs} == want


def test_state_family_snapshot_sharing():
    """The reference's ``tests/test_paged.py::
    test_state_family_snapshot_sharing``: four requests sharing a 16-token
    prefix with the ``prefix_len`` hint, paged with snapshot slots, give
    the unshared slot-static engine's tokens and the JAX paged engine's,
    with 3·16 prefix-hit tokens."""
    jmodel, tree, model, params = ssd_reference()
    shared = [(i * 5 + 1) % VOCAB for i in range(16)]

    def config(paged, cls=(EngineConfig, SchedulerConfig, MemoryConfig)):
        E, S, M = cls
        return E(scheduler=S(slots=2, chunk_size=4),
                 memory=M(max_len=64, paged=paged, page_size=8))

    def run(eng, R):
        """Request 0 to its end (it registers the prefix), then the rest."""
        reqs = [R(uid=i, prompt=shared + [30 + i], max_new_tokens=4,
                  prefix_len=16) for i in range(4)]
        eng.submit(reqs[0])
        eng.run()
        for r in reqs[1:]:
            eng.submit(r)
        eng.run()
        return eng, {r.uid: list(r.output) for r in reqs}

    _, ref = run(Engine(model, params, config(False), device="cpu"), Request)
    eng, got = run(Engine(model, params, config(True), device="cpu"),
                   Request)
    eng._pc.audit()
    assert got == ref
    assert eng.stats["prefix_hit_tokens"] == 3 * 16
    jeng = JEngine(jmodel, tree, config(True, (JEngineConfig,
                                               JSchedulerConfig,
                                               JMemoryConfig)))
    jeng._paged_step = _fixed(jeng, 4)
    _, want = run(jeng, JRequest)
    assert got == want


# -- speculative decoding ---------------------------------------------------------------


K, FRAC = 4, 0.2
STATS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
         "steps", "decode_tokens")


@functools.lru_cache(maxsize=None)
def jax_spec_run(cache_mode: str):
    """The JAX paged speculative engine ticked to the end: (tokens, per
    tick its return value, counters, slots, target and draft caches)."""
    _, tree, _, _ = ssd_reference()
    jmodel, _ = variant(cache_mode)
    eng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=2, chunk_size=8),
        memory=JMemoryConfig(**_mem(True)),
        speculative=JSpeculativeConfig(k=K, draft_rank_frac=FRAC)),
        step_fn=_padded(_jprograms(jmodel, "none")[0], 8))
    eng._paged_step = _fixed(eng, 8)
    eng._paged_spec = _spec_fixed(eng)
    for uid, prompt, max_new in _requests():
        eng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
    ticks = []
    while True:
        more = eng.tick()
        ticks.append({
            "more": more, "stats": {k: eng.stats[k] for k in STATS},
            "slots": [None if s.req is None else
                      (s.req.uid, list(s.req.output), s.pos)
                      for s in eng.slots],
            "target": jax.tree.map(np.asarray, _jtarget(eng)),
            "draft": jax.tree.map(np.asarray, eng.draft_cache)})
        if not more:
            break
    return {r.uid: list(r.output) for r in eng.finished}, ticks


def _spec_engine(model, params, paged, k=K):
    return Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=8),
        memory=MemoryConfig(**_mem(paged)),
        speculative=SpeculativeConfig(k=k, draft_rank_frac=FRAC)),
        device="cpu")


@pytest.mark.parametrize("paged", [False, True],
                         ids=["slot-static", "paged"])
@pytest.mark.parametrize("cache_mode", ["none", "int8"])
def test_spec_lockstep_with_reference(cache_mode, paged):
    """After every tick: the tick's return value, the round counters, each
    slot's request, output and position, and every leaf of the target's
    and the draft's caches; at the end the tokens, which (float) equal the
    port's plain engine's too."""
    _, _, _, params = ssd_reference()
    _, model = variant(cache_mode)
    want, ticks = jax_spec_run(cache_mode)
    eng = _spec_engine(model, params, paged)
    for uid, prompt, max_new in _requests():
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    for i, snap in enumerate(ticks):
        assert eng.tick() == snap["more"], i
        assert {k: eng.stats[k] for k in STATS} == snap["stats"], i
        assert [None if s.req is None else (s.req.uid, s.req.output, s.pos)
                for s in eng.slots] == snap["slots"], i
        _caches_equal(model, eng._pc.view if paged else eng.cache,
                      snap["target"], f"tick {i} target")
        _caches_equal(model, eng.draft_cache, snap["draft"],
                      f"tick {i} draft")
        if paged:
            eng._pc.audit()
    got = {r.uid: r.output for r in eng.finished}
    assert got == want
    s = eng.stats
    assert s["spec_rounds"] > 0 and s["spec_accepted"] < s["spec_drafted"]
    if cache_mode != "none":
        return   # int8 state: a round packs it once, plain steps every token
    plain = _spec_engine(model, params, paged=False, k=0)
    for uid, prompt, max_new in _requests():
        plain.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    assert {r.uid: r.output for r in plain.run()} == got


# -- the launcher and the slot reset -------------------------------------------------


def test_launcher_serves_every_mode():
    base = ["--arch", "mamba2-130m", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--max-len", "64",
            "--page-size", "8"]
    for flags in ([], ["--paged"], ["--speculative", "4"],
                  ["--quant-cache", "int8"],
                  ["--quant-weights", "int8", "--quant-activations", "int8"],
                  ["--quant-weights", "int4"],
                  ["--paged", "--speculative", "2", "--quant-cache", "int8"]):
        reqs = serve.main(base + flags)
        assert all(r.done and len(r.output) == 3 for r in reqs), flags


def test_reset_slot_zeroes_state():
    """A finished request's row: conv and h 0 — and a request served after
    it in that row gets the tokens of a fresh engine."""
    _, _, model, params = ssd_reference()
    cfg = EngineConfig(scheduler=SchedulerConfig(slots=1, chunk_size=8),
                       memory=MemoryConfig(max_len=64))
    eng = Engine(model, params, cfg, device="cpu")
    first, second = prompts()[3], prompts()[1]
    eng.generate_batch([first], SamplingParams(max_new_tokens=4))
    for c in eng.cache:
        for name, leaf in c.items():
            assert torch.all(leaf[0] == 0), name
    again = eng.generate_batch([second], SamplingParams(max_new_tokens=6))
    fresh = Engine(model, params, cfg, device="cpu").generate_batch(
        [second], SamplingParams(max_new_tokens=6))
    assert again[0].output == fresh[0].output
