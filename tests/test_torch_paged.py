"""The port's paged cache (``repro_torch/serve/paged.py``) and its engine
policy against the JAX package's paged engine, mirroring
``tests/test_paged.py`` for the attention family.

Against the JAX engine: ``smollm-135m.reduced()`` with the reference's
``LM.init(PRNGKey(0))`` weights (``torch_parity.reference_pair``), fp32 on
the CPU, both engines driven tick by tick through one arrival schedule on a
pool too small for it (prefix hits, evictions and priority preemptions).
After every tick the page tables, the free list and the refcounts are
identical; the greedy tokens are identical up to each request's first
output position where the reference's top-1/top-2 margin is below 1e-4
(and, this schedule's near-ties included, in full: the pools hold the
outputs' K/V); every pool leaf ends within 1e-4 of the reference's, the
int8 cache's codes and bf16 scales bit for bit.  ``max_len`` 128 makes steps at kv bucket 64
gather half of each row's pages, the rest at 128 all of them: the pool ends
as the reference's full gather leaves it.

The port alone (a tiny config, as the reference's tests use): paged tokens
equal slot-static tokens in float, int8 weights, the int8 cache and W8A8;
prefix sharing; the random admit/tick/cancel interleaving with ``audit()``
after every mutation; preemption deterministic and recompute-exact;
admission never preempts equal priority; a state leaf stays
slot-resident and is snapshotted on registration."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs, quant
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, PagedCache,
                               Request, SchedulerConfig)
from torch_parity import MARGIN, TOL, reference_pair

# the lockstep run: 4 slots, chunk 8, 16 pages of 8 tokens a row, a pool of
# 15 usable pages (120 tokens against 512 slot-static)
GEOM = dict(slots=4, chunk=8, max_len=128, page_size=8, pages=16)


def _schedule():
    """{arrival tick: [(uid, prompt, max_new, priority)]}: bulk class-1
    requests, two sharing a 16-token prefix, then class-0 arrivals reusing
    it and a repeat of an earlier prompt."""
    rng = np.random.default_rng(11)

    def toks(n):
        return [int(t) for t in rng.integers(0, 512, n)]
    shared = toks(16)
    return {0: [(0, shared + toks(4), 10, 1), (1, toks(9), 12, 1),
                (2, toks(27), 10, 1), (3, shared + [5], 8, 1)],
            4: [(4, shared + [7, 8, 9], 6, 0), (5, toks(58), 12, 0)],
            9: [(6, shared + toks(4), 10, 1), (7, shared + [7, 8, 9], 5, 0)]}


def _engines(jmodel, jparams, model, params):
    g = GEOM
    jeng = JEngine(jmodel, jparams, JEngineConfig(
        scheduler=JSchedulerConfig(slots=g["slots"], chunk_size=g["chunk"]),
        memory=JMemoryConfig(max_len=g["max_len"], paged=True,
                             page_size=g["page_size"], pages=g["pages"])))
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=g["slots"], chunk_size=g["chunk"]),
        memory=MemoryConfig(max_len=g["max_len"], paged=True,
                            page_size=g["page_size"], pages=g["pages"])),
        device="cpu")
    return jeng, eng


def _lockstep(jeng, eng):
    """Drive both engines through ``_schedule``; after every tick the page
    tables, free lists, refcounts and counters agree, and the port's pool
    audits.  Returns the kv buckets the port's steps gathered."""
    sched = _schedule()
    jpc, pc = jeng._pc, eng._pc
    seen_kv = set()
    run_step = eng._run_step

    def record(key):
        seen_kv.add(key[1])
        return run_step(key)

    eng._run_step = record
    tick = 0
    while True:
        for uid, prompt, max_new, prio in sched.get(tick, []):
            jeng.submit(JRequest(uid=uid, prompt=prompt,
                                 max_new_tokens=max_new, priority=prio))
            eng.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=max_new, priority=prio))
        more = jeng.tick()
        assert eng.tick() == more, tick
        np.testing.assert_array_equal(pc.tables, jpc.tables, err_msg=tick)
        assert pc.pages._free == jpc.pages._free, tick
        np.testing.assert_array_equal(pc.pages.ref, jpc.pages.ref)
        assert set(pc.prefix.entries) == set(jpc.prefix.entries)
        for k in ("preemptions", "prefix_hit_tokens", "steps"):
            assert eng.stats[k] == jeng.stats[k], (tick, k)
        pc.audit()
        tick += 1
        if not more and tick > max(sched):
            return seen_kv


def _safe(jmodel, jparams, reqs) -> list[int]:
    """Per request, how many leading outputs the reference's full-sequence
    forward predicts with a top-1/top-2 margin ≥ ``MARGIN``."""
    seqs = [r.prompt + r.output for r in reqs]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(jax.jit(lambda p, t: jmodel.apply(p, t).logits)(
        jparams, jnp.asarray(toks)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, r in enumerate(reqs):
        m = margin[i, len(r.prompt) - 1: len(r.prompt) - 1 + len(r.output)]
        low = np.nonzero(m < MARGIN)[0]
        safe.append(int(low[0]) if low.size else len(r.output))
    return safe


def _check_against_jax(jmodel, jparams, model, params, exact_codes):
    jeng, eng = _engines(jmodel, jparams, model, params)
    seen_kv = _lockstep(jeng, eng)
    assert seen_kv == {64, 128}             # partial and full gathers
    assert eng.stats["preemptions"] > 0 and eng.stats["prefix_hit_tokens"] > 0
    want = sorted(jeng.finished, key=lambda r: r.uid)
    got = sorted(eng.finished, key=lambda r: r.uid)
    assert [r.uid for r in got] == [r.uid for r in want] == list(range(8))
    safe = _safe(jmodel, jparams, want)
    assert sum(safe) >= sum(len(r.output) for r in want) // 2, safe
    for g, w, n in zip(got, want, safe):
        assert g.output[:n] == w.output[:n], (g.uid, g.output, w.output)
        assert g.stop_reason == w.stop_reason
    # the pools hold K/V of the outputs too: they are compared where every
    # token agrees, near-ties included (as in this schedule)
    assert [g.output for g in got] == [w.output for w in want]
    # the pools: every page but the port's sink, layer by layer
    jpc = jeng._pc
    tree = jax.tree.unflatten(jpc.treedef, jpc._merge(jpc.pool, jpc.static))
    jc = tree["cycles"]["blk_0"]["mixer"]
    assert set(jc) == set(eng._pc.pool)
    n_pages = eng._pc.n_pages
    for name, leaf in eng._pc.pool.items():
        assert leaf.shape[:2] == (n_pages + 1, model.cfg.n_layers)
        w = jc[name]
        if name.endswith("scale"):
            assert leaf.dtype == torch.bfloat16
            w, leaf = w.astype(jnp.float32), leaf.float()
        got_leaf, w = leaf[:n_pages].movedim(0, 1).numpy(), np.asarray(w)
        if name == "pos" or exact_codes:
            np.testing.assert_array_equal(got_leaf, w, err_msg=name)
        else:
            np.testing.assert_allclose(got_leaf, w, **TOL, err_msg=name)
    return eng


def test_paged_engine_matches_jax_paged_engine():
    jmodel, jparams, model, params = reference_pair()
    _check_against_jax(jmodel, jparams, model, params, exact_codes=False)


def test_paged_int8_cache_matches_jax_bit_for_bit():
    """The int8 cache's pages: codes and bf16 scales equal the reference's
    bit for bit, pos too."""
    jmodel, jparams, model, params = reference_pair()
    jmodel8 = jbuild_model(dataclasses.replace(
        jmodel.cfg, quant=jq.QuantConfig(cache="int8")))
    model8 = build_model(dataclasses.replace(
        model.cfg, quant=quant.QuantConfig(cache="int8")), device="cpu")
    eng = _check_against_jax(jmodel8, jparams, model8, params,
                             exact_codes=True)
    assert eng._pc.pool["k"].dtype == torch.int8
    assert set(eng._pc.pool) == {"pos", "k", "v", "k_scale", "v_scale"}


# -- the port alone --------------------------------------------------------------


def _tiny(**kw):
    cfg = configs.get("smollm-135m").reduced(
        vocab=64, d_model=32, n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1,
        **kw)
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


def _cfg(*, paged, slots=2, chunk=4, max_len=64, page_size=8, pages=None,
         prefix=True, q=None):
    return EngineConfig(
        scheduler=SchedulerConfig(slots=slots, chunk_size=chunk),
        memory=MemoryConfig(max_len=max_len, paged=paged, page_size=page_size,
                            pages=pages, prefix_sharing=prefix), quant=q)


def _outputs(model, params, config, reqs):
    eng = Engine(model, params, config, device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    if eng._pc is not None:
        eng._pc.audit()
    return {r.uid: list(r.output) for r in done}


MODES = {"float": ("none", "none", "none"), "int8": ("int8", "none", "none"),
         "int8_cache": ("none", "none", "int8"),
         "w8a8": ("int8", "int8", "none")}


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_equals_slot_static(mode):
    """Greedy tokens of the paged engine equal the slot-static engine's in
    each mode, on the reference's weights (6 prompts of 1-30 tokens, 8 new
    tokens, max_len 128: kv buckets 64 and 128)."""
    weights, act, cache = MODES[mode]
    _, _, model, params = reference_pair()
    if cache != "none":
        model = build_model(dataclasses.replace(
            model.cfg, quant=quant.QuantConfig(cache=cache)), device="cpu")
    q = quant.QuantConfig(weights=weights, activations=act)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, 512, size=n)]
               for n in (3, 17, 9, 30, 1, 12, 70)]

    def reqs():
        return [Request(uid=i, prompt=p, max_new_tokens=8)
                for i, p in enumerate(prompts)]
    ref = _outputs(model, params, _cfg(paged=False, slots=4, chunk=8,
                                       max_len=128, q=q), reqs())
    got = _outputs(model, params, _cfg(paged=True, slots=4, chunk=8,
                                       max_len=128, q=q), reqs())
    assert got == ref
    assert all(len(o) == 8 for o in got.values())


def test_shared_prefix_outputs_identical_and_pool_small():
    """16 requests sharing a 128-token system prompt fit in a pool far
    smaller than 16 slot-static rows, hit the shared pages, and stream the
    same tokens as an unshared slot-static engine."""
    model, params = _tiny()
    shared = [(i * 7 + 3) % 64 for i in range(128)]
    prompts = [shared + [10 + i % 8, 20 + i % 5] for i in range(16)]
    eng = Engine(model, params, _cfg(paged=True, slots=4, chunk=64,
                                     max_len=160, page_size=32, pages=12),
                 device="cpu")
    # the first request to completion registers the aligned prefix levels
    eng.submit(Request(uid=0, prompt=prompts[0], max_new_tokens=2))
    eng.run()
    for i in range(1, 16):
        eng.submit(Request(uid=i, prompt=prompts[i], max_new_tokens=2))
    done = eng.run()
    eng._pc.audit()
    assert len(done) == 15
    assert eng.sla_report()["prefix_hit_tokens"] >= 15 * 128
    assert eng._pc.pool_tokens() < 16 * 160 / 4
    ref = _outputs(model, params,
                   _cfg(paged=False, slots=4, chunk=64, max_len=160),
                   [Request(uid=i, prompt=prompts[i], max_new_tokens=2)
                    for i in range(16)])
    assert {r.uid: list(r.output) for r in done} == {
        u: o for u, o in ref.items() if u}


def test_random_admit_cancel_never_leaks():
    """Random interleavings of submit / tick / cancel keep the refcounts
    and the free list consistent and the zero page pristine (``audit``
    after every mutation); evicting every prefix entry returns the whole
    pool."""
    model, params = _tiny()
    rng = random.Random(7)
    eng = Engine(model, params, _cfg(paged=True, slots=2, max_len=32,
                                     page_size=8, pages=9), device="cpu")
    uid = 0
    live: list[int] = []
    for _ in range(120):
        act = rng.random()
        if act < 0.35:
            prompt = [rng.randrange(1, 64)
                      for _ in range(rng.randrange(1, 20))]
            eng.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=rng.randrange(1, 6)))
            live.append(uid)
            uid += 1
        elif act < 0.5 and live:
            eng.cancel(live.pop(rng.randrange(len(live))))
        else:
            eng.tick()
        eng._pc.audit()
    eng.run()
    eng._pc.audit()
    while eng._pc.evict_one():
        eng._pc.audit()
    assert eng._pc.pages.n_free == eng._pc.pages.n_pages - 1


def test_preempt_then_cancel_releases_everything():
    model, params = _tiny()
    eng = Engine(model, params, _cfg(paged=True, slots=2, max_len=32,
                                     page_size=8, pages=7, prefix=False),
                 device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=20,
                       priority=1))
    eng.submit(Request(uid=1, prompt=list(range(9, 17)), max_new_tokens=20,
                       priority=1))
    for _ in range(6):
        eng.tick()
        eng._pc.audit()
    # an urgent arrival under pressure forces a preemption
    eng.submit(Request(uid=2, prompt=[3, 4, 5], max_new_tokens=8,
                       priority=0))
    for _ in range(4):
        eng.tick()
        eng._pc.audit()
    for u in (0, 1, 2):
        eng.cancel(u)
        eng._pc.audit()
    eng.run()
    eng._pc.audit()
    assert eng._pc.pages.n_free == eng._pc.pages.n_pages - 1


def _preempt_run(model, params, pages):
    eng = Engine(model, params, _cfg(paged=True, slots=2, max_len=64,
                                     page_size=8, pages=pages, prefix=False),
                 device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=24,
                       priority=1))
    eng.submit(Request(uid=1, prompt=list(range(9, 17)), max_new_tokens=24,
                       priority=1))
    for _ in range(8):
        eng.tick()
    eng.submit(Request(uid=2, prompt=[3, 4, 5], max_new_tokens=8,
                       priority=0))
    eng.run()
    eng._pc.audit()
    return eng


def test_preemption_deterministic_and_recompute_exact():
    """Preempting the lowest-priority generation and recomputing it on
    resume reproduces the unpressured greedy output exactly, run after
    run."""
    model, params = _tiny()
    a = _preempt_run(model, params, pages=8)
    b = _preempt_run(model, params, pages=8)
    out_a = {r.uid: list(r.output) for r in a.finished}
    assert out_a == {r.uid: list(r.output) for r in b.finished}
    assert a.stats["preemptions"] == b.stats["preemptions"] > 0
    assert all(len(out_a[u]) == 24 for u in (0, 1))
    assert not any(r.truncated for r in a.finished)
    roomy = _preempt_run(model, params, pages=33)
    assert roomy.stats["preemptions"] == 0
    assert out_a == {r.uid: list(r.output) for r in roomy.finished}


def test_admission_never_preempts_equal_priority():
    model, params = _tiny()
    eng = Engine(model, params, _cfg(paged=True, slots=1, max_len=32,
                                     page_size=8, pages=5, prefix=False),
                 device="cpu")
    eng.submit(Request(uid=0, prompt=list(range(1, 9)), max_new_tokens=16,
                       priority=0))
    for _ in range(4):
        eng.tick()
    eng.submit(Request(uid=1, prompt=[3, 4], max_new_tokens=4, priority=0))
    eng.run()
    assert eng.stats["preemptions"] == 0
    by_uid = {r.uid: r for r in eng.finished}
    assert len(by_uid[0].output) == 16
    assert len(by_uid[1].output) == 4


class _StateModel:
    """A model whose second layer holds a leaf without a ``kv_seq`` axis
    (a recurrent state, as SSD and RG-LRU caches have)."""

    def __init__(self, model):
        self.model = model

    def init_cache(self, batch, max_len):
        cache = self.model.init_cache(batch, max_len)
        cache[1]["state"] = torch.zeros((batch, 4, 8))
        return cache

    def cache_axes(self):
        axes = self.model.cache_axes()
        axes[1]["state"] = ("batch", "heads", None)
        return axes


def test_state_leaf_raises_naming_a7():
    """A leaf without a max_len ``kv_seq`` axis is a state leaf: it stays
    slot-resident (one row a slot, in the view), is not paged, is reset
    with its slot, and a registered prefix snapshots it; a hit restores the
    snapshot and an eviction frees it."""
    model, _ = _tiny()
    assert all(a["k"] == ("batch", "kv_seq", "kv_heads", None)
               for a in model.cache_axes())
    pc = PagedCache(_StateModel(model), 2, 32, 8, 9, snap_slots=2)
    assert pc.has_paged and pc.has_state and set(pc.pool) == {"k", "v",
                                                              "pos"}
    assert set(pc.static) == {(1, "state")} and pc.n_snap == 2
    state = pc.view[1]["state"]
    assert state is pc.static[(1, "state")] and state.shape == (2, 4, 8)
    assert "state" not in pc.view[0]
    state[1] = 3.0
    fresh, _ = pc.plan_writes(1, 0, 16)
    assert len(fresh) == 2
    assert pc.register_prefix(1, list(range(16)), 16)
    entry = pc.prefix.entries[tuple(range(16))]
    assert entry.snap is not None and entry.pages == fresh
    assert torch.all(pc.snap[(1, "state")][entry.snap] == 3.0)
    pc.audit()
    pc.reset_slot(1)
    assert torch.all(state[1] == 0)
    pc.free_slot(1)
    pc.prefix_admit(0, pc.prefix_lookup(list(range(20))))
    assert torch.all(state[0] == 3.0)
    pc.audit()
    pc.free_slot(0)
    assert pc.evict_one() and len(pc._snap_free) == 2
    pc.audit()
