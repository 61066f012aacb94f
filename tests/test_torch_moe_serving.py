"""The MoE family served by the port's engines against the JAX package's,
in fp32 on the CPU, on ``tests/test_torch_moe.py``'s reduced
granite-moe-1b-a400m (2 layers, 4 experts top-2, capacity factor 1.25).

A serving step routes every token of its (B, C) chunk — idle rows and dead
columns too — with capacity over all of them, so the port's step has to
route exactly the reference's: the same chunk widths (no padding of the
reference's step to one width, which would change its capacity), the same
padding tokens, and dead columns that attend as the reference's do.  The
prompts are 5–24 tokens, so every chunk is 8 wide or a decode step: each
JAX program compiles twice (C = 8 and 1), unoptimized (``_unoptimized``).

- the engine: greedy tokens equal the JAX engine's with float, int8 and
  int4 weights and over the int8 cache, and with W8A8 and W4A8 weights up
  to each request's first token sampled at a reference margin below
  ``A8_ROW_ATOL`` (an activation code at a rounding boundary flips on a
  summation-order difference: ``tests/test_torch_quant.py``);
- the paged engine beside the JAX paged engine, tick by tick (a request
  that hits another's registered prefix): page tables, free list, prefix
  entries, every pool leaf, and tokens;
- the speculative engine (k = 4, frac 0.5), slot-static and paged, beside
  the JAX paged speculative engine tick by tick: the round counters, each
  slot's request, output and position, every leaf of the draft's cache and
  (paged) of the target's pool; dropless (capacity factor 64) its tokens equal the plain
  engine's;
- the launcher serving ``--arch granite-moe-1b-a400m --reduced --device
  cpu`` in its modes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import quant as jq
from repro.core import structures as jstructures
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SpeculativeConfig as JSpeculativeConfig

from repro_torch import quant
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SchedulerConfig, SpeculativeConfig)
from test_torch_hybrid import _unoptimized
from test_torch_hybrid_serving import _leaf_close, _spec_fixed
from test_torch_moe import _jstep, configs_pair, moe_reference
from torch_parity import A8_ROW_ATOL

SLOTS, CHUNK, MAX_LEN, PAGE = 4, 8, 64, 8
K, FRAC = 4, 0.5
STATS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
         "steps", "decode_tokens")
# mode → (weights, activations) of the engine's quantize-at-load
WEIGHT_MODES = {"float": ("none", "none"), "int8": ("int8", "none"),
                "int4": ("int4", "none"), "w8a8": ("int8", "int8"),
                "w4a8": ("int4", "int8")}


def _requests(n_shared=0):
    """(uid, prompt, max_new): prompts of 8, 16, 24 and 5 tokens; with
    ``n_shared``, a fifth request that starts with the first one's 16-token
    prompt (a registered prefix)."""
    rng = np.random.default_rng(17)
    reqs = [(i, [int(t) for t in rng.integers(0, 512, n)], m)
            for i, (n, m) in enumerate([(8, 7), (16, 6), (24, 5), (5, 9)])]
    if n_shared:
        reqs.append((4, reqs[1][1] + [int(t) for t in
                                      rng.integers(0, 512, 8)], 6))
    return reqs


def _layer_leaves(jcache, i):
    """Layer i's cache of the reference tree (one scanned cycle), numpy."""
    return jax.tree.map(lambda a: np.asarray(a[i]),
                        jcache["cycles"]["blk_0"]["mixer"])


def _jax_tokens(jmodel, tree, weights, act, cache):
    """The JAX engine's tokens, and the top-1/top-2 margin of the logits
    each output token was sampled from: {(uid, index): margin}."""
    jcfg = dataclasses.replace(jmodel.cfg, quant=jq.QuantConfig(cache=cache))
    jmodel = type(jmodel)(jcfg) if cache != "none" else jmodel
    step, engine, margins = _jstep(jmodel), [], {}

    def recording(params, cache, tokens, steps, n):
        logits, cache = step(params, cache, tokens, steps, n)
        top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[:, -2:]
        for b, slot in enumerate(engine[0].slots):
            if slot.req is not None and int(n[b]):
                # a prompt's last chunk comes last: it samples output 0
                margins[(slot.req.uid, len(slot.req.output))] = float(
                    top2[b, 1] - top2[b, 0])
        return logits, cache

    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=JMemoryConfig(max_len=MAX_LEN),
        quant=jq.QuantConfig(weights=weights, activations=act)),
        step_fn=recording)
    engine.append(jeng)
    try:
        for uid, prompt, max_new in _requests():
            jeng.submit(JRequest(uid=uid, prompt=prompt,
                                 max_new_tokens=max_new))
        jeng.run()
    finally:
        jstructures.set_activations("none")  # the reference's is global
    return {r.uid: list(r.output) for r in jeng.finished}, margins


def _port_engine(model, params, **kw):
    mem = dict(max_len=MAX_LEN, **kw.pop("memory", {}))
    return Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=MemoryConfig(**mem), **kw), device="cpu")


def _run(eng, reqs):
    for uid, prompt, max_new in reqs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    eng.run()
    return {r.uid: r.output for r in eng.finished}


@pytest.mark.parametrize("mode", [*WEIGHT_MODES, "int8_cache"])
def test_engine_tokens_equal_jax(mode):
    jmodel, tree, model, params = moe_reference()
    weights, act = WEIGHT_MODES.get(mode, ("none", "none"))
    cache = "int8" if mode == "int8_cache" else "none"
    if cache != "none":
        _, cfg = configs_pair()
        model = build_model(dataclasses.replace(
            cfg, quant=quant.QuantConfig(cache=cache)), device="cpu")
    want, margins = _jax_tokens(jmodel, tree, weights, act, cache)
    eng = _port_engine(model, params, quant=quant.QuantConfig(
        weights=weights, activations=act))
    got = _run(eng, _requests())
    assert {u: len(v) for u, v in got.items()} == {
        u: m for u, _, m in _requests()}
    if act == "none":
        assert got == want
        return
    # int8 activations: a code at a rounding boundary flips on a ~1e-7
    # input difference and moves its row's logits by up to ~A8_ROW_ATOL
    # (tests/test_torch_quant.py), so the tokens agree up to each
    # request's first output sampled at a reference margin below that
    for uid, out in got.items():
        n = next((i for i in range(len(out))
                  if margins[(uid, i)] < A8_ROW_ATOL), len(out))
        assert out[:n] == want[uid][:n], (uid, out, want[uid], n)
    assert sum(m >= A8_ROW_ATOL for m in margins.values()) > len(margins) / 2


def _pages_fixed(jeng, F=4, M=8):
    """The JAX paged engine's step with its page operands padded to F fresh
    pages and M write triples (the dropped page n_pages; changes nothing),
    compiled unoptimized once per chunk width — the width itself is not
    padded: it sets the MoE capacity."""
    inner = _unoptimized(jeng._paged_step)
    n_pages = jeng._pc.n_pages

    def pad(a, size, fill):
        a = np.asarray(a)
        return jnp.asarray(np.concatenate(
            [a, np.full((size - a.shape[0],), fill, a.dtype)]))

    def step(params, pool, static, table, fresh, rows, lps, phys, *rest):
        return inner(params, pool, static, table, pad(fresh, F, n_pages),
                     pad(rows, M, 0), pad(lps, M, 0), pad(phys, M, n_pages),
                     *rest)
    return step


def _jpool(jpc):
    """The JAX paged cache's pool as its cache tree."""
    return jax.tree.unflatten(jpc.treedef, jpc._merge(jpc.pool, jpc.static))


def _pool_equal(pc, tree, tick):
    """Every leaf of the port's pool against the reference's pool tree."""
    for i, names in enumerate(pc.names):
        want = _layer_leaves(tree, i)
        for name in names:
            got = pc.pool[name][:pc.n_pages, pc.layers[name].index(i)]
            _leaf_close(got, want[name], f"tick {tick}: {i}/{name}")


def test_paged_engine_matches_jax():
    jmodel, tree, model, params = moe_reference()
    mem = dict(max_len=MAX_LEN, paged=True, page_size=PAGE)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=JMemoryConfig(**mem)))
    jeng._paged_step = _pages_fixed(jeng)
    eng = _port_engine(model, params, memory=dict(paged=True,
                                                  page_size=PAGE))
    jpc, pc = jeng._pc, eng._pc
    reqs = _requests(n_shared=1)
    for uid, prompt, max_new in reqs[:4]:
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    tick = 0
    while True:
        if tick == 3:   # the first request's prompt is registered by now
            uid, prompt, max_new = reqs[4]
            jeng.submit(JRequest(uid=uid, prompt=prompt,
                                 max_new_tokens=max_new))
            eng.submit(Request(uid=uid, prompt=prompt,
                               max_new_tokens=max_new))
        more = jeng.tick()
        assert eng.tick() == more, tick
        np.testing.assert_array_equal(pc.tables, jpc.tables, err_msg=tick)
        assert pc.pages._free == jpc.pages._free, tick
        assert {k: e.pages for k, e in pc.prefix.entries.items()} == {
            k: e.pages for k, e in jpc.prefix.entries.items()}, tick
        for k in ("prefix_hit_tokens", "steps", "preemptions"):
            assert eng.stats[k] == jeng.stats[k], (tick, k)
        _pool_equal(pc, _jpool(jpc), tick)
        pc.audit()
        tick += 1
        if not more and tick > 3:
            break
    assert eng.stats["prefix_hit_tokens"] >= PAGE
    got = {r.uid: r.output for r in eng.finished}
    assert got == {r.uid: list(r.output) for r in jeng.finished}
    assert len(got) == 5


def _tree(cache):
    return jax.tree.map(np.asarray, cache)


@functools.lru_cache(maxsize=None)
def jax_spec_run():
    """The JAX paged speculative engine ticked to the end: (tokens, per
    tick its return value, counters, slots, target and draft caches)."""
    jmodel, tree, _, _ = moe_reference()
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=JMemoryConfig(max_len=MAX_LEN, paged=True, page_size=PAGE,
                             prefix_sharing=False),
        speculative=JSpeculativeConfig(k=K, draft_rank_frac=FRAC)),
        step_fn=_jstep(jmodel))
    jeng._paged_step = _pages_fixed(jeng)
    jeng._paged_spec = _spec_fixed(jeng)
    for uid, prompt, max_new in _requests():
        jeng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
    pc, ticks = jeng._pc, []
    while True:
        more = jeng.tick()
        ticks.append({
            "more": more, "stats": {k: jeng.stats[k] for k in STATS},
            "slots": [None if s.req is None else
                      (s.req.uid, list(s.req.output), s.pos)
                      for s in jeng.slots],
            "target": _tree(_jpool(pc)),
            "draft": _tree(jeng.draft_cache)})
        if not more:
            break
    return {r.uid: list(r.output) for r in jeng.finished}, ticks


def _caches_equal(cache, want, what):
    for i, c in enumerate(cache):
        ref = _layer_leaves(want, i)
        assert set(c) == set(ref), (what, i)
        for name, leaf in c.items():
            _leaf_close(leaf, ref[name], f"{what}: {i}/{name}")


@pytest.mark.parametrize("paged", [False, True],
                         ids=["slot-static", "paged"])
def test_spec_lockstep_with_reference(paged):
    _, _, model, params = moe_reference()
    want, ticks = jax_spec_run()
    eng = _port_engine(model, params, memory=dict(
        paged=paged, page_size=PAGE, prefix_sharing=False),
        speculative=SpeculativeConfig(k=K, draft_rank_frac=FRAC))
    for uid, prompt, max_new in _requests():
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    for i, snap in enumerate(ticks):
        assert eng.tick() == snap["more"], i
        assert {k: eng.stats[k] for k in STATS} == snap["stats"], i
        assert [None if s.req is None else (s.req.uid, s.req.output, s.pos)
                for s in eng.slots] == snap["slots"], i
        if paged:   # the reference's target is its pool
            _pool_equal(eng._pc, snap["target"], i)
            eng._pc.audit()
        _caches_equal(eng.draft_cache, snap["draft"], f"tick {i} draft")
    assert {r.uid: r.output for r in eng.finished} == want
    s = eng.stats
    assert s["spec_rounds"] > 0 and s["spec_accepted"] < s["spec_drafted"]


def test_dropless_spec_equals_plain():
    """With capacity past every assignment (factor 64) no token's output
    depends on the others': the rounds' other chunk shapes change nothing,
    and the speculative engine's tokens equal the plain engine's."""
    _, _, model, params = moe_reference(capacity_factor=64.0)
    plain = _run(_port_engine(model, params), _requests())
    spec = _port_engine(model, params, speculative=SpeculativeConfig(
        k=K, draft_rank_frac=FRAC))
    assert _run(spec, _requests()) == plain
    assert spec.stats["spec_rounds"] > 0


def test_launcher():
    base = ["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--max-len", "64",
            "--page-size", "8"]
    for flags in ([], ["--paged"], ["--speculative", "2"],
                  ["--quant-cache", "int8"],
                  ["--quant-weights", "int4", "--quant-activations",
                   "int8"]):
        reqs = serve.main(base + flags)
        assert all(r.done and len(r.output) == 3 for r in reqs), flags
