"""deepseek-v3-671b served by the port's engines against the JAX package's,
in fp32 on the CPU, on ``tests/test_torch_mla.py``'s reduced config cut to
two layers (``LAYERS``: the dense first layer and one MoE layer — MLA over
a latent cache, a shared expert; the JAX programs' compiles set this
file's time), built without the MTP head on both sides (serving never
runs it; the port builds none), so that both draft plans pool the same
linears.

A serving step routes every token of its (B, C) chunk, idle rows and dead
columns included, so the port's step routes exactly the reference's: the
same chunk widths (8 or a decode step: prompts of 5–24 tokens), the same
padding tokens, dead columns that attend as the reference's do.  Each JAX
program compiles unoptimized (``_unoptimized``), once per chunk width and
weight storage.

- the engine: greedy tokens equal the JAX engine's with float, int8 and
  int4 weights and over the int8 latent cache, and with W8A8 and W4A8
  weights up to each request's first token sampled at a reference margin
  below ``A8_ROW_ATOL`` (an activation code at a rounding boundary flips
  on a summation-order difference);
- the paged engine beside the JAX paged engine, tick by tick (a request
  that hits another's registered prefix): page tables, free list, prefix
  entries, every pool leaf (``latent``, ``k_rope``, ``pos``), and tokens;
- dropless (capacity factor 64), the speculative engine (k = 4, frac 0.7,
  the reference benchmark's for MLA), slot-static and paged, beside the
  JAX paged speculative engine tick by tick: the round counters, each
  slot's request, output and position, every leaf of the draft's cache and
  (paged) of the target's pool; and its tokens equal the plain engine's
  (the reference's own ``[mla]`` speculation test fails only because its
  capacity drops depend on the batch shape: ROADMAP C4);
- the launcher serving ``--arch deepseek-v3-671b --reduced --device cpu``
  in its modes."""

import functools

import jax
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
from repro_torch.serve import Request, SpeculativeConfig
from test_torch_hybrid import _unoptimized
from test_torch_hybrid_serving import _leaf_close, _spec_fixed
from test_torch_mla import mla_reference
from test_torch_moe_serving import (CHUNK, MAX_LEN, PAGE, SLOTS, STATS,
                                    WEIGHT_MODES, _jpool, _pages_fixed,
                                    _port_engine, _requests, _run, _tree)
from torch_parity import A8_ROW_ATOL

K, FRAC, DROPLESS = 4, 0.7, 64.0
LAYERS = 2


def reference(**kw):
    return mla_reference(mtp=False, n_layers=LAYERS, **kw)


def _layer_leaves(jcache, i):
    """Layer i's MLA cache of the reference tree: ``pre_0``, then the
    scanned cycle's layers; numpy."""
    if i == 0:
        return jax.tree.map(np.asarray, jcache["pre_0"]["mixer"])
    return jax.tree.map(lambda a: np.asarray(a[i - 1]),
                        jcache["cycles"]["blk_0"]["mixer"])


@functools.lru_cache(maxsize=None)
def _quantized(weights):
    """The reference tree quantized as the JAX engine quantizes it at load
    (``LM.quantize_params`` under ``jax.jit``, here compiled unoptimized),
    once per storage: the engine takes a quantized tree as it is, so int8
    and W8A8 (int4 and W4A8) share it."""
    jmodel, tree, _, _ = reference()
    return _unoptimized(jax.jit(lambda p: jmodel.quantize_params(
        p, jq.QuantConfig(weights=weights))))(tree)


def _jax_tokens(jmodel, tree, weights, act):
    """The JAX engine's tokens, and the top-1/top-2 margin of the logits
    each output token was sampled from: {(uid, index): margin}.  The step
    is traced afresh for each storage and activation mode."""
    if weights != "none":
        tree = _quantized(weights)
    step = _unoptimized(jax.jit(lambda *a: jmodel.prefill_chunk(*a)))
    engine, margins = [], {}

    def recording(params, cache, tokens, steps, n):
        logits, cache = step(params, cache, tokens, steps, n)
        top2 = np.sort(np.asarray(logits[:, 0]), axis=-1)[:, -2:]
        for b, slot in enumerate(engine[0].slots):
            if slot.req is not None and int(n[b]):
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


@pytest.mark.parametrize("mode", [*WEIGHT_MODES, "int8_cache"])
def test_engine_tokens_equal_jax(mode):
    cache = "int8" if mode == "int8_cache" else "none"
    jmodel, tree, model, params = reference(cache=cache)
    weights, act = WEIGHT_MODES.get(mode, ("none", "none"))
    eng = _port_engine(model, params, quant=quant.QuantConfig(
        weights=weights, activations=act))
    got = _run(eng, _requests())
    want, margins = _jax_tokens(jmodel, tree, weights, act)
    assert {u: len(v) for u, v in got.items()} == {
        u: m for u, _, m in _requests()}
    if act == "none":
        assert got == want
        return
    for uid, out in got.items():
        n = next((i for i in range(len(out))
                  if margins[(uid, i)] < A8_ROW_ATOL), len(out))
        assert out[:n] == want[uid][:n], (uid, out, want[uid], n)
    assert sum(m >= A8_ROW_ATOL for m in margins.values()) > len(margins) / 2


def _pool_equal(pc, tree, tick):
    """Every leaf of the port's pool against the reference's pool tree."""
    for i, names in enumerate(pc.names):
        want = _layer_leaves(tree, i)
        for name in names:
            got = pc.pool[name][:pc.n_pages, pc.layers[name].index(i)]
            _leaf_close(got, want[name], f"tick {tick}: {i}/{name}")


def test_paged_engine_matches_jax():
    jmodel, tree, model, params = reference()
    mem = dict(max_len=MAX_LEN, paged=True, page_size=PAGE)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=JMemoryConfig(**mem)))
    jeng._paged_step = _pages_fixed(jeng)
    eng = _port_engine(model, params, memory=dict(paged=True,
                                                  page_size=PAGE))
    jpc, pc = jeng._pc, eng._pc
    assert set(pc.names[0]) == {"latent", "k_rope", "pos"}
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


@functools.lru_cache(maxsize=None)
def jax_spec_run():
    """The dropless JAX paged speculative engine ticked to the end:
    (tokens, per tick its return value, counters, slots, target and draft
    caches)."""
    jmodel, tree, _, _ = reference(cf=DROPLESS)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=SLOTS, chunk_size=CHUNK),
        memory=JMemoryConfig(max_len=MAX_LEN, paged=True, page_size=PAGE,
                             prefix_sharing=False),
        speculative=JSpeculativeConfig(k=K, draft_rank_frac=FRAC)),
        step_fn=_unoptimized(jax.jit(jmodel.prefill_chunk)))
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


@pytest.mark.parametrize("paged", [False, True],
                         ids=["slot-static", "paged"])
def test_spec_lockstep_with_reference(paged):
    _, _, model, params = reference(cf=DROPLESS)
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
        for j, c in enumerate(eng.draft_cache):
            ref = _layer_leaves(snap["draft"], j)
            assert set(c) == set(ref), (i, j)
            for name, leaf in c.items():
                _leaf_close(leaf, ref[name], f"tick {i} draft: {j}/{name}")
    assert {r.uid: r.output for r in eng.finished} == want
    s = eng.stats
    assert s["spec_rounds"] > 0 and s["spec_accepted"] < s["spec_drafted"]


def test_dropless_spec_equals_plain():
    """Dropless (capacity factor 64) no token's output depends on the
    others': the rounds' other chunk shapes change nothing, and the
    speculative engine's tokens equal the plain engine's."""
    _, _, model, params = reference(cf=DROPLESS)
    plain = _run(_port_engine(model, params), _requests())
    spec = _port_engine(model, params, speculative=SpeculativeConfig(
        k=K, draft_rank_frac=FRAC))
    assert _run(spec, _requests()) == plain
    assert spec.stats["spec_rounds"] > 0


def test_launcher():
    base = ["--arch", "deepseek-v3-671b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--max-len", "64",
            "--page-size", "8"]
    for flags in ([], ["--paged"], ["--speculative", "2"],
                  ["--quant-cache", "int8"],
                  ["--quant-weights", "int4", "--quant-activations",
                   "int8"]):
        reqs = serve.main(base + flags)
        assert all(r.done and len(r.output) == 3 for r in reqs), flags
