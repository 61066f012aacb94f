"""Self-speculative decoding of the hybrid family in the port (ROADMAP A7:
the verify's per-token RG-LRU states and their rollback, the draft's state
restored before its resync, rounds across a ring wrap) against the JAX
package's speculative engine, in fp32 on the CPU, on the reduced hybrid of
``tests/test_torch_hybrid.py`` (window 16), float and over the int8 cache
(an int8 ring and int8 RG-LRU state).

The draft plan names a rank per layer group as the reference's does (8
layers: two cycles and the tail).  The engines run one cycle, 3 layers
(rglru, rglru, local_attn: the reference scans its cycles, so a second
cycle would add a third of the compile time and no other code).  One
JAX paged speculative engine a cache mode (k = 4, frac 0.2: rejected
drafts, so rollbacks; prefix sharing off, as ROADMAP C7 requires; max_len
64 past the 16-slot rings, so every leaf is a state leaf) is ticked to the
end; the port's slot-static and paged speculative engines are ticked
beside its record.  After every tick: the tick's return value, the round
counters, each slot's request, output and position, and every leaf of the
target's and the draft's caches (positions, the ring's int8 codes and bf16
scales exact; floats within 1e-4; an int8 RG-LRU state within one code
step and 1e-6 in its scales, then given the reference's codes, as
``tests/test_torch_hybrid_serving.py::_share_state`` does, ROADMAP C10);
at the end the tokens, which equal the port's plain engine's too (float:
over the int8 cache a round packs the state once where plain steps pack
it every token).  Every
JAX program compiles once, unoptimized, at one shape."""

import functools

import jax
import numpy as np
import pytest

from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SpeculativeConfig as JSpeculativeConfig

from repro_torch import weights
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SchedulerConfig, SpeculativeConfig)
from test_torch_hybrid import _cache_leaves, _padded, _unoptimized
from test_torch_hybrid_serving import (_fixed, _jstep, _leaf_close,
                                       _share_state, _spec_fixed,
                                       hybrid_reference, variant)

K, FRAC, MAX_LEN = 4, 0.2, 64
SPEC_LAYERS = 3
STATS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
         "steps", "decode_tokens")


def _requests():
    """(uid, prompt, max_new): prompts of 5–14 tokens whose rounds cross
    the 16-slot rings' wrap, budgets that end rows in different rounds."""
    rng = np.random.default_rng(41)
    return [(i, [int(t) for t in rng.integers(0, 512, n)], m)
            for i, (n, m) in enumerate([(14, 9), (5, 13), (10, 8)])]


def _tree(cache):
    return jax.tree.map(np.asarray, cache)


@functools.lru_cache(maxsize=None)
def jax_run(cache_mode: str):
    """The JAX paged speculative engine ticked to the end: (tokens, per
    tick its return value, counters, slots, target and draft caches)."""
    _, tree, _, _ = hybrid_reference(SPEC_LAYERS)
    jmodel, _ = variant(cache=cache_mode, n_layers=SPEC_LAYERS)
    eng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=2, chunk_size=8),
        memory=JMemoryConfig(max_len=MAX_LEN, paged=True, page_size=8,
                             prefix_sharing=False),
        speculative=JSpeculativeConfig(k=K, draft_rank_frac=FRAC)),
        step_fn=_padded(_jstep(jmodel), 8))
    eng._paged_step = _fixed(eng, 8)
    eng._paged_spec = _spec_fixed(eng)
    for uid, prompt, max_new in _requests():
        eng.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
    pc, ticks = eng._pc, []
    while True:
        more = eng.tick()
        ticks.append({
            "more": more, "stats": {k: eng.stats[k] for k in STATS},
            "slots": [None if s.req is None else
                      (s.req.uid, list(s.req.output), s.pos)
                      for s in eng.slots],
            "target": _tree(jax.tree.unflatten(
                pc.treedef, pc._merge(pc.pool, pc.static))),
            "draft": _tree(eng.draft_cache)})
        if not more:
            break
    return {r.uid: list(r.output) for r in eng.finished}, ticks


def _port_engine(model, params, paged, k=K):
    return Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=8),
        memory=MemoryConfig(max_len=MAX_LEN, paged=paged, page_size=8,
                            prefix_sharing=False),
        speculative=SpeculativeConfig(k=k, draft_rank_frac=FRAC)),
        device="cpu")


def _caches_equal(model, cache, want, what):
    for i, c in enumerate(cache):
        ref = _cache_leaves(want, i)
        assert set(c) == set(ref), (what, i)
        if model.specs[i].kind == "rglru" and model.cfg.cache_quant:
            _share_state(c, ref, f"{what} {i}")
            continue
        for name, leaf in c.items():
            _leaf_close(leaf, ref[name], f"{what}: {i}/{name}")


@pytest.mark.parametrize("frac", [0.2, 0.5])
def test_hybrid_draft_plan_matches_reference(frac):
    """The hybrid's plan names a rank per pattern position of the cycles
    and per tail layer, as the reference's does (``weights.plan_from_jax``:
    ``cycles.blk_j.…`` ↔ ``layers.blk_j.…``, ``tail_t.…`` ↔
    ``layers.tail_t.…``), and the ranks are equal."""
    jmodel, tree, model, params = hybrid_reference()
    want = weights.plan_from_jax(jmodel.draft_plan(tree, frac))
    got = model.draft_plan(params, frac)
    assert got == want
    assert {k.split(".")[1] for k in got} == {"blk_0", "blk_1", "blk_2",
                                              "tail_0", "tail_1"}
    assert "layers.blk_2.mixer.qkv" in got and "layers.tail_1.ffn.wo" in got


@pytest.mark.parametrize("paged", [False, True],
                         ids=["slot-static", "paged"])
@pytest.mark.parametrize("cache_mode", ["none", "int8"])
def test_spec_lockstep_with_reference(cache_mode, paged):
    _, _, _, params = hybrid_reference(SPEC_LAYERS)
    _, model = variant(cache=cache_mode, n_layers=SPEC_LAYERS)
    want, ticks = jax_run(cache_mode)
    eng = _port_engine(model, params, paged)
    if paged:
        assert eng._pc.has_state and not eng._pc.has_paged
    for uid, prompt, max_new in _requests():
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    for i, snap in enumerate(ticks):
        assert eng.tick() == snap["more"], i
        assert {k: eng.stats[k] for k in STATS} == snap["stats"], i
        assert [None if s.req is None else (s.req.uid, s.req.output, s.pos)
                for s in eng.slots] == snap["slots"], i
        target = eng._pc.view if paged else eng.cache
        _caches_equal(model, target, snap["target"], f"tick {i} target")
        _caches_equal(model, eng.draft_cache, snap["draft"],
                      f"tick {i} draft")
        if paged:
            eng._pc.audit()
    got = {r.uid: r.output for r in eng.finished}
    assert got == want
    s = eng.stats
    assert s["spec_rounds"] > 0 and s["spec_accepted"] < s["spec_drafted"]
    # rounds past the ring's 16 slots: the last round of every row wrapped
    assert all(len(p) + len(got[u]) > 16 for u, p, _ in _requests())
    if cache_mode != "none":
        return   # int8 state: a round packs it once, plain steps every token
    plain = _port_engine(model, params, paged=False, k=0)
    for uid, prompt, max_new in _requests():
        plain.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    assert {r.uid: r.output for r in plain.run()} == got
