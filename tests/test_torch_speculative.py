"""Self-speculative decoding in the port (ROADMAP A6) against the JAX
package, in fp32 on the CPU.

The reference test's config, ``smollm-135m.reduced(vocab=64, d_model=32,
n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1)``, with the reference's
``LM.init(PRNGKey(0))`` weights carried over by ``from_jax_params``, and a
2-layer ``llama7b-blast.reduced()`` whose attention and FFN ranks differ
(``torch_parity.dense_reference``) for per-role plans:

- ``rank_spectrum`` within 1e-5 relative; ``truncate_rank`` bit for bit on
  float, int8 and packed int4 factors, odd ranks included; ``calibrate_ranks``,
  ``LM.draft_plan`` (through ``weights.plan_from_jax``) and
  ``truncate_params`` equal;
- ``prefill_chunk(all_logits=True)`` within 1e-4; ``rollback_cache``
  bit-identical to feeding the committed tokens, on the float and the int8
  cache;
- the engine: speculative tokens equal the port's plain tokens and the JAX
  speculative engine's at k = 1, 2, 4 (frac 0.9), the round counters equal
  the JAX engine's; at frac 0.2 with mixed budgets (rejected drafts, rows
  finishing mid-round) both engines are driven tick by tick and every leaf
  of the target and the draft caches agrees after every tick; the paged
  speculative engine equals the slot-static one and matches the JAX paged
  speculative engine (page tables, free list, pool leaves); k = 0 is the
  plain engine; a row that reaches the cache's end inside a round.

Three JAX engines are built, once per process (each compiles its round).
Tolerances: cache and pool leaves of K/V within 1e-4 (``TOL``), positions,
token ids, plans, codes and counters exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.core import compress as jcompress
from repro.core import structures as jstructures
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SpeculativeConfig as JSpeculativeConfig

from repro_torch import configs, quant, weights
from repro_torch.core import compress, structures
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SchedulerConfig, SpeculativeConfig)
from repro_torch.tree import leaves
from test_torch_hybrid_serving import _fixed, _spec_fixed
from torch_parity import TOL, dense_reference

TINY = dict(vocab=64, d_model=32, n_layers=2, d_ff=64, n_heads=2,
            n_kv_heads=1)
PROMPTS = ([4, 5], list(range(6, 15)), [7, 8, 9])
SPEC_STATS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_emitted",
              "steps", "decode_tokens")


@functools.lru_cache(maxsize=1)
def tiny():
    """(JAX model, JAX params, port model, port params) of the reference
    test's config; the init compiled as ``torch_parity.reference_lm``."""
    jmodel = jbuild_model(jconfigs.get("smollm-135m").reduced(**TINY))
    key = jax.random.PRNGKey(0)
    init = jax.jit(jmodel.init).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    jparams = init(key)
    model = build_model(configs.get("smollm-135m").reduced(**TINY),
                        device="cpu")
    return (jmodel, jparams, model, weights.from_jax_params(
        model, jax.tree.map(np.asarray, jparams)))


def _unoptimized(jitted):
    """``jitted`` compiled, once per argument signature, without XLA's
    backend optimizations, as ``torch_parity.reference_lm`` compiles its
    init: on one core a JAX engine's round compiles in a fraction of the
    time."""
    compiled = {}

    def call(*args):
        flat, tree = jax.tree.flatten(args)
        key = (tree, tuple(jax.typeof(a) for a in flat))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)
    return call


# the JAX engine's geometry: budgets that end rows in different rounds, a
# weak draft (frac 0.2: rejected drafts, so rollbacks), pages of 8 tokens
MAX_NEW = (3, 9, 6)
JAX_K, JAX_FRAC = 4, 0.2


def port_engine(k, frac, paged=False):
    model, params = tiny()[2:]
    return Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2),
        memory=MemoryConfig(max_len=64, paged=paged, page_size=8,
                            prefix_sharing=False),
        speculative=SpeculativeConfig(k=k, draft_rank_frac=frac)),
        device="cpu")


def _submit(eng, request, max_new=MAX_NEW):
    for i, p in enumerate(PROMPTS):
        eng.submit(request(uid=i, prompt=list(p), max_new_tokens=max_new[i]))


def _serve(eng, request=Request) -> dict:
    _submit(eng, request)
    return {r.uid: list(r.output) for r in eng.run()}


def _snapshot(eng) -> dict:
    """What a tick leaves: counters, each slot's request and position,
    page tables, free list, refcounts, the pool and the draft's cache (the
    reference's layer-stacked leaves, as numpy)."""
    pc = eng._pc
    tree = jax.tree.unflatten(pc.treedef, pc._merge(pc.pool, pc.static))
    return {"stats": {k: eng.stats[k] for k in SPEC_STATS},
            "slots": [None if s.req is None else
                      (s.req.uid, list(s.req.output), s.pos)
                      for s in eng.slots],
            "tables": pc.tables.copy(), "free": list(pc.pages._free),
            "ref": pc.pages.ref.copy(),
            "pool": jax.tree.map(np.asarray, tree["cycles"]["blk_0"]["mixer"]),
            "draft": jax.tree.map(np.asarray,
                                  eng.draft_cache["cycles"]["blk_0"]["mixer"])}


@functools.lru_cache(maxsize=1)
def jax_run():
    """The JAX paged speculative engine (k = 4, frac 0.2, prefix sharing
    off) ticked to the end: (tokens, per tick its return value and a
    ``_snapshot``).  Its paged step and round compile once each, at one
    padded shape, without backend optimizations (``_fixed``,
    ``_spec_fixed``)."""
    jmodel, jparams = tiny()[:2]
    eng = JEngine(jmodel, jparams, JEngineConfig(
        scheduler=JSchedulerConfig(slots=2),
        memory=JMemoryConfig(max_len=64, paged=True, page_size=8,
                             prefix_sharing=False),
        speculative=JSpeculativeConfig(k=JAX_K, draft_rank_frac=JAX_FRAC)),
        step_fn=_unoptimized(jax.jit(jmodel.prefill_chunk)))
    eng._paged_step = _fixed(eng, 16)
    eng._paged_spec = _spec_fixed(eng)
    _submit(eng, JRequest)
    ticks = []
    while True:
        more = eng.tick()
        ticks.append((more, _snapshot(eng)))
        if not more:
            break
    return {r.uid: list(r.output) for r in eng.finished}, ticks


def _linear(jparams, group, name, layer=0):
    """One linear of the reference's scanned layers as numpy (QArrays
    kept)."""
    return jax.tree.map(lambda a: np.asarray(a)[layer],
                        jparams["cycles"]["blk_0"][group][name],
                        is_leaf=lambda t: isinstance(t, jq.QArray))


def _jax_leaf(a):
    """A port leaf (tensor or QArray) as the reference's, the same bits."""
    if quant.is_qarray(a):
        return jq.QArray(jnp.asarray(a.q.numpy()),
                         jnp.asarray(a.scale.numpy()), bits=a.bits,
                         last_dim=a.last_dim)
    return jnp.asarray(a.numpy())


# -- nested-rank truncation ----------------------------------------------------


def test_rank_spectra_match_reference():
    """Every linear's spectrum, layer by layer and averaged over the layers
    as the plan uses it, within 1e-5 relative."""
    jmodel, jparams, model, params = tiny()
    for group, name in (("mixer", "qkv"), ("mixer", "out"), ("ffn", "gate"),
                        ("ffn", "up"), ("ffn", "wo")):
        for layer in range(2):
            lin = _linear(jparams, group, name, layer)
            want = np.asarray(jstructures.rank_spectrum(lin))
            got = structures.rank_spectrum(
                params["layers"][layer][group][name])
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    want = jax.jit(jmodel.rank_spectra)(jparams)
    got = model.rank_spectra(params)
    assert weights.plan_from_jax(dict.fromkeys(want, 0)) == dict.fromkeys(
        got, 0)
    for k, v in want.items():
        np.testing.assert_allclose(
            got[weights.plan_from_jax({k: 0}).popitem()[0]].numpy(),
            np.asarray(v), rtol=1e-5, atol=0)


@pytest.mark.parametrize("r_prime", [3, 6])
@pytest.mark.parametrize("storage", ["float", "int8", "int4"])
def test_truncate_rank_bit_for_bit(storage, r_prime):
    """The kept components' factors (int8: codes; int4: the repacked bytes)
    and scales equal the reference's bit for bit.  The reference's int8
    truncation keeps the full rank in ``last_dim`` (its ``shape`` reports
    r); the port's reports the kept rank, as int4's does in both."""
    model, params = tiny()[2:]
    lin = params["layers"][0]["ffn"]["gate"]
    if storage != "float":     # the port's codes equal the reference's
        lin = model.specs[0].ffn.gate.quantize(
            lin, 8 if storage == "int8" else 4)
    want = _unoptimized(jax.jit(lambda t: jstructures.truncate_rank(
        t, r_prime)))({k: _jax_leaf(v) for k, v in lin.items()})
    got = structures.truncate_rank(lin, r_prime)
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if storage == "float":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=k)
            continue
        np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q), err_msg=k)
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale),
                                      err_msg=k)
        assert g.shape[-1] == r_prime and g.bits == w.bits, k
    assert structures.linear_rank(got) == r_prime
    full = structures.linear_rank(lin)
    assert structures.truncate_rank(got, full) == got     # r' ≥ r: unchanged


def test_calibrate_ranks_matches_reference():
    rng = np.random.default_rng(1)
    cases = [{"a": np.array([8.0, 4.0, 2.0, 1.0]),
              "b": np.array([100.0, 0.1, 0.1, 0.1])},
             {f"l{i}": rng.exponential(size=n) for i, n in
              enumerate((16, 24, 24, 9))},
             {"z": np.zeros(4), "o": np.ones(6)}]
    for spectra in cases:
        for frac in (1e-9, 0.2, 0.5, 0.77, 1.0, 1.5):
            assert compress.calibrate_ranks(spectra, frac) == (
                jcompress.calibrate_ranks(spectra, frac)), (spectra, frac)
    assert compress.calibrate_ranks(cases[0], 0.5) == {"a": 3, "b": 1}


@pytest.mark.parametrize("frac", [0.2, 0.5, 1.0])
@pytest.mark.parametrize("arch", ["smollm-135m", "llama7b-blast"])
def test_draft_plan_matches_reference(arch, frac):
    """The port's plan, under ``weights.plan_from_jax``'s one-to-one names,
    equals the reference's; llama7b-blast's attention and FFN linears have
    different full ranks (16 and 24 here)."""
    if arch == "smollm-135m":
        jmodel, jparams, model, params = tiny()
    else:
        jmodel, jparams, model, params = dense_reference(arch)
    want = weights.plan_from_jax(jmodel.draft_plan(jparams, frac))
    assert model.draft_plan(params, frac) == want
    if arch == "smollm-135m" and frac == 0.5:   # the reference's own record
        assert want == {"layers.ffn.gate": 4, "layers.ffn.up": 5,
                        "layers.ffn.wo": 2, "layers.mixer.out": 5,
                        "layers.mixer.qkv": 5}
    if frac == 1.0:
        assert want == {k: structures.linear_rank(lin) for k, lin in
                        [(f"layers.{g}.{n}", params["layers"][0][g][n])
                         for g, n in (("mixer", "qkv"), ("mixer", "out"),
                                      ("ffn", "gate"), ("ffn", "up"),
                                      ("ffn", "wo"))]}


def test_truncate_params_leaf_equal():
    """Every layer's truncated factors equal the reference's (each layer
    keeps its own components), and everything else is the full model's."""
    jmodel, jparams, model, params = tiny()
    jplan = jmodel.draft_plan(jparams, 0.5)
    want = _unoptimized(jax.jit(lambda p: jmodel.truncate_params(p, jplan)))(
        jparams)
    got = model.truncate_params(params, weights.plan_from_jax(jplan))
    ref = weights.from_jax_params(model, jax.tree.map(np.asarray, want))
    for i, (g, w) in enumerate(zip(got["layers"], ref["layers"])):
        assert all(torch.equal(a, b) for a, b in zip(leaves(g), leaves(w))), i
        assert structures.linear_rank(g["ffn"]["wo"]) == jplan[
            "cycles.blk_0.ffn.wo"]
    assert got["embed"] is params["embed"]


# -- the model's speculative pieces --------------------------------------------


def test_prefill_all_logits_matches_reference():
    """``prefill_chunk(all_logits=True)`` heads every column: (B, C, V)
    within 1e-4 of the reference on every live column, and its last live
    column equals the default call's."""
    jmodel, jparams, model, params = tiny()
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 64, size=(3, 8)).astype(np.int32)
    steps = np.array([0, 5, 11], np.int32)
    n = np.array([8, 3, 6], np.int32)
    cache = model.init_cache(3, 32)      # a 16-token prefix, in both
    model.prefill_chunk(params, cache, torch.from_numpy(
        rng.integers(0, 64, (3, 16))), np.zeros(3), None)
    jcache = jmodel.init_cache(3, 32)
    jcache["cycles"]["blk_0"]["mixer"] = {
        name: jnp.stack([jnp.asarray(c[name].numpy()) for c in cache])
        for name in cache[0]}
    want, _ = _unoptimized(jax.jit(functools.partial(
        jmodel.prefill_chunk, all_logits=True)))(
        jparams, jcache, toks, steps, n)
    before = [{k: v.clone() for k, v in c.items()} for c in cache]
    got, _ = model.prefill_chunk(params, cache, torch.from_numpy(toks), steps,
                                 n, all_logits=True)
    assert got.shape == (3, 8, 64)
    want = np.asarray(want)
    for b in range(3):
        np.testing.assert_allclose(got[b, :n[b]].numpy(), want[b, :n[b]],
                                   **TOL)
    for c, c0 in zip(cache, before):      # the same step without all_logits
        for k, v in c0.items():
            c[k].copy_(v)
    last, _ = model.prefill_chunk(params, cache, torch.from_numpy(toks),
                                  steps, n)
    for b in range(3):
        assert torch.equal(last[b, 0], got[b, n[b] - 1])


@pytest.mark.parametrize("cache_mode", ["none", "int8"])
def test_rollback_equals_feeding_committed(cache_mode):
    """A verify chunk of Cv = 8 tokens written at steps, rolled back to
    n_comm ∈ {0, 3, Cv} per row, leaves every leaf as feeding exactly
    n_comm tokens does: positions, K/V (int8: codes) bit for bit, int8
    scales within the reference test's one fp32 ulp — and the spare slot
    aside, the rows' slots past the window untouched."""
    cfg = configs.get("smollm-135m").reduced(
        **TINY, quant=quant.QuantConfig(cache=cache_mode))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    B, Lp, Cv = 3, 4, 8
    rng = np.random.default_rng(7)
    base = model.init_cache(B, 64)
    model.prefill_chunk(params, base, torch.from_numpy(
        rng.integers(0, 64, (B, Lp))), np.zeros(B), None)
    vt = torch.from_numpy(rng.integers(0, 64, (B, Cv)))
    steps = torch.full((B,), Lp, dtype=torch.int64)
    n_comm = torch.tensor([0, 3, Cv])
    live = (n_comm > 0).to(torch.int64)

    def copy(cache):
        out = model.init_cache(B, 64)
        for c, c0 in zip(out, cache):
            for k, v in c0.items():
                c[k].copy_(v)
        return out

    rolled, fed = copy(base), copy(base)
    saved = model.cache_window(rolled, steps, Cv)
    model.prefill_chunk(params, rolled, vt, steps, live * Cv)
    model.rollback_cache(rolled, saved, steps, n_comm)
    model.prefill_chunk(params, fed, vt, steps, n_comm)
    for i, (r, f) in enumerate(zip(rolled, fed)):
        assert set(r) == set(f)
        for k in r:
            if k.endswith("_scale"):
                np.testing.assert_allclose(r[k].float().numpy(),
                                           f[k].float().numpy(), rtol=1.3e-7,
                                           atol=0, err_msg=f"{i}/{k}")
            else:
                assert torch.equal(r[k], f[k]), (i, k)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_tokens_equal_plain_and_reference(k):
    """Greedy speculative tokens (frac 0.9, as the reference's test) equal
    the port's plain engine's and the JAX speculative engine's (whose
    tokens equal its plain decoding whatever its k and draft)."""
    want = jax_run()[0]
    plain = _serve(port_engine(0, 0.9))
    eng = port_engine(k, 0.9)
    got = _serve(eng)
    assert got == plain == want
    assert [len(got[i]) for i in range(3)] == list(MAX_NEW)
    assert eng.stats["spec_rounds"] > 0
    assert 0 < eng.stats["spec_emitted"] <= eng.stats["decode_tokens"]


def _leaves_equal(got: list, want: dict, what: str) -> None:
    """The port's per-layer cache (or pool pages) against the reference's
    layer-stacked leaves: positions exact, K/V within ``TOL``."""
    for i, c in enumerate(got):
        assert set(c) == set(want), what
        for name, leaf in c.items():
            w = want[name][i]
            if name == "pos":
                np.testing.assert_array_equal(leaf.numpy(), w,
                                              err_msg=f"{what} {i}/{name}")
            else:
                np.testing.assert_allclose(leaf.numpy(), w, **TOL,
                                           err_msg=f"{what} {i}/{name}")


def _lockstep(eng, check) -> None:
    """Tick ``eng`` beside the JAX run's snapshots: after every tick the
    same return value, counters, slots and draft cache, and ``check(eng,
    snapshot, tick)``."""
    _submit(eng, Request)
    for i, (more, snap) in enumerate(jax_run()[1]):
        assert eng.tick() == more, i
        assert {k: eng.stats[k] for k in SPEC_STATS} == snap["stats"], i
        assert [None if s.req is None else (s.req.uid, s.req.output, s.pos)
                for s in eng.slots] == snap["slots"], i
        _leaves_equal(eng.draft_cache, snap["draft"], f"draft cache, tick {i}")
        check(eng, snap, i)
    assert {r.uid: r.output for r in eng.finished} == jax_run()[0]


def test_rejections_lockstep_with_reference():
    """The slot-static engine at the JAX run's k = 4 and frac 0.2: the weak
    draft is rejected, rows finish in different rounds, slots are
    recycled.  After every tick the tokens, positions, round counters and
    every leaf of the draft's cache equal the reference's (the port's
    draft steps write its draft cache in place; the rollback leaves it as
    the reference's throwaway copy does); acceptance and tokens a round
    follow from the counters."""
    eng = port_engine(JAX_K, JAX_FRAC)
    _lockstep(eng, lambda *_: None)
    s = eng.stats
    assert 0 < s["spec_rounds"] and s["spec_accepted"] < s["spec_drafted"]
    tp = eng.throughput()
    assert tp["acceptance_rate"] == s["spec_accepted"] / s["spec_drafted"]
    assert tp["tokens_per_round"] == s["spec_emitted"] / s["spec_rounds"]


def test_paged_spec_matches_slot_static_and_reference():
    """The paged speculative engine at the JAX run's geometry: after every
    tick the page tables, free list, refcounts and every pool page (the
    port's sink aside) equal the JAX paged engine's, as do the tokens,
    counters and the draft's cache; and it equals the slot-static engine
    in tokens and counters."""
    def pool(eng, snap, i):
        pc = eng._pc
        np.testing.assert_array_equal(pc.tables, snap["tables"], err_msg=i)
        assert pc.pages._free == snap["free"], i
        np.testing.assert_array_equal(pc.pages.ref, snap["ref"])
        pc.audit()
        pages = [{k: v[:pc.n_pages, layer] for k, v in pc.pool.items()}
                 for layer in range(pc.L)]
        _leaves_equal(pages, snap["pool"], f"pool, tick {i}")

    eng = port_engine(JAX_K, JAX_FRAC, paged=True)
    _lockstep(eng, pool)
    static = port_engine(JAX_K, JAX_FRAC)
    assert _serve(static) == {r.uid: r.output for r in eng.finished}
    assert {k: static.stats[k] for k in SPEC_STATS} == {
        k: eng.stats[k] for k in SPEC_STATS}


def test_k0_is_the_plain_engine():
    eng = port_engine(0, 0.5)
    base = _serve(eng)
    assert eng.spec_k == 0 and not hasattr(eng, "draft_cache")
    assert all(eng.stats[s] == 0 for s in SPEC_STATS[:4])
    assert "acceptance_rate" not in eng.throughput()
    model, params = tiny()[2:]
    default = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2), memory=MemoryConfig(max_len=64)),
        device="cpu")
    assert _serve(default) == base


def test_capacity_inside_a_round():
    """Rows that reach the cache's end inside a round: the budget clamps
    what they commit, the verify's columns past the cache write the spare
    slot, and the tokens and stop reasons equal plain decoding's, slot-
    static and paged."""
    model, params = tiny()[2:]

    def serve(k, paged):
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=2),
            memory=MemoryConfig(max_len=24, paged=paged, page_size=8,
                                prefix_sharing=False),
            speculative=SpeculativeConfig(k=k, draft_rank_frac=1.0)),
            device="cpu")
        for i, n in enumerate((14, 9, 17)):
            eng.submit(Request(uid=i, prompt=list(range(1, n + 1)),
                               max_new_tokens=40))
        done = {r.uid: (r.output, r.stop_reason) for r in eng.run()}
        if paged:
            eng._pc.audit()
        return done, eng

    plain, _ = serve(0, False)
    assert all(reason == "capacity" for _, reason in plain.values())
    for paged in (False, True):
        got, eng = serve(4, paged)
        assert got == plain, paged
        assert eng.stats["spec_rounds"] > 0


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_padded_draft_equals_unpadded(bits):
    """The draft's factors padded once to the tile kernel's rank granule
    (16; the planned ranks are not multiples of it): each linear's factors
    (int8: codes; int4: packed bytes) equal bit for bit what the kernel
    wrappers' per-launch padding (``ops._pad_last``) makes of the unpadded
    draft, so on the card both reach the kernel as the same bytes
    (``chip_smoke.py`` holds their logits equal bit for bit there).  On the
    CPU the plain version's product over the rank axis blocks its sums by
    the rank's length, so the logits are held to 1e-6."""
    model, params = tiny()[2:]
    plan = model.draft_plan(params, 0.5)
    assert any(r % 16 for r in plan.values())
    p = params if bits is None else model.quantize_params(
        params, quant.QuantConfig(weights=f"int{bits}"))
    draft = model.truncate_params(p, plan)
    padded = model.pad_ranks(draft, 16)
    assert model.pad_ranks(padded, 16) is not padded    # a new tree ...
    n = 0
    for layer, layer_p in zip(draft["layers"], padded["layers"]):
        for group in ("mixer", "ffn"):
            for name, lin in layer[group].items():
                lp = layer_p[group][name]
                assert structures.linear_rank(lp) == 16
                for k in ("U", "S", "V"):
                    a, b = lin[k], lp[k]
                    if bits is not None:        # ... of the same scales
                        assert b.scale is a.scale
                        a, b = a.q, b.q
                    stored = 8 if bits == 4 else 16
                    assert torch.equal(kops._pad_last(a, stored), b), name
                    n += 1
    assert n == 2 * 5 * 3
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 64, (2, 6)))
    outs = [model.prefill_chunk(tree, model.init_cache(2, 16), toks,
                                np.zeros(2), None, all_logits=True)[0]
            for tree in (draft, padded)]
    torch.testing.assert_close(outs[1], outs[0], atol=1e-6, rtol=0)


def test_launcher_speculative(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "smollm-135m", "--reduced", "--device",
                       "cpu", "--speculative", "4", "--requests", "3",
                       "--max-new", "6"])
    out = capsys.readouterr().out
    assert "draft keeps" in out and "acceptance" in out
    assert all(len(r.output) == 6 for r in reqs)
