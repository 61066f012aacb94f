"""The hybrid family's serving modes in the port (ROADMAP A7's rest: the
int8 cache over RG-LRU state and the ring, the RG-LRU state's per-token
snapshots and rollback, the paged cache's state leaves and snapshot slots)
against the JAX package, in fp32 on the CPU, on the reduced hybrid of
``tests/test_torch_hybrid.py`` (``hybrid_reference``: 8 layers, window 16,
its weights drawn by numpy in the layout of the reference's ``LM.init``):

- the state codec (``quant.pack_state_cache``): codes and bf16/fp32 scales
  equal the reference's jitted ``pack_state_cache`` bit for bit (the fp32
  scale takes the jitted form, a multiply by float32(1/127); eager JAX
  divides, and differs by an ulp in some rows);
- ``rglru_prefill`` with ``collect`` and ``rglru_cache_rollback`` at every
  n_comm in [0, C], float and int8: outputs, snapshots and rolled-back
  state within 1e-5, the rolled-back int8 codes equal where the rollback
  re-packs the incoming state (n_comm = 0) and within one step elsewhere;
- the int8 cache's model step (an int8 ring and int8 RG-LRU state) across
  a ring wrap: logits within 1e-4, the ring's codes, bf16 scales and
  ``pos`` bit for bit after every step;
- the paged engine against the JAX paged engine tick by tick, with rings
  as state leaves (max_len 64 > window 16: a nominal pool) and with rings
  paged (window = max_len = 32): page tables, free list, snapshot free
  list, prefix entries, every pool and state leaf, and tokens; one request
  hits a registered prefix and restores its snapshot.

Where the engine's int8 state meets the reference's: the state's float
``h`` differs from the reference's by ulps (sums in other orders), and an
fp32 scale keeps that ulp (a bf16 one rounds it away); so the engine-level
int8 tests check the state's codes within one step and scales within 1e-6
relative, then give the port the reference's codes (``_share_state``, as
``chip_smoke.py``'s ``SharedRowCodes`` gives the CPU the card's; ROADMAP
C10).  The JAX programs compile without backend optimizations
(``_unoptimized``), each at one fixed shape (``_padded``, ``_fixed``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.models import build_model as jbuild_model
from repro.models import rglru as jrglru
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs, quant
from repro_torch.models import build_model, rglru
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SchedulerConfig)
from test_torch_hybrid import (LAYERS, _cache_leaves, _mixer, _padded,
                               _unoptimized, hybrid_reference)
from torch_parity import TOL

EXACT = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    """A JAX or numpy array as a tensor of its dtype (bf16 too)."""
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


@functools.lru_cache(maxsize=None)
def variant(window: int | None = None, cache: str = "none",
            n_layers: int = LAYERS):
    """(JAX model, port model) of the reduced hybrid at ``n_layers`` layers
    with another window or the int8 cache; the weights are
    ``hybrid_reference(n_layers)``'s (neither changes a parameter's
    shape)."""
    jcfg = jconfigs.get("recurrentgemma-2b").reduced(n_layers=n_layers)
    cfg = configs.get("recurrentgemma-2b").reduced(n_layers=n_layers)
    kw = {} if window is None else {"window": window}
    jcfg = dataclasses.replace(jcfg, quant=jq.QuantConfig(cache=cache), **kw)
    cfg = dataclasses.replace(cfg, quant=quant.QuantConfig(cache=cache),
                              **kw)
    return jbuild_model(jcfg), build_model(cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jstep(jmodel):
    return _unoptimized(jax.jit(jmodel.prefill_chunk))


def _share_state(cache, jleaves, what):
    """Hold an int8 RG-LRU layer's state (``cache``: the port's leaves)
    against the reference's (``jleaves``, numpy): codes within one step,
    scales within 1e-6 relative; then give the port the reference's codes
    and scales, so that both go on from one state."""
    for name in ("conv", "h"):
        got, want = cache[name], _t(jleaves[name])
        step = (got.int() - want.int()).abs()
        assert int(step.max()) <= 1, (what, name)
        s, ws = cache[f"{name}_scale"].float(), _t(
            jleaves[f"{name}_scale"]).float()
        assert float(((s - ws).abs() / ws.clamp(min=1e-30)).max()) <= 1e-6, (
            what, name)
        cache[name].copy_(want)
        cache[f"{name}_scale"].copy_(_t(jleaves[f"{name}_scale"]))


def _leaf_close(got, want, what):
    """A cache leaf against the reference's: positions and int8 codes
    exact, bf16 scales bit for bit, floats within 1e-4."""
    got = got.numpy() if got.dtype != torch.bfloat16 else got.float().numpy()
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
    if want.dtype in (np.int32, np.int8) or "scale" in what:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, **TOL, err_msg=what)


# -- the state codec --------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_codec_equals_jitted_jax(dtype):
    """``pack_state_cache`` against the reference's, jitted as its engine
    runs it (rows at several scales, a zero row, a spike): the fp32 ``h``
    codes and scales bit for bit — the eager reference's scales differ from
    the jitted ones by an ulp in some rows, the reason for the multiply
    form; the conv tail's codes and bf16 scales bit for bit in fp32, and,
    over a bf16 conv tail, equal to the eager reference's, the form of the
    K/V cache's codec (``tests/test_torch_kv_int8.py``), which the jitted
    one's fp32 scale moves by a code step at a few rounding ties.
    ``unpack_state_cache`` equal too."""
    rng = np.random.default_rng(0)
    h = (rng.standard_normal((512, 64))
         * rng.uniform(1e-3, 50.0, (512, 1))).astype(np.float32)
    h[3] = 0.0
    h[4, 17] = 300.0
    conv = (rng.standard_normal((64, 3, 64))
            * rng.uniform(1e-2, 10.0, (64, 3, 1))).astype(np.float32)
    conv[5, 1] = 0.0
    jconv = jnp.asarray(conv).astype(dtype)
    tconv = _t(conv).to(getattr(torch, dtype))
    jitted = _unoptimized(jax.jit(
        lambda c, x: jq.pack_state_cache(True, c, x)))
    want = jitted(jconv, jnp.asarray(h))
    eager = jq.pack_state_cache(True, jconv, jnp.asarray(h))
    got = quant.pack_state_cache(True, tconv, _t(h))
    assert set(got) == set(want) == {"conv", "conv_scale", "h", "h_scale"}
    assert got["h_scale"].dtype == torch.float32
    assert got["conv_scale"].dtype == torch.bfloat16
    for name in got:
        ref = eager if name.startswith("conv") and dtype != "float32" else want
        _leaf_close(got[name], ref[name], f"{name} ({dtype})")
    assert (np.asarray(eager["h_scale"]) != np.asarray(want["h_scale"])).any()
    back = quant.unpack_state_cache(True, got, getattr(torch, dtype))
    jback = jq.unpack_state_cache(True, jax.tree.map(
        jnp.asarray, {k: v.float().numpy() if v.dtype == torch.bfloat16
                      else v.numpy() for k, v in got.items()}), dtype)
    for g, w in zip(back, jback):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w).astype(np.float32))
    assert back[1].dtype == torch.float32


# -- RG-LRU snapshots and rollback ----------------------------------------------


@pytest.mark.parametrize("cache_mode", ["none", "int8"])
def test_rglru_collect_and_rollback(cache_mode):
    """One verify-like chunk of C = 6 from a nonzero state, row b rolled
    back to n_comm = b (every value in [0, C]): the chunk's outputs, its
    snapshots ``h_snap`` (C + 1) and ``conv_hist``, and the rolled-back
    ``conv`` and ``h`` against ``rglru_prefill(collect=True)`` and
    ``rglru_cache_rollback``."""
    jmodel, tree, model, params = hybrid_reference()
    jmodel_q, model_q = variant(cache=cache_mode)
    jspec, spec = jrglru.make_rglru(jmodel_q.cfg), model_q.specs[0].mixer
    jp, p = _mixer(tree), params["layers"][0]["mixer"]
    C, B = 6, 7
    rng = np.random.default_rng(31)
    quantized = cache_mode == "int8"
    state = jq.pack_state_cache(
        quantized, jnp.asarray(rng.standard_normal((B, 3, 64)), jnp.float32),
        jnp.asarray(rng.standard_normal((B, 64)), jnp.float32))
    x = rng.standard_normal((B, C, 64)).astype(np.float32)
    n = np.full((B,), C, np.int32)
    n[1] = 4                        # a ragged row: columns past 4 are dead
    n_comm = np.arange(B, dtype=np.int32).clip(max=C)
    n_comm[1] = 3

    def reference(c, x, n, n_comm):
        y, new = jrglru.rglru_prefill(jspec, jp, c, x,
                                      jnp.zeros((B,), jnp.int32), n,
                                      collect=True)
        return y, new, jrglru.rglru_cache_rollback(jspec, new, n_comm)

    want_y, want_new, want_back = _unoptimized(jax.jit(reference))(
        state, jnp.asarray(x), jnp.asarray(n), jnp.asarray(n_comm))
    cache = {k: _t(v) for k, v in state.items()}
    snaps = {}
    y, _ = rglru.rglru_prefill(spec, p, cache, _t(x), None, _t(n).long(),
                               collect=snaps)
    live = np.arange(C)[None, :] < n[:, None]
    np.testing.assert_allclose(y.numpy()[live], np.asarray(want_y)[live],
                               **EXACT)
    for name in ("h_snap", "conv_hist"):
        np.testing.assert_allclose(snaps[name].numpy(),
                                   np.asarray(want_new[name]), **EXACT,
                                   err_msg=name)
    rglru.rglru_cache_rollback(spec, cache, snaps, _t(n_comm).long())
    assert set(cache) == set(want_back)
    for name, leaf in cache.items():
        want = np.asarray(want_back[name])
        if not quantized or "scale" in name:
            np.testing.assert_allclose(leaf.float().numpy(),
                                       want.astype(np.float32),
                                       rtol=1e-5, atol=0, err_msg=name)
        else:
            step = np.abs(leaf.numpy().astype(np.int32) - want)
            assert step.max() <= 1, name
            np.testing.assert_array_equal(leaf.numpy()[0], want[0],
                                          err_msg=name)   # n_comm = 0


# -- the int8 cache's step --------------------------------------------------------


def test_int8_cache_step_across_a_wrap():
    """The int8 cache model (int8 ring K/V with bf16 scales, int8 RG-LRU
    state): ragged chunks of a 30-token prompt that wraps the 16-slot ring,
    then decode steps.  Logits within 1e-4; after every step each ring's
    ``pos``, codes and scales bit for bit, each state within one code step
    (then shared, ``_share_state``)."""
    _, tree, _, params = hybrid_reference()
    jmodel, model = variant(cache="int8")
    jcache, cache = jmodel.init_cache(4, 64), model.init_cache(4, 64)
    assert cache[2]["k"].dtype == torch.int8 and set(cache[0]) == {
        "conv", "conv_scale", "h", "h_scale"}
    step = _padded(_jstep(jmodel), 8)
    ptree = jmodel.prestack_params(tree)
    rng = np.random.default_rng(8)
    steps = np.zeros(4, np.int32)
    for C, n in [(8, [8, 5, 8, 1]), (8, [8, 8, 0, 2]), (8, [8, 3, 8, 0]),
                 (8, [6, 0, 8, 8]), (1, [1, 1, 1, 1]), (1, [1, 0, 1, 1])]:
        n = np.array(n, np.int32)
        toks = rng.integers(0, 512, (4, C)).astype(np.int32)
        want, jcache = step(ptree, jcache, toks, steps, n)
        got, _ = model.prefill_chunk(params, cache, torch.from_numpy(toks),
                                     steps, n)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL)
        for i, c in enumerate(cache):
            ref = _cache_leaves(jcache, i)
            if model.specs[i].kind == "rglru":
                _share_state(c, ref, f"layer {i}")
                continue
            for name, leaf in c.items():
                _leaf_close(leaf, ref[name], f"{i}/{name}")
        steps = steps + n
    assert steps[0] == 32     # row 0 filled its ring twice


# -- the paged cache ----------------------------------------------------------------


PAGE = 8


def _fixed(jeng, C, F=4, M=8):
    """The JAX paged engine's step padded to one shape — chunk width C,
    F fresh pages and M write triples (padding: the dropped page n_pages)
    — and compiled once, unoptimized."""
    inner = _unoptimized(jeng._paged_step)
    n_pages = jeng._pc.n_pages

    def pad(a, size, fill):
        a = np.asarray(a)
        assert a.shape[0] <= size
        return jnp.asarray(np.concatenate(
            [a, np.full((size - a.shape[0],), fill, a.dtype)]))

    def step(params, pool, static, table, fresh, rows, lps, phys, tokens,
             steps, n_tokens):
        tokens = jnp.pad(tokens, ((0, 0), (0, C - tokens.shape[1])))
        return inner(params, pool, static, table, pad(fresh, F, n_pages),
                     pad(rows, M, 0), pad(lps, M, 0),
                     pad(phys, M, n_pages), tokens, steps, n_tokens)
    return step


def _spec_fixed(jeng, F=8, M=8):
    """The JAX paged engine's speculative round with its page operands
    padded to one shape — F fresh pages and M write triples (padding: the
    dropped page n_pages, as the engine pads them to its own buckets) — and
    compiled once, unoptimized, instead of once for each bucket pair."""
    inner = _unoptimized(jeng._paged_spec)
    n_pages = jeng._pc.n_pages

    def pad(a, size, fill):
        a = np.asarray(a)
        assert a.shape[0] <= size
        return jnp.asarray(np.concatenate(
            [a, np.full((size - a.shape[0],), fill, a.dtype)]))

    def spec_round(params, draft, pool, static, draft_cache, table, fresh,
                   rows, lps, phys, *rest):
        return inner(params, draft, pool, static, draft_cache, table,
                     pad(fresh, F, n_pages), pad(rows, M, 0), pad(lps, M, 0),
                     pad(phys, M, n_pages), *rest)
    return spec_round


def _schedule(shared_len=16):
    """{tick: [(uid, prompt, max_new)]}: two requests, then one that shares
    the first one's registered prefix (a hit that restores its snapshot)
    and one more."""
    rng = np.random.default_rng(5)

    def toks(n):
        return [int(t) for t in rng.integers(0, 512, n)]
    shared = toks(shared_len)
    return {0: [(0, shared + toks(4), 6), (1, toks(11), 5)],
            5: [(2, shared + toks(5), 6), (3, toks(3), 4)]}


def _paged_pair(jmodel, model, params, tree, max_len, snap_slots):
    mem = dict(max_len=max_len, paged=True, page_size=PAGE,
               snap_slots=snap_slots)
    sched = dict(slots=2, chunk_size=8)
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(**sched), memory=JMemoryConfig(**mem)))
    jeng._paged_step = _fixed(jeng, 8)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(**sched), memory=MemoryConfig(**mem)),
        device="cpu")
    return jeng, eng


def _paged_lockstep(jeng, eng, schedule, prefix_len=None,
                    leaves=_cache_leaves):
    """Tick both engines through ``schedule``, every request given the
    ``prefix_len`` hint; after every tick the tables, free list, snapshot
    free list, prefix entries (their snapshot slots too) and every pool and
    state leaf agree (``leaves(tree, i)``: layer i's leaves of the
    reference's cache tree).  Returns the port's requests and the
    reference's tokens."""
    jpc, pc = jeng._pc, eng._pc
    reqs, tick = [], 0
    while True:
        for uid, prompt, max_new in schedule.get(tick, []):
            jeng.submit(JRequest(uid=uid, prompt=prompt,
                                 max_new_tokens=max_new,
                                 prefix_len=prefix_len))
            reqs.append(Request(uid=uid, prompt=prompt,
                                max_new_tokens=max_new,
                                prefix_len=prefix_len))
            eng.submit(reqs[-1])
        more = jeng.tick()
        assert eng.tick() == more, tick
        np.testing.assert_array_equal(pc.tables, jpc.tables, err_msg=tick)
        assert pc.pages._free == jpc.pages._free, tick
        assert pc._snap_free == jpc._snap_free, tick
        assert {k: (e.pages, e.snap) for k, e in pc.prefix.entries.items()} \
            == {k: (e.pages, e.snap) for k, e in jpc.prefix.entries.items()}
        for k in ("prefix_hit_tokens", "steps", "preemptions"):
            assert eng.stats[k] == jeng.stats[k], (tick, k)
        tree = jax.tree.unflatten(jpc.treedef, jpc._merge(jpc.pool,
                                                          jpc.static))
        for i, names in enumerate(pc.names):
            ref = leaves(tree, i)
            for name in names:
                if (i, name) in pc.static:
                    got = pc.static[(i, name)]
                else:
                    got = pc.pool[name][:pc.n_pages,
                                        pc.layers[name].index(i)]
                _leaf_close(got, ref[name], f"tick {tick}: {i}/{name}")
        pc.audit()
        tick += 1
        if not more and tick > max(schedule):
            return reqs, {r.uid: list(r.output) for r in jeng.finished}


@pytest.mark.parametrize("rings", ["state", "paged"])
def test_paged_engine_matches_jax(rings):
    """``state``: max_len 64 past the 16-slot ring — every leaf is a state
    leaf, the pool nominal, the prefix shared through one snapshot slot at
    the default boundary (the prompt less its last token, down to a page:
    16); ``paged``: window = max_len = 32 — the rings are paged beside the
    RG-LRU state, and the requests' ``prefix_len`` hint of 8 sets the
    boundary.  Tokens equal the reference's."""
    _, tree, model, params = hybrid_reference()
    max_len = 64 if rings == "state" else 32
    jmodel, model = variant(window=None if rings == "state" else max_len)
    jeng, eng = _paged_pair(jmodel, model, params, tree, max_len, 2)
    pc = eng._pc
    assert pc.has_state and pc.has_paged == (rings == "paged")
    assert set(pc.layers) == ({"k", "v", "pos"} if rings == "paged"
                              else set())
    hint = None if rings == "state" else PAGE
    reqs, want = _paged_lockstep(jeng, eng, _schedule(), prefix_len=hint)
    assert eng.stats["prefix_hit_tokens"] == (16 if hint is None else hint)
    assert {r.uid: r.output for r in reqs} == want
