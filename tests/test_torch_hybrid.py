"""The hybrid family in the port (ROADMAP A7: RG-LRU, the sliding-window
ring, embedding scaling, the block-diagonal structure) against the JAX
package, in fp32 on the CPU.

``recurrentgemma-2b.reduced(n_layers=8)`` — 2 cycles of (rglru, rglru,
local_attn) and a 2-layer RG-LRU tail, window 16 — with weights drawn by
numpy in the layout of the reference's ``LM.init`` (``_seeded_tree``),
carried over by ``from_jax_params``; the JAX programs are compiled without
XLA's backend optimizations (``_unoptimized``), one program per chunk
width (``_padded``):

- ``block_diag``: apply, grouped apply and int8/int4 ``apply_q`` (codes
  and scales bit for bit) within 1e-5;
- ``causal_conv_chunk`` and the ring's plain attention (by key position,
  ``kernels/ref.attention_ring_ref``, through ``ops.flash_attention_ring``)
  against the reference's ``causal_conv_chunk`` and ``cache_attention``
  within 1e-5;
- ``rglru_prefill`` at chunk 1, 8 and 32 with ragged rows from a nonzero
  state, and ``rglru_apply``, within 1e-4 (outputs and every state leaf);
- the model: ``LM.apply`` and ragged ``prefill_chunk`` logits within 1e-4,
  and every cache leaf (ring ``pos`` exact, K/V, ``conv``, ``h`` within
  1e-4) after each chunk of a 30-token prompt that wraps the ring;
- the engine: greedy tokens equal the JAX engine's at chunk 1, 8 and 32
  with float weights and at chunk 8 with int8 and int4 weights, up to each
  request's first output position whose reference margin is below 1e-4;
- the A7 refusals of the engine and the launcher, and ``_reset_slot``
  zeroing a row's ``conv`` and ``h``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.core import structures as jstructures
from repro.core.structures import StructureConfig as JStructureConfig
from repro.models import build_model as jbuild_model
from repro.models import ops as jops
from repro.models import rglru as jrglru
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs, quant, weights
from repro_torch.configs import StructureConfig
from repro_torch.core import structures
from repro_torch.kernels import ops as kops
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import ops
from repro_torch.models import rglru
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig,
                               SpeculativeConfig)
from torch_parity import MARGIN, MAX_NEW, TOL, _prompts

EXACT = dict(atol=1e-5, rtol=1e-5)
LAYERS = 8          # 2 cycles of the 3-layer pattern and a 2-layer tail
WINDOW = 16         # reduced(): the ring's slots


def _unoptimized(jitted):
    """``jitted`` compiled once per argument signature without XLA's
    backend optimizations (a fraction of the compile time on one core)."""
    compiled = {}

    def call(*args):
        flat, tree = jax.tree.flatten(args)
        key = (tree, tuple(jax.typeof(a) for a in flat))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled[key](*args)
    return call


def _seeded_tree(jmodel, rng) -> dict:
    """Weights in the layout of the reference's ``LM.init`` (its
    ``jax.eval_shape``), drawn with numpy: norm scales, biases and the conv
    ~ N(0, 0.1²) (``init`` leaves them at 0 or the identity, where they
    would not change the logits), Λ ~ U(-2, 2), the embedding ~ N(0,
    0.02²), every other matrix ~ N(0, 1/fan-in).  Compiling ``init`` would
    take longer than every other program of this file."""
    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "bias", "conv_b", "conv_w"):
            a = 0.1 * rng.standard_normal(leaf.shape)
        elif name == "lam":
            a = rng.uniform(-2.0, 2.0, leaf.shape)
        elif name == "embed":
            a = 0.02 * rng.standard_normal(leaf.shape)
        else:
            a = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[-2])
        return a.astype(leaf.dtype)
    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=1)
def hybrid_reference():
    """(JAX model, numpy params, port model, port params) of the reduced
    hybrid, built once per process."""
    jmodel = jbuild_model(jconfigs.get("recurrentgemma-2b").reduced(
        n_layers=LAYERS))
    tree = _seeded_tree(jmodel, np.random.default_rng(23))
    model = build_model(configs.get("recurrentgemma-2b").reduced(
        n_layers=LAYERS), device="cpu")
    return jmodel, tree, model, weights.from_jax_params(model, tree)


@functools.lru_cache(maxsize=None)
def _jstep(jmodel):
    """The reference's ``prefill_chunk``, compiled once per width."""
    return _unoptimized(jax.jit(jmodel.prefill_chunk))


def _padded(step, C: int):
    """``step`` with every chunk padded to width C by dead columns (they
    change nothing): a JAX engine's chunk buckets then share one
    compile."""
    def call(params, cache, tokens, steps, n_tokens):
        pad = C - tokens.shape[1]
        return step(params, cache, jnp.pad(jnp.asarray(tokens, jnp.int32),
                                           ((0, 0), (0, pad))),
                    jnp.asarray(steps, jnp.int32),
                    jnp.asarray(n_tokens, jnp.int32))
    return call


@functools.lru_cache(maxsize=None)
def _japply(jmodel):
    return _unoptimized(jax.jit(lambda p, t: jmodel.apply(p, t).logits))


def _t(a):
    return torch.from_numpy(np.array(a))


# -- block_diag --------------------------------------------------------------


def _bd_pair(d_in, d_out, b=4):
    return (jstructures.make_linear(
        d_in, d_out, JStructureConfig(kind="block_diag", b=b, keep_ratio=1.0)),
        structures.make_linear(
            d_in, d_out, StructureConfig(kind="block_diag", b=b,
                                         keep_ratio=1.0)))


def _bd_weights(rng, spec):
    return {"w": rng.standard_normal(spec.shapes["w"]).astype(np.float32)}


def _codes_equal(qp, jqp):
    a, b = qp["w"], jqp["w"]
    assert (a.bits, a.shape) == (b.bits, tuple(b.shape))
    np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
    np.testing.assert_array_equal(a.scale.numpy(), np.asarray(b.scale))


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_block_diag_apply(bits):
    rng = np.random.default_rng(1)
    jspec, spec = _bd_pair(64, 64)
    assert spec.shapes == dict(jspec.shapes) == {"w": (4, 16, 16)}
    assert structures.rank_kind(_bd_weights(rng, spec)) is None
    w = _bd_weights(rng, spec)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    if bits is None:
        want = jspec.apply({"w": jnp.asarray(w["w"])}, jnp.asarray(x))
        got = spec.apply({"w": _t(w["w"])}, _t(x))
    else:
        jqp = jspec.quantize({"w": jnp.asarray(w["w"])}, bits)
        qp = spec.quantize({"w": _t(w["w"])}, bits)
        _codes_equal(qp, jqp)
        want = jspec.apply_q(jqp, jnp.asarray(x))
        got = spec.apply_q(qp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_block_diag_grouped(bits):
    """gate_a + gate_x as one batched product (and a narrower member, which
    pads), against the reference's ``group_apply`` and the per-member
    apply."""
    rng = np.random.default_rng(2)
    pairs = [_bd_pair(64, 64), _bd_pair(64, 64), _bd_pair(64, 32)]
    jspecs, specs = [p[0] for p in pairs], [p[1] for p in pairs]
    ws = [_bd_weights(rng, s) for s in specs]
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    jps = [{"w": jnp.asarray(w["w"])} for w in ws]
    ps = [{"w": _t(w["w"])} for w in ws]
    if bits is not None:
        jps = [s.quantize(p, bits) for s, p in zip(jspecs, jps)]
        ps = [s.quantize(p, bits) for s, p in zip(specs, ps)]
    plan = structures.group_plan(specs, ps)
    assert plan["kind"] == "block_diag" and plan["p"] == 16
    got = structures.group_apply(specs, ps, _t(x))
    bundle = structures.prestack(specs, ps)
    stacked = structures.group_apply(specs, ps, _t(x), stacked=bundle.arrays)
    want = jstructures.group_apply(jspecs, jps, jnp.asarray(x))
    for g, s, w, spec, p in zip(got, stacked, want, specs, ps):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EXACT)
        np.testing.assert_array_equal(s.numpy(), g.numpy())
        one = spec.apply(p, _t(x)) if bits is None else spec.apply_q(p, _t(x))
        np.testing.assert_allclose(g.numpy(), one.numpy(), **EXACT)


# -- the conv and the ring's attention --------------------------------------


def test_causal_conv_chunk():
    rng = np.random.default_rng(3)
    hist = rng.standard_normal((4, 3, 24)).astype(np.float32)
    x = rng.standard_normal((4, 8, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    n = np.array([8, 3, 0, 1], np.int32)
    want_y, want_tail = jops.causal_conv_chunk(*map(jnp.asarray,
                                                    (hist, x, w, b, n)))
    y, tail = ops.causal_conv_chunk(*map(_t, (hist, x, w, b)),
                                    _t(n).long())
    live = np.arange(8)[None, :] < n[:, None]
    np.testing.assert_allclose(y.numpy()[live], np.asarray(want_y)[live],
                               **EXACT)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(want_tail))
    np.testing.assert_array_equal(tail.numpy()[2], hist[2])   # n = 0


def _wrapped_pos(B, S, last):
    """(B, S) ring positions: row b holds positions up to ``last[b]``, the
    latest S of them at p % S (wrapped rows), -1 where none was written."""
    pos = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p in range(max(0, last[b] - S + 1), last[b] + 1):
            pos[b, p % S] = p
    return pos


@pytest.mark.parametrize("C,window", [(1, 16), (5, 16), (5, 6), (1, None)])
def test_ring_attention_plain(C, window):
    """Attention by key position over a wrapped ring (and, at C = 5, the
    [ring ‖ chunk] concatenation of a chunk step): ``flash_attention_ring``
    on CPU tensors against the reference's ``cache_attention``."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, S, D = 3, 4, 2, 16, 8
    offs = np.array([40, 9, 16], np.int32)
    pos = _wrapped_pos(B, S, offs - 1)
    if C > 1:   # the chunk's own keys after the ring, one dead column
        chunk = offs[:, None] + np.arange(C)[None, :]
        chunk[1, -1] = -1
        pos = np.concatenate([pos, chunk.astype(np.int32)], axis=1)
    Sk = pos.shape[1]
    q = rng.standard_normal((B, Hq, C, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    want = jops.cache_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(pos),
                                jnp.asarray(offs[:, None] + np.arange(C)),
                                window=window)
    got = kops.flash_attention_ring(
        _t(q), _t(k).permute(0, 2, 1, 3), _t(v).permute(0, 2, 1, 3),
        _t(pos), _t(offs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EXACT)
    # kv_len cuts slots off: those keys are gone
    cut = kops.flash_attention_ring(
        _t(q), _t(k).permute(0, 2, 1, 3), _t(v).permute(0, 2, 1, 3),
        _t(np.where(np.arange(Sk) < 7, pos, -1)), _t(offs), window=window)
    np.testing.assert_array_equal(
        kops.flash_attention_ring(
            _t(q), _t(k).permute(0, 2, 1, 3), _t(v).permute(0, 2, 1, 3),
            _t(pos), _t(offs), window=window, kv_len=7).numpy(),
        cut.numpy())


# -- RG-LRU ------------------------------------------------------------------


def _mixer(tree, j=0, cycle=0):
    """One RG-LRU layer's mixer params of the reference tree, as numpy."""
    return jax.tree.map(lambda a: a[cycle],
                        tree["cycles"][f"blk_{j}"]["mixer"])


def _rglru_pair():
    jmodel, tree, model, params = hybrid_reference()
    assert model.specs[0].kind == "rglru"
    jspec = jrglru.make_rglru(jmodel.cfg)
    return jspec, _mixer(tree), model.specs[0].mixer, params["layers"][0][
        "mixer"]


def test_rglru_apply():
    jspec, jp, spec, p = _rglru_pair()
    x = np.random.default_rng(5).standard_normal((2, 20, 64)).astype(
        np.float32)
    want = _unoptimized(jax.jit(lambda p, x: jrglru.rglru_apply(
        jspec, p, x, jnp.arange(20))))(jp, jnp.asarray(x))
    got = rglru.rglru_apply(spec, p, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("C", [1, 8, 32])
def test_rglru_prefill(C):
    """Three ragged chunks from a nonzero state (a dead row among them):
    outputs of live columns and both state leaves after each chunk."""
    jspec, jp, spec, p = _rglru_pair()
    rng = np.random.default_rng(6 + C)
    B = 3
    conv = rng.standard_normal((B, 3, 64)).astype(np.float32)
    h = rng.standard_normal((B, 64)).astype(np.float32)
    jcache = {"conv": jnp.asarray(conv), "h": jnp.asarray(h)}
    cache = {"conv": _t(conv), "h": _t(h)}
    step = _unoptimized(jax.jit(lambda c, x, n: jrglru.rglru_prefill(
        jspec, jp, c, x, jnp.zeros((B,), jnp.int32), n)))
    for n in ([C, max(C - 3, 1), 0], [1, C, C // 2], [C, 0, 1]):
        n = np.array(n, np.int32)
        x = rng.standard_normal((B, C, 64)).astype(np.float32)
        want, jcache = step(jcache, jnp.asarray(x), jnp.asarray(n))
        got, cache = rglru.rglru_prefill(spec, p, cache, _t(x), None,
                                         _t(n).long())
        live = np.arange(C)[None, :] < n[:, None]
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   **TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)
    assert cache["h"].dtype == torch.float32


# -- the model ---------------------------------------------------------------


def test_layout_and_weights():
    """Layer i is the reference's cycles.blk_{i % 3}[i // 3], then tail_0
    and tail_1; ``lam`` stays fp32; the ring holds min(max_len, window)
    slots."""
    jmodel, tree, model, params = hybrid_reference()
    kinds = [s.kind for s in model.specs]
    assert kinds == ["rglru", "rglru", "local_attn"] * 2 + ["rglru"] * 2
    assert set(tree) >= {"cycles", "tail_0", "tail_1"}
    for i, lp in enumerate(params["layers"]):
        src = (jax.tree.map(lambda a: a[i // 3], tree["cycles"][f"blk_{i % 3}"])
               if i < 6 else tree[f"tail_{i - 6}"])
        np.testing.assert_array_equal(lp["norm1"]["scale"].numpy(),
                                      np.asarray(src["norm1"]["scale"]))
        if kinds[i] == "rglru":
            assert lp["mixer"]["lam"].dtype == torch.float32
            np.testing.assert_array_equal(lp["mixer"]["gate_x"]["bias"].numpy(),
                                          np.asarray(src["mixer"]["gate_x"]
                                                     ["bias"]))
    cache = model.init_cache(2, 64)
    assert cache.max_len == 64
    assert cache[2]["pos"].shape == (2, WINDOW)
    assert set(cache[0]) == {"conv", "h"} and cache[0]["h"].dtype == \
        torch.float32
    assert model.init_cache(2, 8)[2]["pos"].shape == (2, 8)
    assert model.slot_resident


def test_apply_logits():
    jmodel, tree, model, params = hybrid_reference()
    toks = np.random.default_rng(7).integers(0, 512, (2, 30)).astype(np.int32)
    want = _japply(jmodel)(tree, jnp.asarray(toks))
    got = model.apply(params, torch.from_numpy(toks)).logits
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_leaves(jcache, i):
    """Layer i's cache of the reference tree, as numpy."""
    if i < 6:
        return jax.tree.map(lambda a: np.asarray(a[i // 3]),
                            jcache["cycles"][f"blk_{i % 3}"]["mixer"])
    return jax.tree.map(np.asarray, jcache[f"tail_{i - 6}"]["mixer"])


def test_prefill_chunks_and_every_cache_leaf():
    """A 30-token prompt in ragged chunks (past the window: the ring wraps)
    beside shorter rows, then decode steps: logits and every cache leaf
    after each step."""
    jmodel, tree, model, params = hybrid_reference()
    rng = np.random.default_rng(8)
    jcache, cache = jmodel.init_cache(4, 64), model.init_cache(4, 64)
    step = _jstep(jmodel)
    tree = jmodel.prestack_params(tree)   # as the engine's: one compile
    steps = np.zeros(4, np.int32)
    schedule = [(8, [8, 5, 8, 1]), (8, [8, 8, 0, 2]), (8, [8, 3, 8, 0]),
                (8, [6, 0, 8, 8]), (1, [1, 1, 1, 1]), (1, [1, 0, 1, 1])]
    for C, n in schedule:
        n = np.array(n, np.int32)
        toks = rng.integers(0, 512, (4, C)).astype(np.int32)
        want, jcache = step(tree, jcache, jnp.asarray(toks),
                            jnp.asarray(steps), jnp.asarray(n))
        got, cache = model.prefill_chunk(params, cache,
                                         torch.from_numpy(toks), steps, n)
        live = n > 0
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], **TOL)
        for i, c in enumerate(cache):
            ref = _cache_leaves(jcache, i)
            assert set(c) == set(ref), (i, set(c), set(ref))
            for name, leaf in c.items():
                if name == "pos":
                    np.testing.assert_array_equal(leaf.numpy(), ref[name])
                else:
                    np.testing.assert_allclose(leaf.numpy(), ref[name],
                                               **TOL, err_msg=f"{i}/{name}")
        steps = steps + n
    assert steps[0] == 2 * WINDOW      # row 0 has filled its ring twice


# -- the engine --------------------------------------------------------------


def _margins(jmodel, tree, outs):
    """For each prompt, how many leading outputs the reference's
    full-sequence forward predicts with a top-1/top-2 margin >= MARGIN."""
    seqs = [p + o for p, o in zip(_prompts(), outs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(_japply(jmodel)(tree, jnp.asarray(toks)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(_prompts()):
        low = np.nonzero(margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
                         < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    return safe


def _engines(model, params, jmodel, tree, C, weights_mode):
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=4, chunk_size=C),
        memory=JMemoryConfig(max_len=64),
        quant=jq.QuantConfig(weights=weights_mode)),
        step_fn=_padded(_jstep(jmodel), C))
    want = [list(r.output) for r in jeng.generate_batch(
        _prompts(), JSamplingParams(max_new_tokens=MAX_NEW))]
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=C),
        memory=MemoryConfig(max_len=64),
        quant=quant.QuantConfig(weights=weights_mode)), device="cpu")
    got = eng.generate_batch(_prompts(), SamplingParams(
        max_new_tokens=MAX_NEW))
    assert all(r.done and len(r.output) == MAX_NEW for r in got)
    return [r.output for r in got], want, jeng


@pytest.mark.parametrize("C,weights_mode", [(1, "none"), (8, "none"),
                                            (32, "none"), (8, "int8"),
                                            (8, "int4")])
def test_engine_tokens_equal_jax(C, weights_mode):
    """Prompts of 1-30 tokens (the 30-token one wraps its rings)."""
    jmodel, tree, model, params = hybrid_reference()
    got, want, jeng = _engines(model, params, jmodel, tree, C, weights_mode)
    safe = _margins(jmodel, jeng.params if weights_mode != "none" else tree,
                    want)
    for g, w, n in zip(got, want, safe):
        assert g[:n] == w[:n], (C, weights_mode, g, w, n)


def test_reset_slot_zeroes_state():
    """A finished request's row: pos -1, K/V, conv and h 0 — and a request
    served after it in that row gets the tokens of a fresh engine."""
    _, _, model, params = hybrid_reference()
    cfg = EngineConfig(scheduler=SchedulerConfig(slots=1, chunk_size=8),
                       memory=MemoryConfig(max_len=64))
    eng = Engine(model, params, cfg, device="cpu")
    first, second = _prompts()[3], _prompts()[1]
    eng.generate_batch([first], SamplingParams(max_new_tokens=4))
    for c in eng.cache:
        for name, leaf in c.items():
            assert torch.all(leaf[0] == (-1 if name == "pos" else 0)), name
    again = eng.generate_batch([second], SamplingParams(max_new_tokens=6))
    fresh = Engine(model, params, cfg, device="cpu").generate_batch(
        [second], SamplingParams(max_new_tokens=6))
    assert again[0].output == fresh[0].output


def test_a7_refusals():
    _, _, model, params = hybrid_reference()
    mem = MemoryConfig(max_len=64)
    for config in (EngineConfig(memory=MemoryConfig(max_len=64, paged=True,
                                                    page_size=8)),
                   EngineConfig(memory=mem,
                                speculative=SpeculativeConfig(k=2)),
                   EngineConfig(memory=mem,
                                quant=quant.QuantConfig(cache="int8"))):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            Engine(model, params, config, device="cpu")
    base = ["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "2", "--max-len", "64"]
    for flags in (["--paged"], ["--speculative", "2"],
                  ["--quant-cache", "int8"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            serve.main(base + flags)
    reqs = serve.main(base + ["--quant-weights", "int8"])
    assert all(r.done and len(r.output) == 2 for r in reqs)
