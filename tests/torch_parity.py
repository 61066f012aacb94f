"""Shared reference state and checks of the port's parity tests: the JAX
``smollm-135m.reduced()`` model and its ``LM.init(PRNGKey(0))`` weights,
built once per process, the quantized-model checks that the int8 and int4
test files both run, and the ragged-prefill and engine-token checks of the
dense-decoder and int8-cache files (tolerances are stated in those
files)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro import quant as jq
from repro.core import structures as jstructures
from repro.core.structures import StructureConfig as JStructureConfig
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs, quant, weights
from repro_torch.configs import StructureConfig
from repro_torch.core import structures
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)

TOL = dict(atol=1e-4, rtol=1e-4)
A8_ROW_ATOL = 2e-2
MARGIN = 1e-4
MAX_NEW = 8


@functools.lru_cache(maxsize=1)
def reference_lm():
    """(JAX model, JAX params).  The init program is compiled without XLA's
    backend optimizations: on one core that takes ~3 s instead of ~30 s.
    The draws may differ from an optimized build in the last bits, which
    does not matter here — every test feeds the same tree to both
    packages."""
    jmodel = jbuild_model(jconfigs.get("smollm-135m").reduced())
    key = jax.random.PRNGKey(0)
    init = jax.jit(jmodel.init).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return jmodel, init(key)


# llama7b-blast's Table-9 ranks differ by role (1024 attention, 1488 FFN);
# reduced() drops explicit ranks, so its test config sets its own, also
# different by role
ROLE_RANKS = {"llama7b-blast": (16, 24)}


def dense_pair(name: str):
    """(JAX config, port config) of ``name`` reduced the same way."""
    over = {}
    jover = {}
    if name in ROLE_RANKS:
        ra, rf = ROLE_RANKS[name]
        over = dict(structure=StructureConfig(kind="blast", b=4, rank=ra),
                    structure_ffn=StructureConfig(kind="blast", b=4, rank=rf))
        jover = dict(structure=JStructureConfig(kind="blast", b=4, rank=ra),
                     structure_ffn=JStructureConfig(kind="blast", b=4,
                                                    rank=rf))
    return jconfigs.get(name).reduced(**jover), configs.get(name).reduced(**over)


def _moved(tree, rng):
    """``tree`` with every norm scale and bias and the QKV bias moved by
    N(0, 0.1) noise."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, (*path, k)) for k, v in node.items()}
        if path[-1] in ("scale", "bias") and (
                "norm" in "/".join(path) or "qkv" in path):
            return (node + 0.1 * rng.standard_normal(node.shape)).astype(
                node.dtype)
        return node
    return walk(tree, ())


@functools.lru_cache(maxsize=None)
def dense_reference(name: str):
    """(JAX model, numpy params, port model, port params) of ``name``
    reduced, sharing the reference's ``LM.init(PRNGKey(0))`` weights with
    their norm scales and biases and QKV bias moved by seeded noise (which
    ``init`` leaves at 1 or 0, where they would not change the logits).
    The init program is compiled as in ``reference_lm``."""
    jcfg, cfg = dense_pair(name)
    jmodel = jbuild_model(jcfg)
    key = jax.random.PRNGKey(0)
    init = jax.jit(jmodel.init).lower(key).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    tree = _moved(jax.tree.map(np.asarray, init(key)),
                  np.random.default_rng(len(name)))
    model = build_model(cfg, device="cpu")
    return jmodel, tree, model, weights.from_jax_params(model, tree)


def reference_pair():
    """(jax model, jax float params, port model, port float params) sharing
    the reference's weights."""
    jmodel, jparams = reference_lm()
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    return (jmodel, jparams, model,
            weights.from_jax_params(model, jax.tree.map(np.asarray, jparams)))


def leaves_equal(got, want, path="params") -> int:
    """Assert every QArray of ``want`` (JAX) has equal bits, logical shape,
    codes (int4: packed bytes) and scales in ``got`` (port); returns how
    many were compared."""
    if isinstance(want, jq.QArray):
        assert (got.bits, got.shape) == (want.bits, tuple(want.shape)), path
        np.testing.assert_array_equal(got.q.cpu().numpy(), np.asarray(want.q),
                                      err_msg=path)
        np.testing.assert_array_equal(got.scale.cpu().numpy(),
                                      np.asarray(want.scale), err_msg=path)
        return 1
    return sum(leaves_equal(got[k], want[k], f"{path}/{k}") for k in want)


def quantized_params_equal(qp, jtree) -> int:
    """``leaves_equal`` over the embedding and every layer's linears of a
    port tree and the reference's scan-stacked tree."""
    blk = jtree["cycles"]["blk_0"]
    n = leaves_equal(qp["embed"], jtree["embed"], "embed")
    for i, lp in enumerate(qp["layers"]):
        layer = jax.tree.map(lambda a: a[i], blk)
        n += leaves_equal({g: lp[g] for g in ("mixer", "ffn")},
                          {g: layer[g] for g in ("mixer", "ffn")})
    return n


def _chunks():
    rng = np.random.default_rng(3)
    for n in ([8, 3, 0, 5], [2, 8, 4, 0], [1, 1, 8, 1]):
        yield (rng.integers(0, 512, size=(4, 8)).astype(np.int32),
               np.array(n, np.int32))


def _run_prefills(run, params, cache):
    steps = np.zeros(4, np.int32)
    outs = []
    for toks, n in _chunks():
        logits, cache = run(params, cache, toks, steps, n)
        outs.append((np.asarray(logits, np.float32), n > 0))
        steps = steps + n
    return outs


def prefill_logits(jmodel, jtree, model, params):
    """Three ragged ``prefill_chunk`` steps of the reference (jitted) and
    the port from fresh caches of 4 rows × 32 slots → (port outputs,
    reference outputs, (port cache, reference cache)); an output is
    (logits (4, 1, V) as numpy, live rows)."""
    jcache, cache = jmodel.init_cache(4, 32), model.init_cache(4, 32)
    caches = {}

    def keep(run, key):
        def step(p, c, t, s, n):
            logits, caches[key] = run(p, c, t, s, n)
            return logits, caches[key]
        return step

    want = _run_prefills(keep(jax.jit(jmodel.prefill_chunk), "jax"), jtree,
                         jcache)
    got = _run_prefills(keep(lambda p, c, t, s, n: model.prefill_chunk(
        p, c, torch.from_numpy(t), s, n), "port"), params, cache)
    return got, want, (caches["port"], caches["jax"])


def _margin_safe(jmodel, jparams, outs):
    """For each prompt, how many leading output tokens the reference's
    full-sequence forward predicts with a top-1/top-2 margin ≥ ``MARGIN``
    (past that, a summation-order difference could flip the argmax)."""
    seqs = [p + o for p, o in zip(_prompts(), outs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(jax.jit(lambda p, t: jmodel.apply(p, t).logits)(
        jparams, jnp.asarray(toks)))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(_prompts()):
        low = np.nonzero(margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
                         < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    return safe


def check_engine_tokens(jmodel, jparams, model, params, chunks=(1, 8, 32)):
    """Greedy tokens of the port's engine equal the JAX engine's at each
    chunk size (4 slots, max_len 64), up to each request's first output
    position whose reference margin is below ``MARGIN``; both models carry
    their own cache mode.  Returns the port's outputs at the last chunk."""
    step = jax.jit(jmodel.prefill_chunk)   # shared: compiles once per width
    safe = None
    for C in chunks:
        jeng = JEngine(jmodel, jparams, JEngineConfig(
            scheduler=JSchedulerConfig(slots=4, chunk_size=C),
            memory=JMemoryConfig(max_len=64)), step_fn=step)
        want = [list(r.output) for r in jeng.generate_batch(
            _prompts(), JSamplingParams(max_new_tokens=MAX_NEW))]
        if safe is None:
            safe = _margin_safe(jmodel, jparams, want)
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=4, chunk_size=C),
            memory=MemoryConfig(max_len=64)), device="cpu")
        reqs = eng.generate_batch(_prompts(),
                                  SamplingParams(max_new_tokens=MAX_NEW))
        assert all(r.done and len(r.output) == MAX_NEW for r in reqs)
        for r, w, n in zip(reqs, want, safe):
            assert r.output[:n] == w[:n], (C, r.output, w, n)
    return [r.output for r in reqs]


def check_prefill_logits(jmodel, jtree, model, qp, act):
    """Three ragged ``prefill_chunk`` steps of the quantized reference tree
    and the port's quantized params.  Weight-only (``act="none"``): every
    live logit within ``TOL``.  int8 activations: every live row within
    ``A8_ROW_ATOL`` and at least 3/4 of them within ``TOL``."""
    # a fresh function object: its trace is not shared with the other mode
    jstep = jax.jit(lambda *a: jmodel.prefill_chunk(*a))
    with jstructures.activations(act):
        want = _run_prefills(jstep, jtree, jmodel.init_cache(4, 32))
    with structures.activations(act):
        got = _run_prefills(
            lambda p, c, t, s, n: model.prefill_chunk(
                p, c, torch.from_numpy(t), s, n),
            qp, model.init_cache(4, 32))
    assert structures.activations_mode() == "none"
    row_err = []
    for (g, live), (w, _) in zip(got, want):
        assert g.shape == w.shape == (4, 1, 512)
        if act == "none":
            np.testing.assert_allclose(g[live], w[live], **TOL)
        row_err += list(np.abs(g[live] - w[live]).max(axis=(1, 2)))
    row_err = np.array(row_err)
    assert row_err.max() <= A8_ROW_ATOL, row_err
    assert (row_err <= TOL["atol"]).mean() >= 0.75, row_err


def _prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, 512, size=n)]
            for n in (3, 17, 9, 30, 1, 12)]


def check_greedy_tokens(jmodel, jparams, model, params, weights_mode, act):
    """Greedy tokens of the port's engine equal the JAX engine's in one
    quantized mode, up to the first step where the quantized reference's
    top-1/top-2 margin is below ``MARGIN``.  Returns the port engine."""
    try:
        jeng = JEngine(jmodel, jparams, JEngineConfig(
            scheduler=JSchedulerConfig(slots=4, chunk_size=8),
            memory=JMemoryConfig(max_len=64),
            quant=jq.QuantConfig(weights=weights_mode, activations=act)),
            step_fn=jax.jit(lambda *a: jmodel.prefill_chunk(*a)))
        want = [list(r.output) for r in jeng.generate_batch(
            _prompts(), JSamplingParams(max_new_tokens=MAX_NEW))]
        # margins of the quantized reference's own predictions
        seqs = [p + o for p, o in zip(_prompts(), want)]
        toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
        for i, s in enumerate(seqs):
            toks[i, :len(s)] = s
        logits = np.asarray(jax.jit(lambda p, t: jmodel.apply(p, t).logits)(
            jeng.params, jnp.asarray(toks)))
    finally:
        jstructures.set_activations("none")
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(_prompts()):
        low = np.nonzero(margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
                         < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=8),
        memory=MemoryConfig(max_len=64),
        quant=quant.QuantConfig(weights=weights_mode, activations=act)),
        device="cpu")
    assert eng.act_mode == act and quant.tree_is_quantized(eng.params)
    reqs = eng.generate_batch(_prompts(), SamplingParams(max_new_tokens=MAX_NEW))
    assert all(r.done and len(r.output) == MAX_NEW for r in reqs)
    for r, w, n in zip(reqs, want, safe):
        assert r.output[:n] == w[:n]
    return eng
