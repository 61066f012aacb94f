"""Serving and training the paper's baseline structures in the port against
the JAX package, in fp32 on the CPU:

- the engine: smollm-135m reduced (one layer) as ``low_rank50``,
  ``monarch50`` and ``pixelfly50`` (weights drawn with numpy in
  ``LM.init``'s layout): greedy tokens equal the JAX engine's at chunk 8,
  up to each request's first output position whose reference margin is
  below 1e-4;
- self-speculative decoding of the engine test's ``low_rank50`` model
  (low-rank linears bearing the draft's ranks; the reference speculation
  test's prompts and budgets): the port's slot-static and paged spec
  engines ticked beside the JAX spec engine (k = 4, frac 0.2: rejected
  drafts), with the same draft plan, tokens, positions, counters and
  draft cache after every tick (paged: the pool's audit too);
- training: gpt2-blast reduced (one layer) under each new kind, the loss
  within 1e-5 and every gradient within 1e-4 × its leaf's largest entry of
  ``jax.value_and_grad`` of the reference's loss;
- both launchers' ``--structure``.

Each JAX program is compiled once without backend optimizations (the
three gradients as one), every engine step at one padded width.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import SchedulerConfig as JSchedulerConfig
from repro.serve import SpeculativeConfig as JSpeculativeConfig
from repro.train.loss import make_loss_fn as jmake_loss_fn

from repro_torch import configs, weights
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               SamplingParams, SchedulerConfig,
                               SpeculativeConfig)
from repro_torch.train import make_loss_fn
from repro_torch.tree import leaves
from test_torch_hybrid import _padded, _seeded_tree, _unoptimized
from test_torch_speculative import (JAX_FRAC, JAX_K, SPEC_STATS,
                                    _leaves_equal, _submit)
from test_torch_structures import reference_logits, variant_reference
from test_torch_train_families import assert_grads_close

KINDS = ("low_rank50", "monarch50", "pixelfly50")
MARGIN = 1e-4
MAX_NEW = 8
C = 8


def _prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, 512, size=n)]
            for n in (3, 17, 9, 30, 1, 12)]


def _margins(v, tree, outs):
    """How many leading outputs of each prompt the reference's
    full-sequence forward predicts with a top-1/top-2 margin ≥ MARGIN."""
    seqs = [p + o for p, o in zip(_prompts(), outs)]
    toks = np.zeros((len(seqs), max(map(len, seqs))), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(reference_logits(v, tree, toks))
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(_prompts()):
        low = np.nonzero(margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
                         < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    return safe


@pytest.mark.parametrize("v", KINDS)
def test_engine_tokens_equal_jax(v):
    jmodel, tree, model, params = variant_reference(v)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=C),
        memory=MemoryConfig(max_len=64)), device="cpu")
    got = [r.output for r in eng.generate_batch(
        _prompts(), SamplingParams(max_new_tokens=MAX_NEW))]
    jeng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=4, chunk_size=C),
        memory=JMemoryConfig(max_len=64)),
        step_fn=_padded(reference_step(v), C))
    want = [list(r.output) for r in jeng.generate_batch(
        _prompts(), JSamplingParams(max_new_tokens=MAX_NEW))]
    assert len({t for out in got for t in out}) > 1
    for g, w, n in zip(got, want, _margins(v, tree, want)):
        assert g[:n] == w[:n], (v, g, w, n)


# -- self-speculative decoding of a low-rank model ---------------------------


@functools.lru_cache(maxsize=None)
def reference_step(v: str):
    """The reference's ``prefill_chunk`` of ``variant_reference(v)``,
    compiled once a width (the engine tests share it)."""
    return _unoptimized(jax.jit(variant_reference(v)[0].prefill_chunk))


def _snapshot(eng) -> dict:
    """What a tick leaves: counters, each slot's request and position, and
    the draft's cache (the reference's layer-stacked leaves, as numpy)."""
    draft = eng.draft_cache
    if isinstance(draft, dict):
        draft = jax.tree.map(np.asarray, draft["cycles"]["blk_0"]["mixer"])
    return {"stats": {k: eng.stats[k] for k in SPEC_STATS},
            "slots": [None if s.req is None else
                      (s.req.uid, list(s.req.output), s.pos)
                      for s in eng.slots],
            "draft": draft}


@functools.lru_cache(maxsize=1)
def jax_spec_run():
    """The JAX speculative engine over the low-rank model (slot-static: its
    round compiles once), ticked to the end: (draft plan, tokens, per tick
    its return value and a ``_snapshot``)."""
    jmodel, tree = variant_reference("low_rank50")[:2]
    eng = JEngine(jmodel, tree, JEngineConfig(
        scheduler=JSchedulerConfig(slots=4, chunk_size=C),
        memory=JMemoryConfig(max_len=64, prefix_sharing=False),
        speculative=JSpeculativeConfig(k=JAX_K, draft_rank_frac=JAX_FRAC)),
        step_fn=_padded(reference_step("low_rank50"), C))
    eng._spec_round = _unoptimized(eng._spec_round)
    _submit(eng, JRequest)
    ticks = []
    while True:
        more = eng.tick()
        ticks.append((more, _snapshot(eng)))
        if not more:
            break
    tokens = {r.uid: list(r.output) for r in eng.finished}
    return dict(eng.draft_plan), tokens, ticks


@pytest.mark.parametrize("paged", [False, True])
def test_low_rank_spec_lockstep_with_reference(paged):
    """The draft truncates the low-rank factors (``rank_kind`` "low_rank"),
    and the padding at load leaves them as they are.  After every tick:
    return value, counters, slots and the draft's cache equal the JAX
    engine's; paged, the pool passes its audit."""
    model, params = variant_reference("low_rank50")[2:]
    plan, tokens, ticks = jax_spec_run()
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=C),
        memory=MemoryConfig(max_len=64, paged=paged, page_size=8,
                            prefix_sharing=False),
        speculative=SpeculativeConfig(k=JAX_K, draft_rank_frac=JAX_FRAC)),
        device="cpu")
    assert eng.draft_plan == weights.plan_from_jax(plan)
    assert set(eng.draft_plan) == {f"layers.{n}" for n in (
        "mixer.qkv", "mixer.out", "ffn.gate", "ffn.up", "ffn.wo")}
    assert model.pad_ranks(eng.draft_params, 16) == eng.draft_params
    _submit(eng, Request)
    for i, (more, snap) in enumerate(ticks):
        assert eng.tick() == more, i
        got = _snapshot(eng)
        assert got["stats"] == snap["stats"], i
        assert got["slots"] == snap["slots"], i
        _leaves_equal(got["draft"], snap["draft"], f"draft cache, tick {i}")
        if paged:
            eng._pc.audit()
    assert {r.uid: r.output for r in eng.finished} == tokens
    assert eng.stats["spec_rounds"] > 0
    assert eng.stats["spec_accepted"] < eng.stats["spec_drafted"]


# -- training -----------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def gpt2_references():
    """{kind: (JAX model, numpy tree, port model)} of gpt2-blast reduced to
    one layer under each new kind, and the reference's loss and gradients
    of all three from one program (``jax.value_and_grad``)."""
    toks = np.random.default_rng(5).integers(0, 512, (2, 33)).astype(np.int32)
    refs = {}
    for v in KINDS:
        jmodel = jbuild_model(jconfigs.get("gpt2-blast", v).reduced(
            n_layers=1))
        refs[v] = (jmodel, _seeded_tree(jmodel, np.random.default_rng(17)),
                   build_model(configs.get("gpt2-blast", v).reduced(
                       n_layers=1), device="cpu"))
    fns = [jax.value_and_grad(jmake_loss_fn(refs[v][0]), has_aux=True)
           for v in KINDS]
    out = _unoptimized(jax.jit(lambda trees, batch: [
        f(t, batch) for f, t in zip(fns, trees)]))(
        [refs[v][1] for v in KINDS], {"tokens": jnp.asarray(toks)})
    return toks, refs, dict(zip(KINDS, out))


@pytest.mark.parametrize("v", KINDS)
def test_gpt2_loss_and_grads_match_jax(v):
    toks, refs, jout = gpt2_references()
    _, tree, model = refs[v]
    params = weights.from_jax_params(model, tree)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = make_loss_fn(model)(params,
                                  {"tokens": torch.from_numpy(toks).long()})
    grads = torch.autograd.grad(loss, flat)
    (jloss, _), jgrads = jout[v]
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert_grads_close(model, grads, jgrads)


def test_launchers_take_a_structure(capsys):
    reqs = serve_launcher.main(["--arch", "smollm-135m", "--reduced",
                                "--device", "cpu", "--structure",
                                "pixelfly50", "--requests", "2",
                                "--max-new", "3"])
    assert all(r.done and len(r.output) == 3 for r in reqs)
    result = train_launcher.main(["--arch", "gpt2-blast", "--reduced",
                                  "--device", "cpu", "--structure",
                                  "monarch50", "--steps", "2", "--seq", "16",
                                  "--batch", "2"])
    assert len(result["history"]) == 2
    assert "(monarch)" in capsys.readouterr().out
