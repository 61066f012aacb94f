"""The port's engine against the JAX engine: same weights (the reference's
``LM.init(PRNGKey(0))`` carried across), same prompts, greedy decoding —
the emitted tokens must be identical at chunk sizes 1, 8 and 32 on
``smollm-135m.reduced()`` (fp32, CPU).

Where the reference's top-1/top-2 logit margin at some output position is
below 1e-4, a 1e-5-level difference in summation order could legitimately
flip the argmax; the comparison then stops before that position (the
margins come from the reference's full-sequence forward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import SamplingParams as JSamplingParams
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs, weights
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from torch_parity import reference_lm

CHUNKS = (1, 8, 32)
MAX_NEW = 8
MARGIN = 1e-4


def _prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, 512, size=n)]
            for n in (3, 17, 9, 30, 1, 12)]


@pytest.fixture(scope="module")
def reference():
    """JAX weights, and the JAX engine's greedy outputs per chunk size with
    the number of leading tokens whose margin is safe to compare."""
    jmodel, jparams = reference_lm()
    step = jax.jit(jmodel.prefill_chunk)   # shared: compiles once per width
    outs = {}
    for C in CHUNKS:
        eng = JEngine(jmodel, jparams, JEngineConfig(
            scheduler=JSchedulerConfig(slots=4, chunk_size=C),
            memory=JMemoryConfig(max_len=64)), step_fn=step)
        reqs = eng.generate_batch(_prompts(),
                                  JSamplingParams(max_new_tokens=MAX_NEW))
        outs[C] = [list(r.output) for r in reqs]
    # margins of the reference's own predictions (full-sequence forward;
    # positions after a sequence's end are right-padding, causally inert)
    seqs = [p + o for p, o in zip(_prompts(), outs[1])]
    width = max(map(len, seqs))
    toks = np.zeros((len(seqs), width), np.int32)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = s
    logits = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(toks)).logits)
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    safe = []
    for i, p in enumerate(_prompts()):
        m = margin[i, len(p) - 1: len(p) - 1 + MAX_NEW]
        low = np.nonzero(m < MARGIN)[0]
        safe.append(int(low[0]) if low.size else MAX_NEW)
    return jax.tree.map(np.asarray, jparams), outs, safe


@pytest.mark.parametrize("chunk", CHUNKS)
def test_greedy_tokens_match_jax_engine(reference, chunk):
    tree, outs, safe = reference
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    params = weights.from_jax_params(model, tree)
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=chunk),
        memory=MemoryConfig(max_len=64)), device="cpu")
    reqs = eng.generate_batch(_prompts(), SamplingParams(max_new_tokens=MAX_NEW))
    assert all(r.done and r.stop_reason == "length" for r in reqs)
    assert sum(safe) >= len(safe) * MAX_NEW // 2, safe   # the check has teeth
    for r, want, n in zip(reqs, outs[chunk], safe):
        assert len(r.output) == MAX_NEW
        assert r.output[:n] == want[:n]
    # the reference's own contract: identical tokens across chunk sizes
    assert outs[chunk] == outs[1]
