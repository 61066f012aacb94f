"""Temperature sampling of the port's engine (``serve.engine.sample_tokens``
and the engine around it) on ``smollm-135m.reduced()``, fp32 on the CPU.

The reference samples with ``jax.random.categorical`` from its own key; its
stream cannot be reproduced bit for bit, so these tests hold the port to
the distribution instead: a chi-square test of 20,000 draws against
``softmax(logits / T)`` (p > 1e-3), the greedy argmax as T → 0 (where the
greedy top-1/top-2 margin is ≥ 1e-4, a 1e-7 temperature's noise cannot
flip it), and the seed as the stream's only input."""

import numpy as np
import pytest
import torch
from scipy import stats

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from repro_torch.serve.engine import sample_tokens

MAX_NEW = 8


@pytest.fixture(scope="module")
def model_params():
    model = build_model(configs.get("smollm-135m").reduced(), device="cpu")
    return model, model.init(0)


def _prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(0, 512, size=n)]
            for n in (3, 17, 9, 30, 1, 12)]


def _serve(model, params, temperature, seed=0, chunk=8):
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=4, chunk_size=chunk),
        memory=MemoryConfig(max_len=64), seed=seed), device="cpu")
    reqs = eng.generate_batch(_prompts(), SamplingParams(
        max_new_tokens=MAX_NEW, temperature=temperature))
    assert all(r.done and len(r.output) == MAX_NEW for r in reqs)
    return [r.output for r in reqs]


@pytest.mark.parametrize("T", [0.5, 1.0, 2.0])
def test_draws_follow_softmax(T):
    """20,000 draws from one row of fixed logits (12 classes, one far
    below the rest) against ``softmax(logits / T)``."""
    logits = torch.tensor([2.0, 1.5, 1.0, 0.5, 0.0, -0.5, -1.0, -1.5, 0.25,
                           0.75, 1.25, -8.0])
    n = 20_000
    gen = torch.Generator().manual_seed(11)
    draws = sample_tokens(logits.expand(n, -1), torch.full((n,), T), gen)
    counts = np.bincount(draws.numpy(), minlength=logits.numel())
    p = torch.softmax(logits.double() / T, dim=-1).numpy()
    # cells expecting fewer than 5 draws are pooled into one
    big = p * n >= 5
    obs, exp = counts[big], p[big]
    if not big.all():
        obs, exp = np.append(obs, counts[~big].sum()), np.append(
            exp, p[~big].sum())
    exp = exp / exp.sum() * n
    assert stats.chisquare(obs, exp).pvalue > 1e-3


def test_rows_sample_or_take_the_argmax():
    """In one batch, a row with T = 0 takes the greedy argmax whatever the
    noise; rows with T > 0 draw (on flat logits, both of two tokens)."""
    logits = torch.tensor([[0.0, 0.0], [0.1, 0.0]]).repeat(64, 1)
    temps = torch.tensor([1.0, 0.0]).repeat(64)
    out = sample_tokens(logits, temps, torch.Generator().manual_seed(0))
    assert torch.all(out[1::2] == 0)
    assert set(out[0::2].tolist()) == {0, 1}


def test_zero_temperature_limit_is_greedy(model_params):
    """At T = 1e-7 the engine emits the greedy engine's tokens: the noise is
    ~1e-6 against margins ≥ 1e-4 (checked on the model's own logits)."""
    model, params = model_params
    greedy = _serve(model, params, 0.0)
    seqs = [p + o for p, o in zip(_prompts(), greedy)]
    width = max(map(len, seqs))
    toks = torch.zeros((len(seqs), width), dtype=torch.int64)
    for i, s in enumerate(seqs):
        toks[i, :len(s)] = torch.tensor(s)
    with torch.no_grad():
        top2 = model.apply(params, toks).logits.topk(2, dim=-1).values
    for i, p in enumerate(_prompts()):
        gap = top2[i, len(p) - 1: len(p) - 1 + MAX_NEW]
        assert bool(((gap[:, 0] - gap[:, 1]) >= 1e-4).all()), i
    assert _serve(model, params, 1e-7) == greedy


def test_seed_sets_the_stream(model_params):
    """The same seed gives the same tokens, also at another chunk width;
    another seed does not; T = 1 does not give the greedy tokens."""
    model, params = model_params
    a = _serve(model, params, 1.0, seed=0)
    assert _serve(model, params, 1.0, seed=0) == a
    assert _serve(model, params, 1.0, seed=1) != a
    assert _serve(model, params, 0.0) != a
