"""The compiled step on the card: the engine's and the trainer's CUDA graphs
against the same step run eagerly, on ``smollm-135m.reduced()``.

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py

A replay launches the kernels the eager step launches, in the same order,
on the same inputs, so the two are held to equality bit for bit.  The test
that forces a capture to fail runs last.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs, quant
from repro_torch.data import TokenStream
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig)
from repro_torch.train import Trainer
from repro_torch.tree import leaves

MODES = {"none": ("none", "none"), "int8": ("int8", "none"),
         "w8a8": ("int8", "int8"), "int4": ("int4", "none"),
         "w4a8": ("int4", "int8")}
DTYPES = ("float32", "bfloat16")
# prompt lengths: C buckets 1, 4 and 8 and kv buckets 64, 128 and 192 (the
# cap); five requests on three slots, so slots are reset and recycled
PROMPTS = (5, 70, 130, 3, 20)


def _cfg(dtype, **kw):
    return configs.get("smollm-135m").reduced(param_dtype=dtype,
                                              compute_dtype=dtype, **kw)


def _engine(model, params, mode, **kw):
    weights, act = MODES[mode]
    return Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=3, chunk_size=8),
        memory=MemoryConfig(max_len=192),
        quant=quant.QuantConfig(weights=weights, activations=act)), **kw)


def _serve(engine):
    """Greedy outputs, each step's (C, kv_len) and logits, and the launch
    counts of the run."""
    seen = []
    run_step = engine._run_step

    def record(key):
        logits = run_step(key)
        seen.append((key, logits.clone()))
        return logits

    engine._run_step = record
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, engine.model.cfg.vocab,
                                             size=n)] for n in PROMPTS]
    ops.reset_launches()
    reqs = engine.generate_batch(prompts, SamplingParams(max_new_tokens=8))
    torch.cuda.synchronize()
    return [r.output for r in reqs], seen, dict(ops.launches)


def _train(jit, steps=3):
    """Per step: loss, grad norm, skipped flag and every parameter."""
    cfg = _cfg("bfloat16", remat=True, vocab=64)
    model = build_model(cfg, device="cuda")
    data = TokenStream(vocab=cfg.vocab, seq_len=32, global_batch=4)
    trainer = Trainer(model, adamw(cosine_schedule(1e-3, 10, 2)), data,
                      jit=jit, log_every=10 ** 9)
    rows = []
    inner = trainer.train_step

    def record(params, opt_state, batch):
        params, opt_state, m = inner(params, opt_state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["skipped"]),
                     [p.detach().clone() for p in leaves(params)]))
        return params, opt_state, m

    trainer.train_step = record
    out = trainer.run(steps)
    return trainer, out, rows


def _replay_equals_eager(model, mode):
    """Serve through the graphs and eagerly: the same tokens and buckets,
    logits equal bit for bit, equal launch counts (5 a layer a step).
    Returns (launch counts, steps)."""
    params = model.init(0)
    graphs = _engine(model, params, mode)
    eager = _engine(model, params, mode, step_fn=model.prefill_chunk)
    out_g, seen_g, launches_g = _serve(graphs)
    out_e, seen_e, launches_e = _serve(eager)
    assert out_g == out_e
    assert [k for k, _ in seen_g] == [k for k, _ in seen_e]
    keys = {k for k, _ in seen_g}
    assert {c for c, _ in keys} == {1, 4, 8}
    assert {kv for _, kv in keys} == {64, 128, 192}
    assert graphs.stats["graphs"] == len(keys)
    assert eager.stats["graphs"] == 0
    for (key, g), (_, e) in zip(seen_g, seen_e):
        assert torch.equal(g, e), key
    # every replay counts the launches its capture recorded
    assert launches_g == launches_e
    L, steps = model.cfg.n_layers, graphs.stats["steps"]
    assert sum(launches_g.values()) == 5 * L * steps
    return launches_g, steps


@pytest.mark.gpu
class TestGraphs:

    @pytest.fixture
    def cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        return torch.device("cuda")

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("mode", list(MODES))
    def test_replay_equals_eager_step(self, cuda, mode, dtype):
        _replay_equals_eager(build_model(_cfg(dtype), device=cuda), mode)

    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("mode", ["none", "int8"])
    def test_int8_cache_replay_equals_eager_step(self, cuda, mode, dtype):
        """The int8 KV cache's write (``quantize_rows`` and two scatters a
        leaf, on the card) is captured with the step: replay == eager bit
        for bit, attention in the int8-K/V kernel."""
        model = build_model(_cfg(dtype, quant=quant.QuantConfig(
            cache="int8")), device=cuda)
        launches, steps = _replay_equals_eager(model, mode)
        assert launches["flash_attention_prefill_q8"] == (
            model.cfg.n_layers * steps)
        assert launches["flash_attention_prefill"] == 0

    def test_captured_training_equals_eager(self, cuda):
        tg, out_g, rows_g = _train(jit=True)
        te, out_e, rows_e = _train(jit=False)
        assert tg.stats["graphs"] == 1 and te.stats["graphs"] == 0
        for i, (g, e) in enumerate(zip(rows_g, rows_e)):
            assert g[:3] == e[:3], i
            assert all(torch.equal(a, b) for a, b in zip(g[3], e[3])), i
        for name in ("m", "v", "count"):
            assert all(torch.equal(a, b) for a, b in zip(
                leaves(out_g["opt_state"][name]),
                leaves(out_e["opt_state"][name]))), name

    def test_nonfinite_batch_skipped_under_capture(self, cuda):
        trainer, out, _ = _train(jit=True)
        params, state = out["params"], out["opt_state"]
        batch = trainer.data.batch(3)
        embed = params["embed"]
        held = embed.detach()[batch["tokens"][0, 0]].clone()
        with torch.no_grad():
            embed[batch["tokens"][0, 0]] = float("nan")
        before = [t.detach().clone() for t in leaves((params, state["m"],
                                                      state["v"]))]
        count = int(state["count"])
        _, _, m = trainer.train_step(params, state, batch)
        assert float(m["skipped"]) == 1.0
        assert int(state["count"]) == count + 1
        for a, b in zip(leaves((params, state["m"], state["v"])), before):
            torch.testing.assert_close(a.detach(), b, equal_nan=True,
                                       atol=0, rtol=0)
        with torch.no_grad():
            embed[batch["tokens"][0, 0]] = held
        _, _, m = trainer.train_step(params, state, trainer.data.batch(4))
        assert float(m["skipped"]) == 0.0

    def test_capture_failure_raises(self, cuda):
        model = build_model(_cfg("bfloat16"), device=cuda)
        step = model.prefill_chunk

        def syncing(*args, **kw):
            logits, cache = step(*args, **kw)
            float(logits.sum())                  # a host sync
            return logits, cache

        model.prefill_chunk = syncing           # the step the engine captures
        engine = _engine(model, model.init(0), "none")
        with pytest.raises(RuntimeError, match=r"bucket C=\d+, kv_len=\d+"):
            engine.generate_batch([[1, 2, 3]],
                                  SamplingParams(max_new_tokens=2))
