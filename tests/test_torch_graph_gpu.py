"""The compiled step on the card: the engine's and the trainer's CUDA graphs
against the same step run eagerly, on ``smollm-135m.reduced()`` (and the
hybrid recurrentgemma-2b at full width, 3 layers; the trainer's also on
``granite-moe-1b-a400m.reduced()``).

Marked ``gpu``: each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_graph_gpu.py

A replay launches the kernels the eager step launches, in the same order,
on the same inputs, so the two are held to equality bit for bit.  The test
that forces a capture to fail runs last.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch import configs, quant
from repro_torch.data import TokenStream
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig,
                               SamplingParams, SchedulerConfig,
                               SpeculativeConfig)
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


def _train(jit, steps=3, cfg=None):
    """Per step: loss, grad norm, skipped flag and every parameter."""
    cfg = cfg or _cfg("bfloat16", remat=True, vocab=64)
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


def _replay_equals_eager(model, mode, per_layer=5):
    """Serve through the graphs and eagerly: the same tokens and buckets,
    logits equal bit for bit, equal launch counts (``per_layer`` a layer a
    step: a BLAST layer's 5, B3 alone for another structure).  Returns
    (launch counts, steps)."""
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
    assert sum(launches_g.values()) == per_layer * L * steps
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

    @pytest.mark.parametrize("mode", ["none", "int8"])
    @pytest.mark.parametrize("variant", ["low_rank50", "monarch50",
                                         "pixelfly50", "block_diag"])
    def test_variant_replay_equals_eager(self, cuda, variant, mode):
        """The paper's baseline structures (``configs.variant``), bf16:
        their linears are plain products, deterministic on the card
        (Pixelfly's gather and scatter-add are one-hot products), so a
        replay equals the eager step bit for bit; B3 is the only launch."""
        model = build_model(dataclasses.replace(
            _cfg("bfloat16"), structure=configs.variant(
                configs.get("smollm-135m"), variant).structure), device=cuda)
        launches, steps = _replay_equals_eager(model, mode, per_layer=1)
        assert launches["flash_attention_prefill"] == (
            model.cfg.n_layers * steps)

    @pytest.mark.parametrize("variant", ["low_rank50", "monarch50",
                                         "pixelfly50"])
    def test_variant_captured_training_equals_eager(self, cuda, variant):
        """A new kind's training step (its backward through autograd's
        products) captured equals the eager one bit for bit after each of
        3 steps."""
        cfg = dataclasses.replace(
            _cfg("bfloat16", remat=True, vocab=64),
            structure=configs.variant(configs.get("smollm-135m"),
                                      variant).structure)
        tg, _, rows_g = _train(jit=True, cfg=cfg)
        te, _, rows_e = _train(jit=False, cfg=cfg)
        assert tg.stats["graphs"] == 1 and te.stats["graphs"] == 0
        for i, (g, e) in enumerate(zip(rows_g, rows_e)):
            assert g[:3] == e[:3], i
            assert all(torch.equal(a, b) for a, b in zip(g[3], e[3])), i

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

    def test_moe_captured_training_equals_eager(self, cuda):
        """granite-moe-1b-a400m reduced (4 experts top-2, capacity 1.25:
        some assignments drop), bf16, remat: the captured step — routing,
        the dispatch's argsort and searchsorted, the sink column, the
        batched expert launches and their dx, the gather's and the
        combine's backward through autograd's indexing — equals the eager
        step bit for bit after each of 3 steps; per step two batched launches a layer forward, two again
        in remat's recompute, and two batched dx launches."""
        cfg = configs.get("granite-moe-1b-a400m").reduced(
            param_dtype="bfloat16", compute_dtype="bfloat16", remat=True,
            vocab=64)
        ops.reset_launches()
        tg, out_g, rows_g = _train(jit=True, cfg=cfg)
        launched = dict(ops.launches)
        te, out_e, rows_e = _train(jit=False, cfg=cfg)
        assert tg.stats["graphs"] == 1 and te.stats["graphs"] == 0
        L = cfg.n_layers
        assert launched["blast_matmul_batched"] == 3 * 4 * L
        assert launched["blast_matmul_batched_dx"] == 3 * 2 * L
        for i, (g, e) in enumerate(zip(rows_g, rows_e)):
            assert g[:3] == e[:3], i
            assert all(torch.equal(a, b) for a, b in zip(g[3], e[3])), i

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

    @pytest.mark.parametrize("cache", ["none", "int8"])
    def test_paged_replay_equals_eager_step(self, cuda, cache):
        """The paged step (fresh-page reset, gather, step, scatter) captured
        per (C, kv, F, M) bucket against the same step run eagerly: the
        same tokens and buckets, logits and every pool page (the sink
        aside) equal bit for bit, at two or more (F, M) buckets; the tokens
        also equal the slot-static engine's."""
        model = build_model(_cfg("bfloat16", quant=quant.QuantConfig(
            cache=cache)), device=cuda)
        params = model.init(0)

        def paged(**kw):
            return Engine(model, params, EngineConfig(
                scheduler=SchedulerConfig(slots=3, chunk_size=8),
                memory=MemoryConfig(max_len=192, paged=True, page_size=8)),
                **kw)
        graphs, eager = paged(), paged(step_fn=model.prefill_chunk)
        out_g, seen_g, launches_g = _serve(graphs)
        out_e, seen_e, launches_e = _serve(eager)
        out_s, _, _ = _serve(_engine(model, params, "none"))
        assert out_g == out_e == out_s
        keys = [k for k, _ in seen_g]
        assert keys == [k for k, _ in seen_e]
        assert len({k[2:] for k in keys}) >= 2
        assert graphs.stats["graphs"] == len(set(keys))
        for (key, g), (_, e) in zip(seen_g, seen_e):
            assert torch.equal(g, e), key
        assert launches_g == launches_e
        n = graphs._pc.n_pages
        for name, pool in graphs._pc.pool.items():
            assert torch.equal(pool[:n], eager._pc.pool[name][:n]), name
        graphs._pc.audit()
        eager._pc.audit()

    @pytest.mark.parametrize("paged", [False, True])
    @pytest.mark.parametrize("mode", ["none", "int8"])
    def test_spec_round_replay_equals_eager(self, cuda, mode, paged):
        """Self-speculative decoding (k = 4, frac 0.5): the round captured
        as one CUDA graph per kv bucket (paged: per (kv, F, M)) against the
        same round run eagerly: the same tokens and buckets, every round's
        token ids and every plain step's logits equal bit for bit; launches
        are rounds × (k + 2) and plain steps × 2 (the draft's replay) times
        a step's 5 a layer; in fp32 the tokens equal plain decoding's."""
        model = build_model(_cfg("float32"), device=cuda)
        params = model.init(0)
        weights, act = MODES[mode]

        def engine(k, **kw):
            return Engine(model, params, EngineConfig(
                scheduler=SchedulerConfig(slots=3, chunk_size=8),
                memory=MemoryConfig(max_len=192, paged=paged, page_size=8),
                speculative=SpeculativeConfig(k=k, draft_rank_frac=0.5),
                quant=quant.QuantConfig(weights=weights, activations=act)),
                **kw)
        graphs = engine(4)
        eager = engine(4, step_fn=model.prefill_chunk)
        out_g, seen_g, launches_g = _serve(graphs)
        out_e, seen_e, launches_e = _serve(eager)
        assert out_g == out_e
        keys = [k for k, _ in seen_g]
        assert keys == [k for k, _ in seen_e]
        assert any(k[0] == "spec" for k in keys)
        assert graphs.stats["graphs"] == len(set(keys))
        for (key, g), (_, e) in zip(seen_g, seen_e):
            assert torch.equal(g, e), key
        assert launches_g == launches_e
        rounds = graphs.stats["spec_rounds"]
        plain = graphs.stats["steps"] - rounds
        assert rounds > 0
        assert sum(launches_g.values()) == 5 * model.cfg.n_layers * (
            rounds * (4 + 2) + plain * 2)
        out_p, _, _ = _serve(engine(0))
        assert out_g == out_p
        if paged:
            graphs._pc.audit()

    @pytest.mark.parametrize("mode", ["none", "int8", "int8_cache"])
    def test_hybrid_replay_equals_eager(self, cuda, mode):
        """recurrentgemma-2b at full width (3 layers: rglru, rglru,
        local_attn; window cut to 64 so the prompts wrap the ring), bf16,
        float or int8 weights, or float weights over the int8 cache (an
        int8 ring, int8 RG-LRU state: a capture's all-dead warm-up packs
        the state again, and the engine undoes that): the captured step
        equals the eager one bit for bit — tokens, every step's logits,
        launches (per step 1 B2 and 3 B1 an RG-LRU layer, 4 B1 and 1 ring
        B3 an attention layer)."""
        cache = "int8" if mode == "int8_cache" else "none"
        mode = "none" if mode == "int8_cache" else mode
        cfg = configs.get("recurrentgemma-2b")
        cfg = dataclasses.replace(cfg, n_layers=3, window=64,
                                  quant=quant.QuantConfig(cache=cache))
        model = build_model(cfg, device="cuda")
        params = model.init(0)
        graphs = _engine(model, params, mode)
        eager = _engine(model, params, mode, step_fn=model.prefill_chunk)
        out_g, seen_g, launches_g = _serve(graphs)
        out_e, seen_e, launches_e = _serve(eager)
        assert out_g == out_e
        assert [k for k, _ in seen_g] == [k for k, _ in seen_e]
        for (key, g), (_, e) in zip(seen_g, seen_e):
            assert torch.equal(g, e), key
        assert launches_g == launches_e
        steps = graphs.stats["steps"]
        suffix = "" if mode == "none" else "_q"
        ring = "flash_attention_ring" + ("_q8" if cache == "int8" else "")
        assert launches_g == {**{k: 0 for k in launches_g},
                              f"blast_matmul{suffix}": 10 * steps,
                              f"blast_matmul_grouped{suffix}": 2 * steps,
                              ring: steps}

    @pytest.mark.parametrize("cache", ["none", "int8_cache"])
    def test_ssd_replay_equals_eager(self, cuda, cache):
        """mamba2-130m at full width (3 of its 24 SSD layers), bf16, over
        the float or the int8 state cache (a capture's all-dead warm-up
        packs the int8 state again, and the engine undoes that, ROADMAP
        C13): the captured step equals the eager one bit for bit — tokens,
        every step's logits, launches (2 B1 a layer a step: in_proj,
        out_proj)."""
        quantized = cache == "int8_cache"
        cfg = dataclasses.replace(
            configs.get("mamba2-130m"), n_layers=3,
            quant=quant.QuantConfig(cache="int8" if quantized else "none"))
        model = build_model(cfg, device="cuda")
        params = model.init(0)
        graphs = _engine(model, params, "none")
        eager = _engine(model, params, "none", step_fn=model.prefill_chunk)
        out_g, seen_g, launches_g = _serve(graphs)
        out_e, seen_e, launches_e = _serve(eager)
        assert out_g == out_e
        assert [k for k, _ in seen_g] == [k for k, _ in seen_e]
        for (key, g), (_, e) in zip(seen_g, seen_e):
            assert torch.equal(g, e), key
        assert launches_g == launches_e
        assert launches_g == {**{k: 0 for k in launches_g},
                              "blast_matmul": 6 * graphs.stats["steps"]}

    def test_deepseek_replay_equals_eager(self, cuda):
        """deepseek-v3-671b at full width cut to one dense and one MoE
        layer (bf16, weights drawn on the card: MLA over the latent cache,
        ``wkv_b``'s densification, 256 experts and the shared expert):
        every captured step's logits equal the eager step's bit for bit,
        over prefill chunks and decode steps, and so do the launches a
        step (a layer: 4 B1, 2 B2, the MLA kernel; the MoE layer 2 batched
        launches)."""
        cfg = configs.get("deepseek-v3-671b")
        cfg = dataclasses.replace(cfg, n_layers=2, moe=dataclasses.replace(
            cfg.moe, first_dense_layers=1))
        model = build_model(cfg, device=cuda)
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        graphs = _engine(model, params, "none")
        eager = _engine(model, params, "none", step_fn=model.prefill_chunk)
        out_g, seen_g, launches_g = _serve(graphs)
        out_e, seen_e, launches_e = _serve(eager)
        assert out_g == out_e
        assert [k for k, _ in seen_g] == [k for k, _ in seen_e]
        assert graphs.stats["graphs"] > 0
        for (key, g), (_, e) in zip(seen_g, seen_e):
            assert torch.equal(g, e), key
        steps = graphs.stats["steps"]
        assert launches_g == launches_e == {
            **{k: 0 for k in launches_g}, "blast_matmul": 8 * steps,
            "blast_matmul_grouped": 4 * steps, "mla_attention": 2 * steps,
            "blast_matmul_batched": 2 * steps}

    def test_capture_after_a_dropped_engine(self, cuda, monkeypatch):
        """A dropped engine whose graphs a reference cycle holds (``_serve``
        makes one): a garbage collection under a later engine's capture
        would destroy them there, an unsafe call that invalidates that
        capture.  The collector is held off and then forced under every
        capture, where it otherwise runs when an allocation crosses its
        thresholds; the engine collects before it captures, so the old
        graphs are gone first and the new engine serves the same tokens."""
        model = build_model(_cfg("bfloat16"), device=cuda)
        params = model.init(0)
        step = Engine._device_step

        def collecting(self, key):
            if torch.cuda.is_current_stream_capturing():
                gc.collect()
            return step(self, key)

        gc.disable()
        try:
            old = _engine(model, params, "none")
            out, _, _ = _serve(old)
            assert old.stats["graphs"] > 0
            gone = weakref.ref(old)
            del old
            assert gone() is not None        # its cycle keeps it
            monkeypatch.setattr(Engine, "_device_step", collecting)
            new = _engine(model, params, "none")
            assert _serve(new)[0] == out
            assert gone() is None and new.stats["graphs"] > 0
        finally:
            gc.enable()

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
