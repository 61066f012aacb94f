"""Engine API v2 of the port (``repro_torch/serve/config.py``,
``serve/engine.py``), mirroring ``tests/test_engine_api.py`` (its HTTP
class comes with ROADMAP A8) and the deadline and shedding cases of
``tests/test_resilience.py``: the frozen configs, the admission policy,
the token budget, the async stream against ``generate_batch``,
cancellation, the ``truncated`` flag, deadlines, overflow shedding and
``sla_report``.

The port alone on a tiny config (fp32, CPU), as the reference's tests run;
``sla_report`` is also held against the JAX engine's on the same trace
(smollm-135m.reduced(), the reference's weights): the same keys but
``"resilience"`` (A8), and the same counts."""

import asyncio

import numpy as np
import pytest

from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import MemoryConfig as JMemoryConfig
from repro.serve import Request as JRequest
from repro.serve import SchedulerConfig as JSchedulerConfig

from repro_torch import configs
from repro_torch.models import build_model
from repro_torch.serve import (Engine, EngineConfig, MemoryConfig, Request,
                               ResilienceConfig, SamplingParams,
                               SchedulerConfig)
from torch_parity import reference_pair


def _tiny():
    cfg = configs.get("smollm-135m").reduced(
        vocab=64, d_model=32, n_layers=2, d_ff=64, n_heads=2, n_kv_heads=1)
    model = build_model(cfg, device="cpu")
    return model, model.init(0)


def _config(res=None, **mem):
    return EngineConfig(scheduler=SchedulerConfig(slots=2, chunk_size=8),
                        memory=MemoryConfig(max_len=64, **mem),
                        resilience=res or ResilienceConfig())


def _reqs(n=3, max_new=8):
    prompts = [[4, 5], list(range(6, 15)), [7, 8, 9], [9, 3, 5, 7],
               [11, 12], [13, 14, 15]]
    return [Request(uid=i + 1, prompt=list(p), max_new_tokens=max_new)
            for i, p in enumerate(prompts[:n])]


def _serve(model, params, cfg, reqs):
    eng = Engine(model, params, cfg, device="cpu")
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng


class TestEngineConfig:
    def test_configs_are_frozen(self):
        c = _config()
        with pytest.raises(Exception):
            c.scheduler.slots = 9
        with pytest.raises(Exception):
            c.resilience.queue_high_water = 3

    def test_unknown_policy_raises(self):
        model, params = _tiny()
        with pytest.raises(ValueError, match="policy"):
            Engine(model, params, EngineConfig(
                scheduler=SchedulerConfig(policy="lifo")), device="cpu")

    @pytest.mark.parametrize("policy", ["priority", "fifo"])
    def test_policy_orders_admission(self, policy):
        """One slot, a bulk request (priority 1) queued before an urgent one
        (priority 0): the priority policy admits the urgent one first, FIFO
        the first to arrive."""
        model, params = _tiny()
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=1, chunk_size=8, policy=policy),
            memory=MemoryConfig(max_len=64)), device="cpu")
        eng.submit(Request(uid=1, prompt=[4, 5, 6], max_new_tokens=3,
                           priority=1))
        eng.submit(Request(uid=2, prompt=[7, 8], max_new_tokens=3,
                           priority=0))
        order = [r.uid for r in eng.run()]
        assert order == ([2, 1] if policy == "priority" else [1, 2])

    def test_token_budget_caps_each_step(self):
        """A token budget below slots × chunk: no step feeds more tokens than
        the budget, the prompts take more steps, and the greedy tokens are
        those of the unbudgeted engine."""
        model, params = _tiny()
        fed = []

        def step_fn(params_, cache, tokens, steps, n_tokens, **kw):
            fed.append(int(n_tokens.sum()))
            return model.prefill_chunk(params_, cache, tokens, steps,
                                       n_tokens, **kw)

        def serve(budget, fn=None):
            eng = Engine(model, params, EngineConfig(
                scheduler=SchedulerConfig(slots=2, chunk_size=8,
                                          token_budget=budget),
                memory=MemoryConfig(max_len=64)), device="cpu", step_fn=fn)
            reqs = [Request(uid=i, prompt=list(range(4 + 12 * i, 16 + 12 * i)),
                            max_new_tokens=4) for i in range(3)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            return [r.output for r in reqs], eng.stats["steps"]

        want, steps_free = serve(None)
        got, steps_capped = serve(4, step_fn)
        assert got == want
        assert max(fed) == 4 and steps_capped > steps_free

    def test_cancel_queued_request_never_runs(self):
        model, params = _tiny()
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=1, chunk_size=8),
            memory=MemoryConfig(max_len=64)), device="cpu")
        a, b = _reqs(2, max_new=3)
        eng.submit(a)
        eng.submit(b)
        eng.tick()              # a takes the one slot, b waits
        eng.cancel(b.uid)
        assert b.done and b.stop_reason == "cancelled" and not b.output
        assert not eng.queue
        eng.run()
        assert a.stop_reason == "length" and len(a.output) == 3
        assert b.output == [] and b.t_first is None


class TestAsyncGenerate:
    def test_stream_matches_generate_batch(self):
        model, params = _tiny()
        prompts = [[4, 5], [7, 8, 9], [10, 11]]
        ref = [r.output for r in Engine(model, params, _config(),
                                        device="cpu")
               .generate_batch(prompts, SamplingParams(max_new_tokens=6))]

        async def run():
            eng = Engine(model, params, _config(), device="cpu")
            sp = SamplingParams(max_new_tokens=6)

            async def collect(p):
                return [t async for t in eng.generate(p, sp)]

            return await asyncio.gather(*(collect(p) for p in prompts))

        assert asyncio.run(run()) == ref

    def test_close_stream_cancels_and_frees_pages(self):
        model, params = _tiny()
        eng = Engine(model, params, _config(paged=True, page_size=8,
                                            prefix_sharing=False),
                     device="cpu")

        async def run():
            stream = eng.generate([4, 5, 6],
                                  SamplingParams(max_new_tokens=30))
            got = []
            async for tok in stream:
                got.append(tok)
                if len(got) == 2:
                    break              # the client walks away mid-generation
            await stream.aclose()
            for _ in range(50):        # the driver settles
                if not any(s.req for s in eng.slots):
                    break
                await asyncio.sleep(0.02)
            return got

        got = asyncio.run(run())
        assert len(got) == 2
        eng._pc.audit()
        assert eng._pc.pages.n_free == eng._pc.pages.n_pages - 1
        assert eng.finished[-1].stop_reason == "cancelled"
        assert eng.finished[-1].truncated is False

    def test_capacity_truncation_sets_flag_preemption_does_not(self):
        model, params = _tiny()
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=1, chunk_size=8),
            memory=MemoryConfig(max_len=16)), device="cpu")
        eng.submit(Request(uid=0, prompt=[4, 5, 6], max_new_tokens=64))
        r = eng.run()[0]
        assert r.truncated and r.stop_reason == "capacity"
        assert len(r.output) == 16 - 3
        # a preempted request resumes and ends by length, not truncated
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=2, chunk_size=4),
            memory=MemoryConfig(max_len=64, paged=True, page_size=8,
                                pages=8, prefix_sharing=False)),
            device="cpu")
        for uid, prompt in ((0, range(1, 9)), (1, range(9, 17))):
            eng.submit(Request(uid=uid, prompt=list(prompt),
                               max_new_tokens=24, priority=1))
        for _ in range(8):
            eng.tick()
        eng.submit(Request(uid=2, prompt=[3, 4, 5], max_new_tokens=8))
        eng.run()
        preempted = [r for r in eng.finished if r.n_preempted]
        assert preempted and eng.stats["preemptions"] > 0
        assert all(r.stop_reason == "length" and not r.truncated
                   for r in eng.finished)


class TestDeadlinesShedding:
    def test_request_deadline_expires(self):
        model, params = _tiny()
        reqs = _reqs()
        reqs[1].deadline_s = 0.0   # already expired at the first tick
        eng = _serve(model, params, _config(), reqs)
        assert reqs[1].stop_reason == "deadline"
        assert reqs[1].t_done is not None and not reqs[1].output
        assert all(r.stop_reason == "length" for r in reqs
                   if r.uid != reqs[1].uid)
        assert eng.stats["deadline_expired"] == 1

    def test_config_deadline_stops_a_running_request(self):
        model, params = _tiny()
        eng = Engine(model, params, EngineConfig(
            scheduler=SchedulerConfig(slots=2, chunk_size=8,
                                      deadline_s=3600.0),
            memory=MemoryConfig(max_len=64)), device="cpu")
        req = Request(uid=1, prompt=[4, 5], max_new_tokens=30)
        eng.submit(req)
        for _ in range(3):
            eng.tick()
        assert len(req.output) == 3 and not req.done
        req.t_submit -= 7200.0     # as if submitted two hours ago
        eng.run()
        assert req.stop_reason == "deadline" and len(req.output) == 3
        assert eng.stats["deadline_expired"] == 1
        assert not any(s.req for s in eng.slots)

    def test_shed_above_high_water(self):
        model, params = _tiny()
        reqs = _reqs(6)
        eng = _serve(model, params, _config(ResilienceConfig(
            queue_high_water=3)), reqs)
        shed = [r for r in reqs if r.stop_reason == "shed"]
        kept = [r for r in reqs if r.stop_reason == "length"]
        assert len(shed) == 3 and len(kept) == 3
        assert eng.stats["shed"] == 3
        # newest-first shedding: the first-submitted requests survive
        assert {r.uid for r in kept} == {1, 2, 3}
        assert eng.overloaded() is False

    def test_sla_report_nulls_for_empty_class(self):
        model, params = _tiny()
        reqs = _reqs(2)
        eng = _serve(model, params, _config(ResilienceConfig(
            queue_high_water=0)), reqs)
        assert all(r.stop_reason == "shed" for r in reqs)
        c0 = eng.sla_report()["classes"]["0"]
        assert c0["requests"] == 2 and c0["completed"] == 0
        assert c0["stop_reasons"] == {"shed": 2}
        # explicit nulls, never a fabricated 0.0 latency
        assert c0["ttft_p50_s"] is None and c0["tpot_p99_s"] is None


def test_sla_report_matches_jax_engine():
    """One two-class trace on a paged pool through both engines: the same
    report keys (the reference's ``"resilience"`` aside, A8), the same
    counts per class and the same multi-tenant counters."""
    jmodel, jparams, model, params = reference_pair()
    rng = np.random.default_rng(3)
    shared = [int(t) for t in rng.integers(0, 512, 16)]
    trace = [(0, 1, [int(t) for t in rng.integers(0, 512, 8)], 12)
             for _ in range(3)]
    trace += [(2 + i, 0, shared + [i], 4) for i in range(3)]
    mem = dict(max_len=64, paged=True, page_size=8, pages=6)
    jeng = JEngine(jmodel, jparams, JEngineConfig(
        scheduler=JSchedulerConfig(slots=2, chunk_size=8),
        memory=JMemoryConfig(**mem)))
    eng = Engine(model, params, EngineConfig(
        scheduler=SchedulerConfig(slots=2, chunk_size=8),
        memory=MemoryConfig(**mem)), device="cpu")
    for e, R in ((jeng, JRequest), (eng, Request)):
        tick, pending = 0, list(enumerate(trace))
        while pending or e.queue or any(s.req for s in e.slots):
            while pending and pending[0][1][0] <= tick:
                uid, (_, prio, prompt, n) = pending.pop(0)
                e.submit(R(uid=uid, prompt=prompt, max_new_tokens=n,
                           priority=prio))
            e.tick()
            tick += 1
    want, got = jeng.sla_report(), eng.sla_report()
    assert set(got) == set(want) - {"resilience"}
    assert got["preemptions"] > 0 and got["prefix_hit_tokens"] > 0
    for k in ("preemptions", "preemption_rate", "prefix_hit_tokens",
              "prefix_hit_rate", "queue_depth_p50", "queue_depth_max",
              "pool_tokens", "pool_pages_free"):
        assert got[k] == want[k], k
    assert set(got["classes"]) == set(want["classes"]) == {"0", "1"}
    for c, w in want["classes"].items():
        g = got["classes"][c]
        assert set(g) == set(w)
        for k in ("requests", "completed", "stop_reasons"):
            assert g[k] == w[k], (c, k)
        assert all(g[k] > 0 for k in g if k.endswith("_s"))


def test_launcher_trace_prints_the_sla_report(capsys):
    """The serving launcher's paged multi-tenant trace on the CPU: every
    request finishes, and the report prints each class's TTFT and TPOT,
    the prefix-hit rate and the pool's occupancy."""
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "smollm-135m", "--reduced", "--device",
                       "cpu", "--paged", "--pages", "16", "--page-size", "16",
                       "--priority-classes", "2", "--trace"])
    out = capsys.readouterr().out
    assert len(reqs) == 14 and all(r.done for r in reqs)
    for c in ("0", "1"):
        assert f"[serve] class {c}: " in out
    assert out.count("TTFT p50 ") == 2 and out.count("TPOT p50 ") == 2
    assert "prefix-hit " in out and "[serve] pool: 15 pages" in out
    hit = float(out.split("prefix-hit ")[1].split()[0])
    assert hit > 0
