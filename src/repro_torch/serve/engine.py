"""Continuous-batching inference engine with chunked prefill — the port of
``repro/serve/engine.py``: slot-static or paged caches, greedy or
temperature sampling, over a float or int8 KV cache, with Engine API v2.

A fixed pool of B slots advances through one ``prefill_chunk`` per
iteration.  Each iteration the scheduler packs a mixed batch under a token
budget: slots still ingesting their prompt contribute up to ``chunk_size``
prompt tokens, slots in generation exactly one token.  The chunk width C is
bucketed to a power of two.  A finished slot is released and recycled for
the next queued request at once.

API v2 (``serve/config.py``): ``Engine(model, params, EngineConfig(...))``
plus ``async generate(prompt, sampling, priority=...)`` streaming one token
at a time, ``generate_batch`` for scripts, ``tick`` for trace-driven
callers, ``cancel(uid)``, ``throughput``, ``overloaded`` and
``sla_report``.  ``SchedulerConfig.policy`` picks priority-aware or FIFO admission;
``deadline_s`` and ``ResilienceConfig.queue_high_water`` stop requests
with ``"deadline"`` and ``"shed"``.

With ``MemoryConfig(paged=True)`` cache memory is sized in tokens, not
slots: ``serve/paged.py`` pools fixed-size pages under the K/V leaves,
shares page-aligned prompt prefixes across requests, and the scheduler
preempts the lowest-priority longest-running generation when the pool runs
dry (recompute on resume: the request re-feeds prompt and output).

The compiled step.  The reference runs ``jax.jit`` of its step; here, on
the card, the engine captures the step as one CUDA graph per bucket and
replays it: (C bucket, kv bucket) slot-static — the kv bucket is
``flash_attention.kv_bucket`` of the step's largest live position, which
fixes the attention kernel's launch plan — and (C, kv, F, M) paged, F and
M the power-of-two buckets of the step's fresh pages and write triples.
The graphs read static device buffers (tokens, steps, n_tokens; paged also
the page table, fresh list and triples), filled from one pinned host
buffer by one copy a step; only the sampling pass and its copy to the host
stay outside.  A capture that fails raises, naming its bucket: there is no
fallback to the eager step.  On the CPU, and with ``step_fn=`` (the
reference's override of the compiled step; paged, it replaces the inner
``prefill_chunk``), the same step runs eagerly on the same buffers.  All
device work runs under the engine lock: ``generate`` ticks in a worker
thread, and ``cancel`` may run on the event loop's.

Quantized serving: ``EngineConfig.quant`` (or the model's ``cfg.quant``)
quantizes float weights at load, before the pre-stack, and selects the
activation mode.  The reference sets that mode process-wide at engine build;
here each engine scopes it to its own steps, so engines of different modes
can live in one process.  The int8 KV cache is the model's
(``ArchConfig.quant.cache``, which shapes ``init_cache``); a cache mode
given through ``EngineConfig.quant`` is refused, as the reference refuses
it.

Sampling (``sample_tokens``): a request with ``temperature > 0`` takes
``argmax(logits / T + g)`` with g standard Gumbel noise — a draw from
``softmax(logits / T)`` — the others the greedy argmax.  The noise, one
(B, V) tensor a step in which some row samples, comes from the engine's
own ``torch.Generator`` on its device, seeded by ``EngineConfig.seed``: one
seed gives the same tokens on the same device and schedule.  The reference
draws with ``jax.random.categorical`` from its own key; that stream is not
reproduced bit for bit, only its distribution.

Self-speculative decoding (``EngineConfig.speculative``, k > 0): the
draft is the model itself with every BLAST linear truncated to its
highest-energy ranks (``LM.draft_plan``, ``truncate_params``: the paper's
nested ranks), with a slot-static cache of its own (also in paged mode).
When every active slot is in greedy decode, an iteration is one round
(``_spec_round``): k single-token draft steps, one verify chunk of the
full model over [current token, k drafts] with logits on every column,
the longest agreeing draft prefix plus the verifier's next token committed
(at most the row's budget), the verify's cache rolled back past it, and a
draft resync chunk over the committed tokens.  The verifier's argmax
decides every emitted token, so greedy outputs equal plain decoding's.
Other iterations run the plain step and replay the same chunk through the
draft on its cache.  On the card the whole round is one CUDA graph per kv
bucket (paged: per (kv, F, M), around the gather and scatter of the
round's pages), and its token ids come back in one copy.

A model with RG-LRU state or sliding-window ring caches (the hybrid
family, ``LM.slot_resident``) is served in every mode.  ``_reset_slot``
resets a row's conv history and state ``h`` with its ring.  Paged, its
state leaves stay slot-resident and a prefix entry owns a snapshot of them
(``MemoryConfig.snap_slots``); such a model registers one prefix boundary
a request (its ``prefix_len`` hint, else ``len(prompt) - 1`` rounded down
to a page) and clips prefill chunks to land on it.  A speculative round
collects the verify's per-token RG-LRU states and rolls them back to the
committed length, and restores the draft's state before its resync.  The
int8 cache quantizes a ring's K/V and the RG-LRU state.

Not ported yet, besides: resilience (guardrail, health,
watchdog, fault injection, step-error requeues, ``healthz``, the round's
logit health check and its ``spec_off`` rung) and the HTTP frontend (A8),
serving over a device mesh (A9) and autotune with the draft's warm-up
(A12).  The reference's legacy flat constructor keywords are not kept: an
``EngineConfig`` is the one way to configure the engine.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import heapq
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import structures
from repro_torch.kernels import blast_matmul as kbm
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import kv_bucket
from repro_torch.quant import qarray as qt
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.paged import PagedCache


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """Next tokens (B,) from logits (B, V): rows with ``temperature[b] > 0``
    draw from ``softmax(logits[b] / T)`` as ``argmax(logits / T + g)``, g
    standard Gumbel noise (B, V) from ``generator`` (``-log(-log u)``, u
    uniform in [0, 1); u = 0 gives -inf, never picked); the others take the
    greedy argmax.  One pass on the logits' device."""
    lf = logits.float()
    t = temperature.to(device=lf.device, dtype=torch.float32)[:, None]
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    noisy = lf / torch.where(t > 0, t, torch.ones_like(t)) - torch.log(
        -torch.log(u))
    return torch.argmax(torch.where(t > 0, noisy, lf), dim=-1)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    priority: int = 0          # lower = more urgent (0 = interactive)
    prefix_len: int | None = None  # shared-prefix hint (tokens): a model
    #                            with state leaves snapshots it exactly here
    deadline_s: float | None = None  # end-to-end deadline override
    #                            (None: SchedulerConfig.deadline_s)
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False    # cache-capacity truncation only
    stop_reason: str | None = None  # length | capacity | cancelled | shed |
    #                            deadline | error
    n_preempted: int = 0       # times this request lost its pages and re-queued
    t_submit: float | None = None
    t_first: float | None = None   # first output token (TTFT = t_first-t_submit)
    t_done: float | None = None


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0            # next absolute position to write
    to_feed: deque = dataclasses.field(default_factory=deque)  # prompt left
    feed: list = dataclasses.field(default_factory=list)  # full feed (prefix reg)
    reg_at: int | None = None  # page-aligned prefix-registration boundary


def _bucket(n: int) -> int:
    """Round a width up to a power of two."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _Graph:
    """One captured step: its graph, its output (logits, or a round's token
    ids: graph memory, rewritten by every replay) and the kernel launches
    one replay makes."""
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor
    launches: dict


class Engine:
    def __init__(self, model, params, config: EngineConfig | None = None, *,
                 device=None, step_fn=None):
        """``model``: a ``repro_torch.models.LM`` on ``device`` (default
        cuda; raises without a GPU unless ``device="cpu"``).  ``config``:
        an ``EngineConfig`` (default ``EngineConfig()``).  ``step_fn``
        replaces ``model.prefill_chunk`` (same signature: device tensors
        and ``kv_len=``; with speculation also ``all_logits=``) and runs
        eagerly every step — e.g. to observe every step's logits."""
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"engine device {dev} != model device "
                             f"{model.device}")
        self.device = dev
        self.config = config = config or EngineConfig()
        sch, mem = config.scheduler, config.memory
        qcfg = config.quant if config.quant is not None else model.cfg.quant
        if qcfg.cache != "none" and not model.cfg.cache_quant:
            # cache shapes are baked into the model at construction
            raise ValueError(
                "quant.cache is a model-construction knob: build the model "
                "with ArchConfig.quant (init_cache allocates int8 + scales "
                "from it); the Engine quant= override only covers weights")
        if qcfg.weight_bits is not None and not qt.tree_is_quantized(params):
            params = model.quantize_params(params, qcfg)
        self.act_mode = qcfg.activations
        self.model = model
        self.B = sch.slots
        self.max_len = mem.max_len
        self.chunk = max(1, int(sch.chunk_size))
        self.token_budget = (self.B * self.chunk if sch.token_budget is None
                             else max(1, int(sch.token_budget)))
        self.policy = sch.policy
        if self.policy not in ("priority", "fifo"):
            raise ValueError(f"unknown scheduler policy {sch.policy!r}")

        # -- cache storage: slot-static rows, or the paged pool ---------------
        self._pc: PagedCache | None = None
        if mem.paged:
            n_pp = mem.max_len // mem.page_size
            pages = (self.B * n_pp + 1 if mem.pages is None
                     else int(mem.pages))
            snap = (max(4, pages // 4) if mem.snap_slots is None
                    else int(mem.snap_slots))
            self._pc = PagedCache(model, self.B, mem.max_len, mem.page_size,
                                  pages, snap, mem.prefix_sharing)
            self.cache = self._pc.view
        else:
            self.cache = model.init_cache(self.B, mem.max_len)
        self.slots = [_Slot() for _ in range(self.B)]
        # -- the speculative draft: the model's own factors at the ranks
        # of the plan, calibrated on the (quantized) weights before the
        # pre-stack, as the reference orders them
        spec = config.speculative
        self.spec_k = max(0, int(spec.k))
        self.draft_rank_frac = float(spec.draft_rank_frac)
        self._cv = _bucket(self.spec_k + 1)    # the verify chunk's width
        if self.spec_k and model.cfg.window and min(
                mem.max_len, model.cfg.window) < self._cv:
            # a round saves and restores the verify's window slot by slot
            raise ValueError(f"a ring of {model.cfg.window} slots is "
                             f"narrower than the verify chunk ({self._cv})")
        if self.spec_k:
            self.draft_plan = model.draft_plan(params, self.draft_rank_frac)
            draft = model.truncate_params(params, self.draft_plan)
            if dev.type == "cuda":
                # arbitrary draft ranks, padded to the tile kernel's rank
                # granule once here: each launch would pad a copy otherwise
                draft = model.pad_ranks(draft, kbm.float_tiles()[1])
            self.draft_params = (model.prestack_params(draft)
                                 if config.prestack else draft)
            # slot-static in paged mode too: every round rewinds it, so it
            # holds no prefix worth sharing
            self.draft_cache = model.init_cache(self.B, mem.max_len)
        self._rr = 0
        self.queue: list = []   # heap of (prio_key, seq, Request)
        self._seq = 0
        self._step = step_fn if step_fn is not None else model.prefill_chunk
        # bucket key -> _Graph; None: the step runs eagerly
        self._graphs = ({} if step_fn is None and dev.type == "cuda"
                        else None)
        self._pool = None                   # the graphs' shared memory pool
        # static inputs, one int64 buffer: tokens (B, C) of every C bucket
        # share the first B·C entries, then steps (B,), n_tokens (B,) and
        # budget (B,) (a round's current tokens, positions, live flags and
        # token budgets are tokens[:, 0], steps, n_tokens and budget);
        # paged, then the page table (B·g of a gather of g pages a row),
        # fresh pages (F), and the triples' rows, logical and physical
        # pages (M each) of every F and M bucket
        self._cmax = _bucket(self.chunk)
        off = self.B * (self._cmax + 3)
        size = off
        if self._pc is not None:
            pc = self._pc
            # a write window of w tokens spans ≤ (w-1)//ps + 2 pages; a
            # round's window is k + 1 tokens
            w = max(self.chunk, self.spec_k + 1)
            self._mmax = _bucket(self.B * min(pc.n_pp, (w - 1) // pc.ps + 2))
            self._offs = {"table": off,
                          "fresh": off + self.B * pc.n_pp}
            for i, name in enumerate(("rows", "lps", "phys")):
                self._offs[name] = (self._offs["fresh"]
                                    + (i + 1) * self._mmax)
            size = self._offs["phys"] + self._mmax
        self._host = torch.zeros((size,), dtype=torch.int64,
                                 pin_memory=dev.type == "cuda")
        self._host_np = self._host.numpy()
        self._inputs = torch.zeros_like(self._host, device=dev)
        # the sampling noise's generator
        self._gen = torch.Generator(device=dev).manual_seed(int(config.seed))
        self.finished: list[Request] = []   # everything ever completed
        self.stats = {"steps": 0, "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_time": 0.0, "decode_time": 0.0,
                      # per-step wall times: all steps + pure-decode steps
                      "step_s": [], "decode_step_s": [],
                      "graphs": 0, "capture_s": 0.0,
                      # multi-tenant serving signals
                      "preemptions": 0, "prefix_hit_tokens": 0,
                      "prompt_tokens_submitted": 0, "queue_depth": [],
                      "shed": 0, "deadline_expired": 0,
                      # speculative rounds: rounds, drafted, accepted and
                      # emitted tokens
                      "spec_rounds": 0, "spec_drafted": 0,
                      "spec_accepted": 0, "spec_emitted": 0}
        # async streaming state
        self._lock = threading.Lock()
        self._streams: dict[int, tuple[Request, asyncio.Queue]] = {}
        self._driver: asyncio.Task | None = None
        self._auto_uid = 1 << 40
        self.resilience = config.resilience
        self._deadline_s = sch.deadline_s
        self._deadlines_armed = sch.deadline_s is not None
        self.params = (model.prestack_params(params) if config.prestack
                       else params)

    # -- public -----------------------------------------------------------------

    def submit(self, req: Request):
        with self._lock:
            self._submit_locked(req)

    def _submit_locked(self, req: Request):
        if not req.prompt:
            raise ValueError(f"request {req.uid}: empty prompt (generation "
                             "needs at least one conditioning token)")
        req.t_submit = time.perf_counter()
        if req.deadline_s is not None:
            self._deadlines_armed = True
        self.stats["prompt_tokens_submitted"] += len(req.prompt)
        self._enqueue(req)

    def _prio(self, req: Request) -> int:
        """Effective scheduling priority: FIFO mode ignores priority
        classes (arrival order, no priority preemption)."""
        return req.priority if self.policy == "priority" else 0

    def _enqueue(self, req: Request):
        self._seq += 1
        heapq.heappush(self.queue, (self._prio(req), self._seq, req))

    def run(self, max_iters: int = 100_000) -> list[Request]:
        """Drive until queue + slots drain.  Returns completed requests."""
        n0 = len(self.finished)
        for _ in range(max_iters):
            with self._lock:
                if not self._tick_locked():
                    break
        return self.finished[n0:]

    def tick(self) -> bool:
        """One scheduler iteration (trace-driven callers submit between
        ticks).  Returns False once queue + slots are drained."""
        with self._lock:
            return self._tick_locked()

    def generate_batch(self, prompts, sampling: SamplingParams | None = None,
                       priority: int = 0) -> list[Request]:
        """Submit every prompt, drive to drain, return the requests in input
        order."""
        sampling = sampling or SamplingParams()
        reqs = []
        for prompt in prompts:
            with self._lock:
                uid = self._auto_uid
                self._auto_uid += 1
            req = Request(uid=uid, prompt=list(prompt),
                          max_new_tokens=sampling.max_new_tokens,
                          temperature=sampling.temperature, priority=priority)
            reqs.append(req)
            self.submit(req)
        self.run()
        return reqs

    async def generate(self, prompt, sampling: SamplingParams | None = None,
                       *, priority: int = 0, prefix_len: int | None = None,
                       uid: int | None = None,
                       deadline_s: float | None = None):
        """Async token stream for one request.  Closing the iterator early
        (client disconnect) cancels the request and releases its pages at
        once.  All concurrent ``generate`` calls batch through one shared
        driver task, so streams interleave at engine-iteration
        granularity."""
        sampling = sampling or SamplingParams()
        with self._lock:
            if uid is None:
                uid = self._auto_uid
                self._auto_uid += 1
        req = Request(uid=uid, prompt=list(prompt),
                      max_new_tokens=sampling.max_new_tokens,
                      temperature=sampling.temperature, priority=priority,
                      prefix_len=prefix_len, deadline_s=deadline_s)
        q: asyncio.Queue = asyncio.Queue()
        with self._lock:
            self._submit_locked(req)
            self._streams[uid] = (req, q)
        self._ensure_driver()
        try:
            while True:
                tok = await q.get()
                if tok is None:
                    break
                yield tok
        finally:
            if not req.done:
                self.cancel(uid)
            with self._lock:
                self._streams.pop(uid, None)

    def cancel(self, uid: int):
        """Abort a queued or running request: its slot (pages, cache row) is
        released at once, not at the next natural recycle."""
        with self._lock:
            for i, (_, _, req) in enumerate(self.queue):
                if req.uid == uid:
                    self.queue.pop(i)
                    heapq.heapify(self.queue)
                    self._finish(req, "cancelled")
                    return
            for b, slot in enumerate(self.slots):
                if slot.req is not None and slot.req.uid == uid:
                    req = slot.req
                    self._release_slot(b)
                    self._finish(req, "cancelled")
                    return

    def _ensure_driver(self):
        if self._driver is None or self._driver.done():
            self._driver = asyncio.get_running_loop().create_task(
                self._drive())

    async def _drive(self):
        """Single background task batching all async ``generate`` streams:
        run one engine iteration in a worker thread, flush freshly emitted
        tokens to each stream's queue, repeat until drained.  A tick that
        raises fails every in-flight request (each stream sees its
        terminator) and re-raises."""
        emitted: dict[int, int] = {}
        try:
            while True:
                with self._lock:
                    work = bool(self.queue) or any(s.req for s in self.slots)
                if not work:
                    break
                await asyncio.to_thread(self._tick_threadsafe)
                self._flush_streams(emitted)
        except Exception:
            with self._lock:
                for b, s in enumerate(self.slots):
                    if s.req is not None:
                        req = s.req
                        self._release_slot(b)
                        self._finish(req, "error")
                while self.queue:
                    self._finish(heapq.heappop(self.queue)[2], "error")
            raise
        finally:
            self._flush_streams(emitted)

    def _tick_threadsafe(self):
        with self._lock:
            self._tick_locked()

    def _flush_streams(self, emitted: dict[int, int]):
        with self._lock:
            streams = list(self._streams.values())
        for req, q in streams:
            sent = emitted.get(req.uid, 0)
            for tok in req.output[sent:]:
                q.put_nowait(tok)
            emitted[req.uid] = len(req.output)
            if req.done:
                q.put_nowait(None)
                emitted.pop(req.uid, None)
                with self._lock:
                    self._streams.pop(req.uid, None)

    def throughput(self) -> dict:
        """Prefill / decode tokens-per-second split from engine stats; with
        speculation also the rounds, the share of drafts accepted and the
        tokens a round emits."""
        s = self.stats
        out = {"steps": s["steps"],
               "prefill_tok_s": (s["prefill_tokens"] / s["prefill_time"]
                                 if s["prefill_time"] else 0.0),
               "decode_tok_s": (s["decode_tokens"] / s["decode_time"]
                                if s["decode_time"] else 0.0)}
        if self.spec_k:
            out["spec_rounds"] = s["spec_rounds"]
            out["acceptance_rate"] = (s["spec_accepted"] / s["spec_drafted"]
                                      if s["spec_drafted"] else 0.0)
            out["tokens_per_round"] = (s["spec_emitted"] / s["spec_rounds"]
                                       if s["spec_rounds"] else 0.0)
        return out

    def overloaded(self) -> bool:
        """Admission-control signal: requests in flight at or above
        ``ResilienceConfig.queue_high_water``.  Lock-free on purpose."""
        hw = self.resilience.queue_high_water
        if hw is None:
            return False
        n_active = sum(1 for s in self.slots if s.req is not None)
        return len(self.queue) + n_active >= hw

    def sla_report(self) -> dict:
        """TTFT / TPOT percentiles per priority class, plus the multi-tenant
        counters (preemption and prefix-hit rates, queue depth) and, paged,
        the pool's size.

        Every finished request counts in its class's ``requests`` and
        ``stop_reasons``, but only requests that produced a first token
        give latency samples: a class with none reports ``None``
        percentiles."""
        def pct(xs, q):
            return float(np.percentile(np.asarray(xs), q)) if xs else None

        classes: dict[int, dict] = {}
        for r in self.finished:
            c = classes.setdefault(r.priority, {"ttft": [], "tpot": [],
                                                "requests": 0,
                                                "stop_reasons": {}})
            c["requests"] += 1
            reason = r.stop_reason or "unknown"
            c["stop_reasons"][reason] = c["stop_reasons"].get(reason, 0) + 1
            if r.t_submit is None or r.t_first is None:
                continue
            c["ttft"].append(r.t_first - r.t_submit)
            if r.t_done is not None and len(r.output) > 1:
                c["tpot"].append((r.t_done - r.t_first)
                                 / (len(r.output) - 1))
        per_class = {
            str(p): {"requests": c["requests"],
                     "completed": len(c["ttft"]),
                     "stop_reasons": c["stop_reasons"],
                     "ttft_p50_s": pct(c["ttft"], 50),
                     "ttft_p99_s": pct(c["ttft"], 99),
                     "tpot_p50_s": pct(c["tpot"], 50),
                     "tpot_p99_s": pct(c["tpot"], 99)}
            for p, c in sorted(classes.items())}
        s = self.stats
        out = {
            "classes": per_class,
            "preemptions": s["preemptions"],
            "preemption_rate": (s["preemptions"] / len(self.finished)
                                if self.finished else 0.0),
            "prefix_hit_tokens": s["prefix_hit_tokens"],
            "prefix_hit_rate": (s["prefix_hit_tokens"]
                                / s["prompt_tokens_submitted"]
                                if s["prompt_tokens_submitted"] else 0.0),
            "queue_depth_p50": pct(s["queue_depth"], 50) or 0.0,
            "queue_depth_max": (max(s["queue_depth"])
                                if s["queue_depth"] else 0),
        }
        if self._pc is not None:
            out["pool_tokens"] = self._pc.pool_tokens()
            out["pool_pages_free"] = self._pc.pages.n_free
            out["cache_bytes"] = self._pc.nbytes()
        return out

    # -- request lifecycle ------------------------------------------------------

    def _tick_locked(self) -> bool:
        """One scheduler iteration.  Returns False when fully drained."""
        self._expire_deadlines()
        self._shed_overflow()
        self._admit()
        self.stats["queue_depth"].append(len(self.queue))
        if not any(s.req for s in self.slots):
            return bool(self.queue)
        if self.spec_k and self._spec_eligible():
            self._advance_spec()
        else:
            self._advance()
        return True

    def _spec_eligible(self) -> bool:
        """A round runs only when every active slot is in greedy decode:
        prompt fed, one token sampled, temperature 0 (the accept rule's
        exactness needs argmax on both sides)."""
        active = [s for s in self.slots if s.req is not None]
        return bool(active) and all(
            not s.to_feed and s.req.output and s.req.temperature == 0
            for s in active)

    def _reset_slot(self, b: int):
        """Restore row b of every leaf of every slot-static layer cache, the
        draft's included, to its initial state: pos = -1, and K, V (float,
        or int8 codes and their scales), an RG-LRU layer's conv history and
        state h (and their scales) = 0.  The attention kernel masks by
        slot index and relies on a fresh row (reference: ``_reset_slot``
        restores the template).  Paged, a row's pages are freed, and a
        recycled page is reset when it is allocated; its state leaves are
        reset (``PagedCache.reset_slot``); the draft's cache is slot-static
        in both modes."""
        if self._pc is not None:
            self._pc.reset_slot(b)
        caches = [] if self._pc is not None else [self.cache]
        if self.spec_k:
            caches.append(self.draft_cache)
        for cache in caches:
            for c in cache:
                for name, leaf in c.items():
                    leaf[b].fill_(-1 if name == "pos" else 0)

    def _release_slot(self, b: int):
        """Free everything a departing request holds: its pages and its
        cache row."""
        slot = self.slots[b]
        if self._pc is not None:
            self._pc.free_slot(b)
        self._reset_slot(b)
        slot.req = None
        slot.to_feed = deque()
        slot.feed = []
        slot.reg_at = None
        slot.pos = 0

    def _finish(self, req: Request, reason: str):
        req.done = True
        req.stop_reason = reason
        req.truncated = reason == "capacity"
        req.t_done = time.perf_counter()
        self.finished.append(req)

    def _finish_slot(self, b: int, reason: str):
        req = self.slots[b].req
        self._release_slot(b)
        self._finish(req, reason)

    def _preempt(self, b: int):
        """Evict slot b's request: free its pages, re-queue it for
        recompute-on-resume (its sampled output is kept; the resumed
        request re-feeds prompt + output, and may hit its own registered
        prefix)."""
        req = self.slots[b].req
        self._release_slot(b)
        req.n_preempted += 1
        self.stats["preemptions"] += 1
        # the resume re-feeds prompt + output: count it into the prefix-hit
        # denominator so re-admission hits keep the rate a true fraction
        self.stats["prompt_tokens_submitted"] += (len(req.prompt)
                                                  + len(req.output))
        self._enqueue(req)

    def _expire_deadlines(self):
        """Fail queued and running requests past their end-to-end deadline
        (``Request.deadline_s`` overriding ``SchedulerConfig.deadline_s``),
        measured from submit: a deadline survives preemption."""
        if not self._deadlines_armed:
            return
        now = time.perf_counter()

        def expired(req: Request) -> bool:
            dl = (req.deadline_s if req.deadline_s is not None
                  else self._deadline_s)
            return (dl is not None and req.t_submit is not None
                    and now - req.t_submit > dl)

        keep = [item for item in self.queue if not expired(item[2])]
        if len(keep) != len(self.queue):
            for item in self.queue:
                if expired(item[2]):
                    self.stats["deadline_expired"] += 1
                    self._finish(item[2], "deadline")
            self.queue = keep
            heapq.heapify(self.queue)
        for b, slot in enumerate(self.slots):
            if slot.req is not None and expired(slot.req):
                self.stats["deadline_expired"] += 1
                self._finish_slot(b, "deadline")

    def _shed_overflow(self):
        """Admission control: above ``ResilienceConfig.queue_high_water``
        requests in flight, shed the lowest-priority newest queued work
        (``stop_reason="shed"``)."""
        hw = self.resilience.queue_high_water
        if hw is None:
            return
        n_active = sum(1 for s in self.slots if s.req is not None)
        while self.queue and len(self.queue) + n_active > hw:
            i = max(range(len(self.queue)),
                    key=lambda j: (self.queue[j][0], self.queue[j][1]))
            _, _, req = self.queue.pop(i)
            heapq.heapify(self.queue)
            self.stats["shed"] += 1
            self._finish(req, "shed")

    def _victim(self, below: int, exclude: set[int]) -> int | None:
        """Deterministic preemption victim: among active slots with strictly
        lower priority than ``below`` (higher number), the longest-running
        (most output tokens), ties to the highest slot index."""
        best = None
        for b, slot in enumerate(self.slots):
            if b in exclude or slot.req is None:
                continue
            if self._prio(slot.req) <= below:
                continue
            key = (self._prio(slot.req), len(slot.req.output), b)
            if best is None or key > best[0]:
                best = (key, b)
        return None if best is None else best[1]

    # -- admission -------------------------------------------------------------

    def _pages_needed(self, feed_len: int, hit: int) -> int:
        """Pages a request still needs to ingest its feed and sample once
        (admission gate; decode growth beyond that is handled by the
        in-step escalation)."""
        pc = self._pc
        if not pc.has_paged:
            return 0
        return (feed_len + 1 + pc.ps - 1) // pc.ps - hit // pc.ps

    def _admit(self):
        for b, slot in enumerate(self.slots):
            if slot.req is not None or not self.queue:
                continue
            item = heapq.heappop(self.queue)
            req = item[2]
            feed = req.prompt + req.output   # resume recomputes its output
            hit = None
            if self._pc is not None:
                pc = self._pc
                hit = pc.prefix_lookup(feed)
                need = self._pages_needed(len(feed), hit.length if hit else 0)
                # admission never preempts equal-or-higher priority work and
                # never waits on it either: evict cold prefix entries, then
                # strictly-lower-priority victims, else leave it queued
                while need > pc.pages.n_free:
                    if pc.evict_one(require_free=True):
                        # eviction can invalidate the hit entry: re-resolve
                        hit = pc.prefix_lookup(feed)
                        need = self._pages_needed(len(feed),
                                                  hit.length if hit else 0)
                        continue
                    v = self._victim(self._prio(req), exclude=set())
                    if v is not None:
                        self._preempt(v)
                        continue
                    break
                if need > pc.pages.n_free:
                    if any(s.req for s in self.slots):
                        # wait for running work to free pages: the original
                        # heap key goes back, so arrival order is preserved
                        heapq.heappush(self.queue, item)
                        return
                    # sole candidate and the whole pool is still too small:
                    # this request can never fit
                    self._finish(req, "capacity")
                    continue
            self._reset_slot(b)
            slot.req = req
            slot.pos = 0
            slot.feed = feed
            slot.to_feed = deque(feed)
            slot.reg_at = None
            if self._pc is not None:
                if hit is not None:
                    self._pc.prefix_admit(b, hit)
                    slot.pos = hit.length
                    slot.to_feed = deque(feed[hit.length:])
                    self.stats["prefix_hit_tokens"] += hit.length
                self._plan_registration(slot, hit)

    def _plan_registration(self, slot: _Slot, hit):
        """Decide where this request registers its prompt prefix, past what
        the hit already covers.  A model of KV leaves alone registers every
        page-aligned level once the prompt is ingested (page references
        cost nothing).  A model with state leaves pays a snapshot slot an
        entry, so it registers one boundary — the request's ``prefix_len``
        hint, else the largest level a later identical prompt could still
        hit — and ``_schedule`` clips prefill chunks to land on it."""
        pc = self._pc
        if not pc.sharing:
            return
        L = len(slot.feed)
        if pc.has_state:
            cap = slot.req.prefix_len if slot.req.prefix_len else L - 1
            reg = (min(cap, L) // pc.ps) * pc.ps
        else:
            reg = (L // pc.ps) * pc.ps
        covered = hit.length if hit else 0
        if reg > covered and reg > slot.pos:
            slot.reg_at = reg

    def _register(self, b: int, slot: _Slot):
        pc = self._pc
        if pc.has_state:
            pc.register_prefix(b, slot.feed, slot.reg_at)
        else:
            pc.register_levels(b, slot.feed, slot.reg_at)
        slot.reg_at = None

    # -- scheduling ------------------------------------------------------------

    def _schedule(self) -> np.ndarray:
        """Token-budget pass: decodes first (1 token each), then prefills
        split the remaining budget into ≤chunk_size chunks, visiting slots
        round-robin so a tight budget rotates starvation."""
        n = np.zeros((self.B,), np.int32)
        budget = self.token_budget
        order = [(b + self._rr) % self.B for b in range(self.B)]
        self._rr = (self._rr + 1) % self.B
        for b in order:
            slot = self.slots[b]
            if slot.req is not None and not slot.to_feed and budget > 0:
                n[b] = 1
                budget -= 1
        for b in order:
            slot = self.slots[b]
            if slot.req is None or not slot.to_feed:
                continue
            room = self.max_len - 1 - slot.pos  # leave headroom to sample
            take = min(len(slot.to_feed), self.chunk, budget, max(room, 0))
            if (slot.reg_at is not None and self._pc.has_state
                    and slot.pos < slot.reg_at):
                # land a chunk boundary on the registration point, so that
                # the state snapshot is that of the registered tokens
                take = min(take, slot.reg_at - slot.pos)
            n[b] = take
            budget -= take
        return n

    def _alloc(self, n: np.ndarray) -> list:
        """Allocate pool pages for every scheduled row's write window,
        escalating on a dry pool: evict cold prefix entries → preempt a
        strictly-lower-priority victim → shrink the prefill take → as a
        last resort preempt the row itself (or capacity-finish it when it
        is the only active request and the empty pool still cannot hold
        it).  Returns per-slot (fresh, triples) plans."""
        pc = self._pc
        plans = [([], []) for _ in range(self.B)]
        allocated: set[int] = set()
        for b in range(self.B):
            slot = self.slots[b]
            if slot.req is None or n[b] == 0:
                continue
            while True:
                plan = pc.plan_writes(b, slot.pos, int(n[b]))
                if plan is not None:
                    plans[b] = plan
                    allocated.add(b)
                    break
                if pc.evict_one(require_free=True):
                    continue
                v = self._victim(self._prio(slot.req), allocated | {b})
                if v is not None:
                    n[v] = 0
                    self._preempt(v)
                    continue
                take = pc.max_take(b, slot.pos)
                if slot.to_feed and take > 0:
                    n[b] = min(int(n[b]), take)
                    continue
                if sum(1 for s in self.slots if s.req is not None) == 1:
                    # the whole pool is free for this one request and its
                    # next token still does not fit: genuine capacity end
                    self._finish_slot(b, "capacity")
                else:
                    self._preempt(b)
                n[b] = 0
                break
        return plans

    def _pack_plans(self, plans: list, g: int) -> tuple[int, int]:
        """Write the step's page operands into the host buffer: the first
        ``g`` logical pages of every row's table, fresh page ids (padding:
        the sink page) and write-window (row, logical, physical) triples
        (padding: physical = the sink).  Returns the buckets (F, M)."""
        pc, host, offs = self._pc, self._host_np, self._offs
        fresh = [p for f, _ in plans for p in f]
        triples = [t for _, ts in plans for t in ts]
        F = _bucket(max(len(fresh), 1))
        M = _bucket(max(len(triples), 1))
        assert M <= self._mmax, (M, self._mmax)
        o = offs["table"]
        host[o:o + self.B * g] = pc.tables[:, :g].ravel()
        o = offs["fresh"]
        host[o:o + F] = pc.n_pages
        host[o:o + len(fresh)] = fresh
        for i, name in enumerate(("rows", "lps", "phys")):
            o = offs[name]
            host[o:o + M] = pc.n_pages if name == "phys" else 0
            host[o:o + len(triples)] = [t[i] for t in triples]
        return F, M

    # -- the step ----------------------------------------------------------------

    def _views(self, C: int, buf=None):
        """(tokens (B, C), steps (B,), n_tokens (B,), budget (B,)) of the
        static inputs on the device, or views of ``buf`` (the pinned host
        buffer's numpy view) laid out alike."""
        B, off = self.B, self.B * self._cmax
        d = self._inputs if buf is None else buf
        return (d[:B * C].reshape(B, C), d[off:off + B],
                d[off + B:off + 2 * B], d[off + 2 * B:off + 3 * B])

    def _device_step(self, key: tuple) -> torch.Tensor:
        """The step at bucket ``key`` on the static inputs → its output:
        logits (B, 1, V) of a chunk (C, kv), or a round's token ids
        (``"spec"``, kv: ``_spec_round``); paged, around the page
        operands."""
        C, kv = key[:2]
        if C == "spec":
            def inner(cache):
                return self._spec_round(cache, kv)
        else:
            tokens, steps, n, _ = self._views(C)

            def inner(cache):
                logits, _ = self._step(self.params, cache, tokens, steps, n,
                                       kv_len=kv)
                if self.spec_k:
                    # keep the draft's cache in step: the same chunk
                    # through the draft
                    self._step(self.draft_params, self.draft_cache, tokens,
                               steps, n, kv_len=kv)
                return logits
        if self._pc is None:
            return inner(self.cache)
        F, M = key[2:]
        d, o = self._inputs, self._offs
        g = self._pc.gather_pages(kv)
        return self._pc.step(
            inner, d[o["table"]:o["table"] + self.B * g],
            d[o["fresh"]:o["fresh"] + F], d[o["rows"]:o["rows"] + M],
            d[o["lps"]:o["lps"] + M], d[o["phys"]:o["phys"] + M])

    def _spec_round(self, cache: list, kv: int) -> torch.Tensor:
        """One draft-verify round on the static inputs (``_views``: current
        token ``tokens[:, 0]``, positions ``steps``, live flags in
        ``n_tokens``, token budgets), over the target cache ``cache`` (the
        slot-static cache or the paged view) and the draft's cache, every
        chunk at kv bucket ``kv``.  The reference's ``_make_spec_round``:

          draft    k C=1 steps of the draft model → d_1..d_k (greedy)
          verify   one all-logits chunk of the full model over
                   [t0, d_1..d_k, pad] (width Cv = bucket(k + 1)): column
                   i's argmax g_i is what plain decoding samples after
                   t0..d_i
          accept   n_acc = the longest prefix with d_{i+1} = g_i; the row
                   commits n_comm = min(n_acc + 1, budget) tokens (the
                   accepted drafts and the bonus g_{n_acc})
          commit   the verify's cache rolled back to n_comm tokens, and a
                   draft resync chunk over the same columns at n_tokens =
                   n_comm

        The reference drafts on a copy of the draft's cache that it throws
        away, and only the resync writes the kept one.  Here every chunk
        writes in place, so the draft's window and its state leaves (an
        RG-LRU layer's ``conv`` and ``h``, which k draft steps move k
        tokens on) are saved before the draft steps and restored before
        the resync; the verify collects its RG-LRU layers' per-token states
        into ``saved`` and its rollback takes the state after n_comm tokens
        from them.  Both caches end bit for bit as the reference leaves
        them.  Returns the round's token ids (B, k + Cv + 2) int64: drafts,
        the verify's greedy tokens, n_acc and n_comm."""
        model, k, Cv, step = self.model, self.spec_k, self._cv, self._step
        tokens, steps, live, budget = self._views(1)
        cur = tokens[:, 0]
        dsaved = model.cache_window(self.draft_cache, steps, Cv)
        dstate = model.save_state(self.draft_cache)
        tok, drafts = cur, []
        for i in range(k):
            logits, _ = step(self.draft_params, self.draft_cache,
                             tok[:, None], steps + i, live, kv_len=kv)
            tok = torch.argmax(logits[:, 0], dim=-1)
            drafts.append(tok)
        draft = torch.stack(drafts, dim=1)                       # (B, k)
        vt = torch.cat([tokens, draft,
                        draft.new_zeros((self.B, Cv - k - 1))], dim=1)
        saved = model.cache_window(cache, steps, Cv)
        logits, _ = step(self.params, cache, vt, steps, live * (k + 1),
                         kv_len=kv, all_logits=True, collect_states=saved)
        greedy = torch.argmax(logits, dim=-1)                    # (B, Cv)
        miss = draft != greedy[:, :k]
        n_acc = torch.where(miss.any(dim=1),
                            torch.argmax(miss.to(torch.int32), dim=1),
                            torch.full_like(cur, k))
        n_comm = torch.minimum(n_acc + 1, budget) * live
        model.rollback_cache(cache, saved, steps, n_comm)
        model.restore_cache(self.draft_cache, dsaved, dstate, steps)
        step(self.draft_params, self.draft_cache, vt, steps, n_comm,
             kv_len=kv)
        return torch.cat([draft, greedy, n_acc[:, None], n_comm[:, None]],
                         dim=1)

    def _dead_inputs(self) -> None:
        """Static inputs of a step that changes no state: every row dead,
        every table entry the zero page, every fresh page and triple the
        sink."""
        self._inputs.zero_()
        if self._pc is not None:
            o = self._offs
            self._inputs[o["fresh"]:o["rows"]].fill_(self._pc.n_pages)
            self._inputs[o["phys"]:].fill_(self._pc.n_pages)

    def _capture(self, key: tuple) -> None:
        """Capture the step at bucket ``key`` as a CUDA graph.  Warm-up (the
        first launch builds the kernels, cuBLAS makes its handles: neither
        may happen under capture) runs eagerly on the capture stream;
        warm-up and capture see every row dead and every page write pointed
        at the sink (``_dead_inputs``), so neither changes a cache or a
        page, and their launches are not counted.  A dead row's int8
        recurrent state is packed again all the same, which can move a code
        or a scale (packing is not idempotent), so the warm-up's state
        writes are undone: the captured engine's states then follow the
        eager one's bit for bit."""
        t0 = time.perf_counter()
        self._dead_inputs()
        caches = [self.cache] + ([self.draft_cache] if self.spec_k else [])
        states = [self.model.save_state(c) for c in caches]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self._pool)
        # warm up on the capture stream, which every graph of the process
        # shares: cuBLAS keeps a workspace for each stream it has run on
        main = torch.cuda.current_stream(self.device)
        side = capture.capture_stream
        side.wait_stream(main)
        with (torch.cuda.stream(side), structures.activations(self.act_mode),
              kops.launches_apart()):
            self._device_step(key)
        main.wait_stream(side)
        for cache, state in zip(caches, states):
            for c, st in zip(cache, state):
                for name, leaf in st.items():
                    c[name].copy_(leaf)
        # free the graphs of dropped engines now: a garbage collection under
        # the capture would destroy them there, an unsafe call that
        # invalidates the capture (torch.cuda.graph collects first only
        # with torch.compiler.config.force_cudagraph_gc)
        gc.collect()
        try:
            with (structures.activations(self.act_mode),
                  kops.launches_apart() as made, capture):
                out = self._device_step(key)
        except RuntimeError as exc:
            where = ("spec round" if key[0] == "spec" else f"C={key[0]}")
            where += f", kv_len={key[1]}"
            if len(key) > 2:
                where += f", F={key[2]}, M={key[3]}"
            raise RuntimeError(
                f"capturing the engine's step as a CUDA graph failed at "
                f"bucket {where}") from exc
        self._graphs[key] = _Graph(graph, out, made)
        self.stats["graphs"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def _run_step(self, key: tuple) -> torch.Tensor:
        """The step on the static inputs → its output (``_device_step``): a
        replay of the bucket's graph, or the step run eagerly."""
        if self._graphs is None:
            with structures.activations(self.act_mode):
                return self._device_step(key)
        g = self._graphs[key]
        g.graph.replay()
        kops.add_launches(g.launches)
        return g.out

    def _advance(self):
        n = self._schedule()
        plans = self._alloc(n) if self._pc is not None else None
        if not n.any():  # every active slot is out of cache headroom
            for b, slot in enumerate(self.slots):
                if slot.req is not None:
                    self._finish_slot(b, "capacity")
            return
        B, C = self.B, _bucket(int(n.max()))
        tokens, steps, n_host, _ = self._views(C, self._host_np)
        tokens[:] = 0
        steps[:] = 0
        n_host[:] = n
        sampling = [False] * B
        prompt_toks = decode_toks = need = 0
        for b, slot in enumerate(self.slots):
            if slot.req is None or n[b] == 0:
                continue
            steps[b] = slot.pos
            need = max(need, slot.pos + int(n[b]))
            if slot.to_feed:
                prompt_toks += int(n[b])
                for i in range(n[b]):
                    tokens[b, i] = slot.to_feed.popleft()
                sampling[b] = len(slot.to_feed) == 0  # chunk holds prompt end
            else:
                decode_toks += 1
                tokens[b, 0] = slot.req.output[-1]
                sampling[b] = True
        if need > self.max_len:       # the device step does not check
            raise ValueError(f"position {need - 1} exceeds the cache's "
                             f"{self.max_len} slots")
        key = (C, kv_bucket(need, self.max_len))
        if self._pc is not None:
            key += self._pack_plans(plans, self._pc.gather_pages(key[1]))
        if self._graphs is not None and key not in self._graphs:
            self._capture(key)        # its time is kept out of the step's
        t0 = time.perf_counter()
        self._inputs.copy_(self._host, non_blocking=True)
        logits = self._run_step(key)
        # logits (B, 1, V): the head ran on each row's last live column
        # only; read before the next replay (graphs share one pool)
        temps = [slot.req.temperature if sampling[b] else 0.0
                 for b, slot in enumerate(self.slots)]
        if any(t > 0 for t in temps):
            nxt = sample_tokens(logits[:, 0], torch.tensor(temps), self._gen)
        else:
            nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = nxt.cpu().numpy()   # syncs
        dt = time.perf_counter() - t0
        self.stats["steps"] += 1
        self.stats["prefill_tokens"] += prompt_toks
        self.stats["decode_tokens"] += decode_toks
        self.stats["step_s"].append(dt)
        if prompt_toks == 0 and decode_toks > 0:
            self.stats["decode_step_s"].append(dt)
        total = prompt_toks + decode_toks
        self.stats["prefill_time"] += dt * prompt_toks / total
        self.stats["decode_time"] += dt * decode_toks / total
        for b, slot in enumerate(self.slots):
            if slot.req is None or n[b] == 0:
                continue
            slot.pos += int(n[b])
            if slot.reg_at is not None and slot.pos >= slot.reg_at:
                self._register(b, slot)
            if not sampling[b]:
                continue
            req = slot.req
            self._emit(req, int(nxt[b]))
            if (len(req.output) >= req.max_new_tokens
                    or slot.pos >= self.max_len - 1):
                self._finish_slot(
                    b, "length" if len(req.output) >= req.max_new_tokens
                    else "capacity")

    def _advance_spec(self):
        """One draft-verify round (``_spec_round``) for every active slot,
        each in greedy decode at cache length ``pos`` with its last output
        not yet fed.  A row's budget clamps what it may commit to its
        request's remaining tokens and its cache headroom.

        Paged, each live row's write window (min(k + 1, budget) tokens) is
        allocated first (``_alloc_spec``); when the pool cannot hold one,
        the iteration runs the plain step instead, which can shrink to one
        token or preempt.  After the commit, pages wholly past a row's new
        length return to the pool: the round already rewound their
        contents in the view, so nothing stale is scattered."""
        k, Cv = self.spec_k, self._cv
        tokens, steps, live, budget = self._views(1, self._host_np)
        for a in (tokens, steps, live, budget):
            a[:] = 0
        for b, slot in enumerate(self.slots):
            if slot.req is not None:
                req = slot.req
                tokens[b, 0] = req.output[-1]
                steps[b] = slot.pos
                live[b] = 1
                budget[b] = min(req.max_new_tokens - len(req.output),
                                self.max_len - 1 - slot.pos)
        plans = None
        if self._pc is not None:
            plans = self._alloc_spec(live, steps, budget)
            if plans is None:
                self._advance()       # pool pressure: the plain path
                return
        # the verify's columns reach steps + k; past the cache they are
        # never committed and write the spare slot (layers.ragged)
        need = int((steps + k + 1)[live > 0].max())
        key = ("spec", kv_bucket(need, self.max_len))
        if self._pc is not None:
            key += self._pack_plans(plans, self._pc.gather_pages(key[1]))
        if self._graphs is not None and key not in self._graphs:
            self._capture(key)
        t0 = time.perf_counter()
        self._inputs.copy_(self._host, non_blocking=True)
        out = self._run_step(key).cpu().numpy()       # syncs: one copy
        dt = time.perf_counter() - t0
        draft, greedy = out[:, :k], out[:, k:k + Cv]
        n_acc, n_comm = out[:, k + Cv], out[:, k + Cv + 1]
        on = live > 0
        emitted = int(n_comm[on].sum())
        s = self.stats
        s["steps"] += 1
        s["decode_tokens"] += emitted
        s["decode_time"] += dt
        s["step_s"].append(dt)
        s["decode_step_s"].append(dt)
        s["spec_rounds"] += 1
        s["spec_drafted"] += k * int(on.sum())
        s["spec_accepted"] += int(n_acc[on].sum())
        s["spec_emitted"] += emitted
        for b, slot in enumerate(self.slots):
            if slot.req is None or not on[b]:
                continue
            req, n = slot.req, int(n_comm[b])
            # the accepted drafts, and the verifier's token at the first
            # miss when the budget leaves room for it
            toks = [int(t) for t in draft[b, :min(n, int(n_acc[b]))]]
            if n == int(n_acc[b]) + 1:
                toks.append(int(greedy[b, n_acc[b]]))
            for t in toks:
                self._emit(req, t)
            slot.pos += n
            if self._pc is not None:
                self._pc.free_beyond(b, slot.pos)
            if (len(req.output) >= req.max_new_tokens
                    or slot.pos >= self.max_len - 1):
                self._finish_slot(
                    b, "length" if len(req.output) >= req.max_new_tokens
                    else "capacity")

    def _alloc_spec(self, live, steps, budget) -> list | None:
        """Allocate each live row's round window, escalating as ``_alloc``
        does (evict cold prefix entries, then preempt a strictly
        lower-priority victim, whose row turns dead).  Returns the plans,
        or None after rolling back every allocation made here when the
        pool cannot hold some window (the caller runs the plain step)."""
        pc = self._pc
        plans = [([], []) for _ in range(self.B)]
        allocated: set[int] = set()
        for b in range(self.B):
            if not live[b]:
                continue
            window = min(self.spec_k + 1, int(budget[b]))
            while True:
                plan = pc.plan_writes(b, int(steps[b]), window)
                if plan is not None:
                    plans[b] = plan
                    allocated.add(b)
                    break
                if pc.evict_one(require_free=True):
                    continue
                v = self._victim(self._prio(self.slots[b].req),
                                 allocated | {b})
                if v is not None:
                    self._preempt(v)
                    live[v] = 0
                    continue
                for ob in allocated:   # roll back: never-reset fresh pages
                    for p in plans[ob][0]:
                        pc.pages.deref(p)
                        pc.tables[ob, np.where(pc.tables[ob] == p)[0]] = 0
                return None
        return plans

    def _emit(self, req: Request, tok: int):
        if not req.output:
            req.t_first = time.perf_counter()
        req.output.append(tok)
