"""Continuous-batching inference engine with chunked prefill — the plain
slot-static path of ``repro/serve/engine.py``, greedy or with temperature
sampling, over a float or int8 KV cache.

A fixed pool of B slots advances through one ``prefill_chunk`` per
iteration.  Each iteration the scheduler packs a mixed batch under a token
budget: slots still ingesting their prompt contribute up to ``chunk_size``
prompt tokens, slots in generation exactly one token.  The chunk width C is
bucketed to a power of two.  A finished slot is reset and recycled for the
next queued request at once.

The compiled step.  The reference runs ``jax.jit(model.prefill_chunk)``;
here, on the card, the engine captures the step as one CUDA graph per
(C bucket, kv bucket) — the kv bucket is ``flash_attention.kv_bucket`` of
the step's largest live position, which fixes the attention kernel's
launch plan — the first time the pair is seen, and replays it: the
kernels run with no Python between them.  The graphs read static device
buffers (tokens, steps, n_tokens), filled from one pinned host buffer by
one copy a step; only the sampling pass and its copy to the host stay
outside.
A capture that fails raises, naming its bucket: there is no fallback to
the eager step.  On the CPU, and with ``step_fn=`` (the reference's
override of the compiled step, run eagerly every step), the same step runs
eagerly on the same buffers.

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

Not ported yet: the paged cache (prefix sharing, preemption), speculation,
resilience (guardrail, health, watchdog, fault injection), async
``generate``, ``cancel`` and ``sla_report``, serving over a device mesh and
the legacy flat keyword arguments.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import structures
from repro_torch.kernels import ops as kops
from repro_torch.kernels.flash_attention import kv_bucket
from repro_torch.quant import qarray as qt
from repro_torch.serve.config import EngineConfig, SamplingParams


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
    priority: int = 0          # lower = more urgent
    # filled by the engine:
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    stop_reason: str | None = None  # length | capacity


@dataclasses.dataclass
class _Slot:
    req: Request | None = None
    pos: int = 0            # next absolute position to write
    to_feed: deque = dataclasses.field(default_factory=deque)  # prompt left


def _bucket(n: int) -> int:
    """Round a chunk width up to a power of two."""
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _Graph:
    """One captured step: its graph, its logits (graph memory, rewritten by
    every replay) and the kernel launches one replay makes."""
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor
    launches: dict


class Engine:
    def __init__(self, model, params, config: EngineConfig | None = None, *,
                 device=None, step_fn=None):
        """``model``: a ``repro_torch.models.LM`` on ``device`` (default
        cuda; raises without a GPU unless ``device="cpu"``).  ``step_fn``
        replaces the compiled step, ``model.prefill_chunk`` (same
        signature: device tensors and ``kv_len=``), and runs eagerly every
        step — e.g. to observe every step's logits."""
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
        self.token_budget = self.B * self.chunk   # tokens per mixed batch
        self.cache = model.init_cache(self.B, mem.max_len)
        self.slots = [_Slot() for _ in range(self.B)]
        self._rr = 0
        self.queue: list = []   # heap of (prio_key, seq, Request)
        self._seq = 0
        self._step = step_fn if step_fn is not None else model.prefill_chunk
        # (C, kv_len) -> _Graph; None: the step runs eagerly
        self._graphs = ({} if step_fn is None and dev.type == "cuda"
                        else None)
        self._pool = None                   # the graphs' shared memory pool
        # static inputs: tokens (B, C) of every C bucket share the first
        # B·C entries, then steps (B,) and n_tokens (B,)
        self._cmax = _bucket(self.chunk)
        self._host = torch.zeros((self.B * (self._cmax + 2),),
                                 dtype=torch.int64,
                                 pin_memory=dev.type == "cuda")
        self._host_np = self._host.numpy()
        self._inputs = torch.zeros_like(self._host, device=dev)
        # the sampling noise's generator
        self._gen = torch.Generator(device=dev).manual_seed(int(config.seed))
        self.finished: list[Request] = []
        self.stats = {"steps": 0, "prefill_tokens": 0, "decode_tokens": 0,
                      "prefill_time": 0.0, "decode_time": 0.0,
                      "step_s": [], "decode_step_s": [],
                      "graphs": 0, "capture_s": 0.0}
        self._lock = threading.Lock()
        self._auto_uid = 1 << 40
        self.params = (model.prestack_params(params) if config.prestack
                       else params)

    # -- public -----------------------------------------------------------------

    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError(f"request {req.uid}: empty prompt (generation "
                             "needs at least one conditioning token)")
        with self._lock:
            self._seq += 1
            heapq.heappush(self.queue, (req.priority, self._seq, req))

    def run(self, max_iters: int = 100_000) -> list[Request]:
        """Drive until queue + slots drain.  Returns completed requests."""
        n0 = len(self.finished)
        for _ in range(max_iters):
            with self._lock:
                if not self._tick_locked():
                    break
        return self.finished[n0:]

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

    def throughput(self) -> dict:
        s = self.stats
        return {"steps": s["steps"],
                "prefill_tok_s": (s["prefill_tokens"] / s["prefill_time"]
                                  if s["prefill_time"] else 0.0),
                "decode_tok_s": (s["decode_tokens"] / s["decode_time"]
                                 if s["decode_time"] else 0.0)}

    # -- internals --------------------------------------------------------------

    def _tick_locked(self) -> bool:
        """One scheduler iteration.  Returns False when fully drained."""
        self._admit()
        if not any(s.req for s in self.slots):
            return bool(self.queue)
        self._advance()
        return True

    def _reset_slot(self, b: int):
        """Restore row b of every leaf of every layer cache to its initial
        state: pos = -1, and K, V (float, or int8 codes and their scales)
        = 0.  The attention kernel masks by slot index and relies on a fresh
        row (reference: ``_reset_slot`` restores the template)."""
        for c in self.cache:
            for name, leaf in c.items():
                leaf[b].fill_(-1 if name == "pos" else 0)

    def _release_slot(self, b: int):
        slot = self.slots[b]
        self._reset_slot(b)
        slot.req = None
        slot.to_feed = deque()
        slot.pos = 0

    def _finish_slot(self, b: int, reason: str):
        req = self.slots[b].req
        self._release_slot(b)
        req.done = True
        req.stop_reason = reason
        self.finished.append(req)

    def _admit(self):
        for b, slot in enumerate(self.slots):
            if slot.req is not None or not self.queue:
                continue
            _, _, req = heapq.heappop(self.queue)
            self._reset_slot(b)
            slot.req = req
            slot.pos = 0
            slot.to_feed = deque(req.prompt + req.output)

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
            n[b] = take
            budget -= take
        return n

    def _views(self, C: int):
        """(tokens (B, C), steps (B,), n_tokens (B,)) of the static inputs."""
        B, off = self.B, self.B * self._cmax
        d = self._inputs
        return d[:B * C].view(B, C), d[off:off + B], d[off + B:]

    def _capture(self, key: tuple[int, int]) -> None:
        """Capture the step at bucket ``key`` = (C, kv_len) as a CUDA graph.
        Warm-up (the first launch builds the kernels, cuBLAS makes its
        handles: neither may happen under capture) runs eagerly on the
        capture stream; warm-up and capture see every row dead (n_tokens = 0), so
        neither changes the cache, and their launches are not counted."""
        C, kv = key
        t0 = time.perf_counter()
        self._inputs.zero_()
        args = (self.params, self.cache, *self._views(C))
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
            self._step(*args, kv_len=kv)
        main.wait_stream(side)
        try:
            with (structures.activations(self.act_mode),
                  kops.launches_apart() as made, capture):
                logits, _ = self._step(*args, kv_len=kv)
        except RuntimeError as exc:
            raise RuntimeError(
                f"capturing the engine's step as a CUDA graph failed at "
                f"bucket C={C}, kv_len={kv}") from exc
        self._graphs[key] = _Graph(graph, logits, made)
        self.stats["graphs"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def _run_step(self, key: tuple[int, int]) -> torch.Tensor:
        """The step on the static inputs → logits (B, 1, V): a replay of
        the bucket's graph, or the step run eagerly."""
        if self._graphs is None:
            with structures.activations(self.act_mode):
                logits, self.cache = self._step(
                    self.params, self.cache, *self._views(key[0]),
                    kv_len=key[1])
            return logits
        g = self._graphs[key]
        g.graph.replay()
        kops.add_launches(g.launches)
        return g.logits

    def _advance(self):
        n = self._schedule()
        if not n.any():  # every active slot is out of cache headroom
            for b, slot in enumerate(self.slots):
                if slot.req is not None:
                    self._finish_slot(b, "capacity")
            return
        B, C = self.B, _bucket(int(n.max()))
        off = B * self._cmax
        host = self._host_np
        host[:] = 0
        tokens = host[:B * C].reshape(B, C)
        steps = host[off:off + B]
        host[off + B:] = n
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
            if not sampling[b]:
                continue
            req = slot.req
            req.output.append(int(nxt[b]))
            if (len(req.output) >= req.max_new_tokens
                    or slot.pos >= self.max_len - 1):
                self._finish_slot(
                    b, "length" if len(req.output) >= req.max_new_tokens
                    else "capacity")
