"""Engine API v2 configuration (counterpart of ``repro/serve/config.py``):
grouped sub-configs instead of the flat constructor keywords.

  * ``SchedulerConfig`` — slot count, chunk size, token budget, admission
    policy (``priority`` honours ``Request.priority``; ``fifo`` is the
    arrival-order baseline) and an end-to-end deadline.
  * ``MemoryConfig``   — cache geometry: ``max_len`` per request, and the
    paged-allocator knobs (``paged``, ``pages``, ``page_size``,
    ``prefix_sharing``, ``snap_slots``) of ``serve/paged.py``.
  * ``SpeculativeConfig`` — self-speculative decoding: ``k`` draft
    tokens a round (0: off) from the model's own factors truncated to
    ``draft_rank_frac`` of the pooled rank budget.
  * ``ResilienceConfig`` — the overflow shedding bound.
  * ``quant`` — a ``QuantConfig`` override (weights and activations; the
    cache codec is a model-construction knob).

``SamplingParams`` carries the per-request sampling knobs of
``Engine.generate`` / ``generate_batch``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.quant.qarray import QuantConfig


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 32
    temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    slots: int = 4              # concurrent batch rows
    chunk_size: int = 32        # max prompt tokens one slot ingests per step
    token_budget: int | None = None   # max tokens per mixed batch (None: slots*chunk)
    policy: str = "priority"    # "priority" | "fifo" admission order
    deadline_s: float | None = None   # end-to-end per-request deadline
    #                            (submit → done, survives preemption;
    #                            Request.deadline_s overrides per request)


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    max_len: int = 512          # per-request cache capacity (tokens)
    paged: bool = False         # paged block allocator (serve/paged.py)
    page_size: int = 16         # tokens per KV page (must divide max_len)
    pages: int | None = None    # pool size in pages (None: slots*max_len/page_size + 1)
    prefix_sharing: bool = True # share page-aligned prompt prefixes (paged only)
    snap_slots: int | None = None  # state-leaf snapshot slots of prefix
    #                            entries (None: max(4, pages // 4))


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    k: int = 0                  # draft tokens per round (0 = off)
    draft_rank_frac: float = 0.5


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Failure-handling knobs.  This slice reads only ``queue_high_water``:
    above that many requests in flight, the lowest-priority newest queued
    work is shed (``stop_reason="shed"``).  The guardrail, watchdog, step
    error limit, HTTP backoff and fault plan come with the rest of
    resilience (ROADMAP A8)."""
    queue_high_water: int | None = None       # shed above this queue depth


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    speculative: SpeculativeConfig = dataclasses.field(
        default_factory=SpeculativeConfig)
    resilience: ResilienceConfig = dataclasses.field(
        default_factory=ResilienceConfig)
    # overrides the model's ``cfg.quant`` when given: weights are quantized
    # at load, and ``activations="int8"`` runs every step in W8A8 mode (a
    # cache mode is the model's own: given here, the engine refuses it)
    quant: QuantConfig | None = None
    seed: int = 0               # the sampling noise's generator
    prestack: bool = True
