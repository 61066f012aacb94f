"""Engine configuration (the part of ``repro/serve/config.py`` the plain
slot-static path reads)."""

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


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    max_len: int = 512          # per-request cache capacity (tokens)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    memory: MemoryConfig = dataclasses.field(default_factory=MemoryConfig)
    # overrides the model's ``cfg.quant`` when given: weights are quantized
    # at load, and ``activations="int8"`` runs every step in W8A8 mode (a
    # cache mode is the model's own: given here, the engine refuses it)
    quant: QuantConfig | None = None
    seed: int = 0               # the sampling noise's generator
    prestack: bool = True
