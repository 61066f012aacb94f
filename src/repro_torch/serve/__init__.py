"""Serving layer of the port: the chunked-prefill continuous-batching engine
over a slot-static or paged cache, with Engine API v2."""

from repro_torch.serve.config import (EngineConfig, MemoryConfig,  # noqa: F401
                                      ResilienceConfig, SamplingParams,
                                      SchedulerConfig, SpeculativeConfig)
from repro_torch.serve.engine import Engine, Request  # noqa: F401
from repro_torch.serve.paged import PagedCache  # noqa: F401
