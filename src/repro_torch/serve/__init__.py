"""Serving layer of the port: the chunked-prefill continuous-batching engine
(plain slot-static greedy path)."""

from repro_torch.serve.config import (EngineConfig, MemoryConfig,  # noqa: F401
                                      SamplingParams, SchedulerConfig)
from repro_torch.serve.engine import Engine, Request  # noqa: F401
