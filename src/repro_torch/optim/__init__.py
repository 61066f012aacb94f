"""Optimizers and learning-rate schedules (counterpart of ``repro/optim``)."""

from repro_torch.optim.adamw import Optimizer, adamw, global_norm  # noqa: F401
from repro_torch.optim.schedules import (  # noqa: F401
    constant_schedule, cosine_schedule, linear_schedule)
