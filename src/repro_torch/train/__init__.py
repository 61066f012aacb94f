"""Training (counterpart of ``repro/train``): the loss, the train step with
microbatch accumulation and the NaN/overflow guard, and the fault-tolerant
``Trainer``."""

from repro_torch.train.loss import make_loss_fn  # noqa: F401
from repro_torch.train.trainer import Trainer, make_train_step  # noqa: F401
