"""AdamW (counterpart of ``repro/optim/adamw.py``): decoupled weight decay
on tensors with ``ndim >= 2`` only, global-norm clipping, m/v in fp32 by
default, and the parameters updated in fp32 and cast back to their type.

The state is a plain dict ``{"m": tree, "v": tree, "count": int32 0-d}``
congruent with the params, so it checkpoints like them.  Unlike the
reference's pure update, ``update`` writes m, v and the params **in place**
(the old values are not kept: for smollm-135m that saves a second copy of
0.16 GB of bf16 params and 1.1 GB of fp32 m + v).  That is why the
trainer's NaN/overflow guard lives here: a step whose loss or gradient norm
is not finite leaves params, m and v untouched and still counts.
``grad_transform`` (gradient compression) and ``sgdm`` are not ported yet
(ROADMAP A16)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.tree import leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves(tree)))


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], dict]
    update: Callable[..., tuple[Any, dict, dict]]


def adamw(schedule: Callable[[torch.Tensor], torch.Tensor], *,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, clip_norm: float = 1.0,
          state_dtype=torch.float32) -> Optimizer:
    def init(params) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(grads, state: dict, params, *, loss=None):
        """One step in place → (params, state, metrics).  ``loss``: the
        step's loss; it and the gradient norm must be finite, or the update
        is skipped (``metrics["skipped"]`` 1.0)."""
        count = state["count"] + 1
        gnorm = global_norm(grads)
        lr = schedule(count)
        finite = torch.isfinite(gnorm)
        if loss is not None:
            finite = finite & torch.isfinite(loss)
        good = bool(finite)                       # one host sync per step
        if good:
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            t = count.to(torch.float32)
            bc1, bc2, lr_d = (a.to(gnorm.device) for a in
                              (1.0 - b1 ** t, 1.0 - b2 ** t, lr))
            for p, g, m, v in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"])):
                g32 = g.float() * scale
                m32 = m.float().mul_(b1).add_(g32, alpha=1 - b1)
                v32 = v.float().mul_(b2).addcmul_(g32, g32, value=1 - b2)
                step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
                if p.ndim >= 2:      # decay matrices only (norms excluded)
                    step = step + weight_decay * p.float()
                p.copy_((p.float() - lr_d * step).to(p.dtype))
                m.copy_(m32)
                v.copy_(v32)
        state["count"] = count
        metrics = {"grad_norm": gnorm, "lr": lr,
                   "skipped": torch.tensor(0.0 if good else 1.0)}
        return params, state, metrics

    return Optimizer(init=init, update=update)
