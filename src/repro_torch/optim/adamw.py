"""AdamW (counterpart of ``repro/optim/adamw.py``): decoupled weight decay
on tensors with ``ndim >= 2`` only (or on the leaves ``update``'s
``decay`` names: the trainer passes ``LM.decay_mask``, the reference's rule
in its stacked layout), global-norm clipping, m/v in fp32 by
default, and the parameters updated in fp32 and cast back to their type.

The state is a plain dict ``{"m": tree, "v": tree, "count": int32 0-d}``
congruent with the params, so it checkpoints like them; ``count`` lies on
the params' device.  Unlike the reference's pure update, ``update`` writes
m, v, the count and the params **in place** (the old values are not kept:
for smollm-135m that saves a second copy of 0.16 GB of bf16 params and 1.1
GB of fp32 m + v), so a CUDA graph of the training step updates the
tensors it captured.  That is why the trainer's NaN/overflow guard lives
here: a step whose loss or gradient norm is not finite leaves params, m
and v bit for bit as they were and still counts.  The guard is branchless
(``torch.where`` on the new values; a multiply by 0 would keep a NaN) and
the step reads no value on the host.  The arithmetic is the reference's,
run as multi-tensor ``torch._foreach_*`` updates over groups of leaves of
one type that decay alike.  ``grad_transform`` (gradient compression) and
``sgdm`` are not ported yet (ROADMAP A10)."""

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
        device = leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    def _group(p, g, m, v, decay: bool, good, scale, lr, bc1, bc2) -> None:
        """One group of leaves (one type, decaying alike), in place."""
        g32 = torch._foreach_mul([a.float() for a in g], scale)
        m_new = torch._foreach_mul([a.float() for a in m], b1)
        torch._foreach_add_(m_new, g32, alpha=1 - b1)
        v_new = torch._foreach_mul([a.float() for a in v], b2)
        torch._foreach_addcmul_(v_new, g32, g32, value=1 - b2)
        den = torch._foreach_div(v_new, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        step = torch._foreach_div(m_new, bc1)
        torch._foreach_div_(step, den)
        p32 = [a.float() for a in p]
        if decay:
            torch._foreach_add_(step, torch._foreach_mul(p32, weight_decay))
        torch._foreach_mul_(step, lr)
        p_new = torch._foreach_sub(p32, step)
        for dst, new in zip((*p, *m, *v), (*p_new, *m_new, *v_new)):
            torch.where(good, new.to(dst.dtype), dst, out=dst)

    @torch.no_grad()
    def update(grads, state: dict, params, *, loss=None, decay=None):
        """One step in place → (params, state, metrics).  ``loss``: the
        step's loss; it and the gradient norm must be finite, or the update
        leaves params, m and v unchanged (``metrics["skipped"]`` 1.0, a
        device tensor).  ``decay``: one bool a leaf, whether it takes the
        weight decay (default: ``ndim >= 2``)."""
        state["count"].add_(1)
        count = state["count"]
        gnorm = global_norm(grads)
        lr = schedule(count)
        good = torch.isfinite(gnorm)
        if loss is not None:
            good = good & torch.isfinite(loss)
        scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        t = count.to(torch.float32)
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        groups: dict = {}
        flat = leaves(params)
        if decay is None:
            decay = [p.ndim >= 2 for p in flat]
        for p, g, m, v, d in zip(flat, leaves(grads), leaves(state["m"]),
                                 leaves(state["v"]), decay, strict=True):
            key = (p.dtype, g.dtype, m.dtype, v.dtype, bool(d))
            for lst, a in zip(groups.setdefault(key, ([], [], [], [])),
                              (p, g, m, v)):
                lst.append(a)
        for key, (p, g, m, v) in groups.items():
            _group(p, g, m, v, key[-1], good, scale, lr, bc1, bc2)
        metrics = {"grad_norm": gnorm, "lr": lr,
                   "skipped": (~good).to(torch.float32)}
        return params, state, metrics

    return Optimizer(init=init, update=update)
