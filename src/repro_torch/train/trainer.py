"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: loss and gradients (``torch.autograd.grad`` through
the kernels' autograd Functions) → optional microbatch gradient
accumulation (fp32 sums) → the optimizer's in-place update with the
**NaN/overflow guard** (a non-finite loss or gradient norm skips the update
and still counts the step, so the data pipeline stays aligned).  Training
runs on float params, as the reference does: quantized params raise.

``Trainer`` adds the operational layer:
  * checkpoint/restart: resumes from the latest manifest (params, optimizer
    state, step) — the counter-indexed data pipeline replays nothing;
  * preemption hook: SIGTERM makes the loop checkpoint and stop;
  * straggler watchdog: an EMA of step time, logging any step longer than
    ``watchdog_x`` × the EMA;
  * asynchronous checkpoint writes off the critical path.
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.optim import Optimizer
from repro_torch.quant import qarray as qt
from repro_torch.train.loss import make_loss_fn
from repro_torch.tree import leaves, tree_map, unflatten


def make_train_step(model, optimizer: Optimizer, *, microbatch: int = 0,
                    loss_fn: Callable | None = None):
    """→ ``step(params, opt_state, batch)``; params and optimizer state are
    updated in place and returned.  ``microbatch > 1`` splits the batch
    into that many accumulation chunks."""
    loss_fn = loss_fn or make_loss_fn(model)

    def grads_and_metrics(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return (unflatten(params, grads),
                {k: v.detach() for k, v in metrics.items()})

    def compute_grads(params, batch):
        if not (microbatch and microbatch > 1):
            return grads_and_metrics(params, batch)
        tokens = torch.as_tensor(batch["tokens"])
        if tokens.shape[0] % microbatch:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{microbatch} microbatches")
        g_acc = m_acc = None
        for mb in tokens.chunk(microbatch):
            g, m = grads_and_metrics(params, {**batch, "tokens": mb})
            g = tree_map(lambda a: a.float(), g)
            g_acc = g if g_acc is None else tree_map(torch.add, g_acc, g)
            m_acc = m if m_acc is None else tree_map(torch.add, m_acc, m)
        inv = 1.0 / microbatch
        return (tree_map(lambda a: a * inv, g_acc),
                tree_map(lambda a: a * inv, m_acc))

    def step(params, opt_state, batch):
        if qt.tree_is_quantized(params):
            raise NotImplementedError(
                "training takes float params, as the reference's trainer "
                "does; quantize after training (LM.quantize_params)")
        grads, metrics = compute_grads(params, batch)
        params, opt_state, opt_metrics = optimizer.update(
            grads, opt_state, params, loss=metrics["loss"])
        return params, opt_state, {**metrics, **opt_metrics}

    return step


class Trainer:
    def __init__(self, model, optimizer: Optimizer, data, *,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 50,
                 microbatch: int = 0, watchdog_x: float = 3.0,
                 log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.step_fn = make_train_step(model, optimizer, microbatch=microbatch)
        self.ckpt = (CheckpointManager(checkpoint_dir)
                     if checkpoint_dir else None)
        self.checkpoint_every = checkpoint_every
        self.watchdog_x = watchdog_x
        self.log_every = log_every
        self.log = log_fn
        self._preempted = False

    def _install_preemption_hook(self):
        """SIGTERM sets a flag the loop reads; returns the previous handler
        (None off the main thread, where no handler can be installed)."""
        def handler(signum, frame):
            self._preempted = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None

    def run(self, n_steps: int, seed: int = 0) -> dict[str, Any]:
        params = self.model.init(seed)
        opt_state = self.optimizer.init(params)
        start = 0
        if self.ckpt is not None:
            restored, step = self.ckpt.restore_latest(
                {"params": params, "opt": opt_state})
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                start = step + 1
                self.log(f"[trainer] resumed from step {step}")
        previous = self._install_preemption_hook()
        ema = None
        history = []
        metrics: dict = {}
        try:
            for step in range(start, n_steps):
                batch = self.data.batch(step)
                t0 = time.perf_counter()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])     # waits for the device
                dt = time.perf_counter() - t0
                ema = dt if ema is None else 0.9 * ema + 0.1 * dt
                if dt > self.watchdog_x * ema and step > start + 3:
                    self.log(f"[watchdog] step {step} took {dt:.2f}s "
                             f"({dt / ema:.1f}× EMA) — straggler suspected")
                if step % self.log_every == 0:
                    self.log(f"[trainer] step {step} loss {loss:.4f} acc "
                             f"{float(metrics.get('acc', 0)):.3f} "
                             f"{dt * 1e3:.0f}ms")
                history.append(loss)
                if self.ckpt is not None and (
                        (step + 1) % self.checkpoint_every == 0
                        or self._preempted or step + 1 == n_steps):
                    self.ckpt.save(step, {"params": params, "opt": opt_state})
                if self._preempted:
                    self.log(f"[trainer] preempted at step {step}; "
                             "checkpointed")
                    break
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            if self.ckpt is not None:
                self.ckpt.wait()
        return {"params": params, "opt_state": opt_state,
                "history": history, "final_metrics": metrics}
