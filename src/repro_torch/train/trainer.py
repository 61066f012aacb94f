"""Fault-tolerant training loop (counterpart of ``repro/train/trainer.py``).

``make_train_step`` builds ``step(params, opt_state, batch) -> (params,
opt_state, metrics)``: loss and gradients (``torch.autograd.grad`` through
the kernels' autograd Functions) → optional microbatch gradient
accumulation (fp32 sums) → the optimizer's in-place update with the
**NaN/overflow guard** (a non-finite loss or gradient norm skips the update
and still counts the step, so the data pipeline stays aligned).  Training
runs on float params, as the reference does: quantized params raise.

``Trainer`` runs the step as the reference's ``Trainer(jit=True)`` does:
compiled.  Here that is a CUDA graph of the whole step — forward with
remat, ``torch.autograd.grad``, microbatch accumulation and the optimizer —
captured once after one eager warm-up step on the capture stream (which
builds the kernels) and replayed every later step, with the batch copied into a
static device buffer first.  ``jit=False``, and every run on the CPU, runs
the same step eagerly.  A capture that fails raises; a batch of another
shape raises rather than re-capturing.

It adds the operational layer:
  * checkpoint/restart: resumes from the latest manifest (params, optimizer
    state, step) — the counter-indexed data pipeline replays nothing;
  * preemption hook: SIGTERM makes the loop checkpoint and stop;
  * straggler watchdog: an EMA of step time, logging any step longer than
    ``watchdog_x`` × the EMA;
  * asynchronous checkpoint writes off the critical path.
"""

from __future__ import annotations

import gc
import signal
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.kernels import ops as kops
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
                 jit: bool = True, log_every: int = 10,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.optimizer = optimizer
        self.data = data
        self.step_fn = make_train_step(model, optimizer, microbatch=microbatch)
        # the compiled step: a CUDA graph of step_fn, on the card only
        self.jit = jit and model.device.type == "cuda"
        self._graph = None        # (graph, metrics, launches, params, state)
        self._graph_ctx = None    # its capture, set up by the warm-up step
        self._tokens = None       # the static device batch
        self.stats = {"step_s": [], "graphs": 0, "capture_s": 0.0}
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

    def _capture(self, params, opt_state, batch) -> None:
        t0 = time.perf_counter()
        graph = self._graph_ctx.cuda_graph
        gc.collect()    # no dropped graph freed under the capture (Engine)
        try:
            with kops.launches_apart() as made, self._graph_ctx:
                _, _, metrics = self.step_fn(params, opt_state, batch)
        except RuntimeError as exc:
            raise RuntimeError("capturing the training step as a CUDA graph "
                               f"failed (batch {tuple(self._tokens.shape)})"
                               ) from exc
        self._graph = (graph, metrics, made, params, opt_state)
        self.stats["graphs"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0

    def train_step(self, params, opt_state, batch):
        """One step → (params, opt_state, metrics): the batch's tokens go
        into the static device buffer, then the step runs — eagerly, or
        with ``jit`` on the card through its graph: the first step runs
        eagerly on the capture stream (the warm-up), the second captures
        the graph, and that and every later step replay it.  Params and state
        are updated in place; a replay's metrics are the graph's own
        tensors, rewritten by the next replay."""
        tokens = torch.as_tensor(batch["tokens"])
        if self._tokens is None or self._tokens.shape != tokens.shape:
            if self._graph is not None:
                raise ValueError(
                    "the captured training step takes batches of shape "
                    f"{tuple(self._tokens.shape)}, got {tuple(tokens.shape)}")
            self._tokens = torch.empty(tokens.shape, dtype=tokens.dtype,
                                       device=self.model.device)
        self._tokens.copy_(tokens, non_blocking=True)
        batch = {**batch, "tokens": self._tokens}
        if not self.jit:
            return self.step_fn(params, opt_state, batch)
        if self._graph_ctx is None:
            # the warm-up step, on the capture stream, which every graph of
            # the process shares: cuBLAS keeps a workspace for each stream
            self._graph_ctx = torch.cuda.graph(torch.cuda.CUDAGraph())
            main = torch.cuda.current_stream(self.model.device)
            side = self._graph_ctx.capture_stream
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self.step_fn(params, opt_state, batch)
            main.wait_stream(side)
            return out
        if self._graph is None:
            self._capture(params, opt_state, batch)
        graph, metrics, made, p0, s0 = self._graph
        if params is not p0 or opt_state is not s0:
            raise ValueError("the captured training step updates the params "
                             "and optimizer state it was captured with")
        graph.replay()
        kops.add_launches(made)
        return params, opt_state, metrics

    def run(self, n_steps: int, seed: int = 0) -> dict[str, Any]:
        params = self.model.init(seed)
        opt_state = self.optimizer.init(params)
        self._graph = self._graph_ctx = None
        start = 0
        if self.ckpt is not None:
            restored, step = self.ckpt.restore_latest(
                {"params": params, "opt": opt_state})
            if restored is not None:
                # into the tensors the step updates (and a graph captures)
                with torch.no_grad():
                    for dst, src in zip(leaves((params, opt_state)),
                                        leaves((restored["params"],
                                                restored["opt"]))):
                        dst.copy_(src)
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
                capture_s = self.stats["capture_s"]
                params, opt_state, metrics = self.train_step(params, opt_state,
                                                             batch)
                loss = float(metrics["loss"])     # waits for the device
                dt = (time.perf_counter() - t0
                      - (self.stats["capture_s"] - capture_s))
                self.stats["step_s"].append(dt)
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
