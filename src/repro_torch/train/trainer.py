"""The training loop of the JAX package's ``repro.train.trainer``:
gradient accumulation, auto-resume, periodic and final checkpoints, a
straggler watchdog.

The step (:func:`make_train_step`) is eager autograd: the loss's
gradient with respect to every parameter leaf, the global norm, then the
optimizer's in-place update.  The loop adds:

  * **auto-resume**: ``try_resume`` collects torn writes and restores the
    newest readable checkpoint onto the parameters' devices;
  * **periodic and final checkpoints**, atomically published;
  * **straggler watchdog**: a step slower than ``straggler_factor`` × the
    running median is flagged and reported to a callback.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import Optimizer
from repro_torch.tree import build, leaves, tree_map


@dataclasses.dataclass
class TrainerConfig:
    ckpt_dir: str
    ckpt_every: int = 100
    log_every: int = 10
    straggler_factor: float = 3.0
    grad_accum: int = 1


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``; the gradient
    of a leaf the loss does not use is zeros.  ``params`` is read through
    detached aliases, so its tensors keep their flags and gain no
    ``.grad``."""
    paths, tensors = zip(*leaves(params))
    with torch.enable_grad():
        alias = [t.detach().requires_grad_() for t in tensors]
        loss = loss_fn(build(zip(paths, alias)), batch)
        grads = torch.autograd.grad(loss, alias, allow_unused=True, materialize_grads=True)
    return loss.detach(), build(zip(paths, grads))


def make_train_step(loss_fn: Callable, optimizer: Optimizer, grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and state are updated in place.

    With ``grad_accum > 1`` the batch's leading axis is [accum, micro, ...]
    and the gradients (and loss) are summed in f32 over the micro-batches,
    then divided.  ``grad_norm`` is the f32 L2 norm over every leaf.
    """

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(batch.values())).device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             params)
            for i in range(grad_accum):
                l, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in batch.items()})
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for _, g in leaves(grads)))
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step


class StragglerWatchdog:
    """Flags steps whose wall time exceeds factor × the running median."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.flagged: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.flagged.append((step, dt, med))
                slow = True
        self.times.append(dt)
        return slow


class Trainer:
    """Trains ``params`` (a tree of tensors) with ``optimizer`` on
    ``loss_fn(params, batch)``.  With ``donate`` (the default) it trains a
    copy, so the caller's tensors survive, as in the reference; with
    ``donate=False`` it trains the caller's tensors in place (the step
    always updates in place; no copy is made)."""

    def __init__(self, cfg: TrainerConfig, loss_fn: Callable, optimizer: Optimizer, params, *,
                 donate: bool = True, on_straggler: Callable[[int, float], None] | None = None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.params = tree_map(torch.clone, params) if donate else params
        self.opt_state = optimizer.init(self.params)
        self.step_num = 0
        self.watchdog = StragglerWatchdog(cfg.straggler_factor)
        self.on_straggler = on_straggler
        self._step = make_train_step(loss_fn, optimizer, cfg.grad_accum)
        self.history: list[dict] = []

    # -- fault tolerance ---------------------------------------------------
    def _state(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def try_resume(self) -> bool:
        ckpt.gc_tmp(self.cfg.ckpt_dir)
        like = self._state()
        got = ckpt.restore_latest(self.cfg.ckpt_dir, like)
        if got is None:
            return False
        state, step = got
        state = ckpt.place(state, tree_map(lambda t: t.device, like))
        self.params, self.opt_state = state["params"], state["opt"]
        self.step_num = step
        return True

    def checkpoint(self):
        ckpt.save(self.cfg.ckpt_dir, self.step_num, self._state())

    # -- the loop ------------------------------------------------------------
    def run(self, batches, n_steps: int, log: Callable[[str], None] = print):
        for _ in range(n_steps):
            batch = next(batches)
            t0 = time.perf_counter()
            self.params, self.opt_state, m = self._step(self.params, self.opt_state, batch)
            loss = float(m["loss"])  # waits for the device: honest step timing
            dt = time.perf_counter() - t0
            self.step_num += 1
            if self.watchdog.observe(self.step_num, dt) and self.on_straggler:
                self.on_straggler(self.step_num, dt)
            self.history.append({"step": self.step_num, "loss": loss, "dt": dt})
            if self.step_num % self.cfg.log_every == 0:
                log(f"step {self.step_num:6d}  loss {loss:.4f}  "
                    f"gnorm {float(m['grad_norm']):.3f}  {dt*1e3:.1f} ms")
            if self.step_num % self.cfg.ckpt_every == 0:
                self.checkpoint()
        self.checkpoint()
        return self.history
