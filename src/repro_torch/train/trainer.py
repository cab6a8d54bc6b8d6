"""The training loop of the JAX package's ``repro.train.trainer``:
gradient accumulation, auto-resume, periodic and final checkpoints, a
straggler watchdog.

The step (:func:`make_train_step`) is eager autograd: the loss's
gradient with respect to every parameter leaf, the global norm, then the
optimizer's in-place update.  The parameters may be
:class:`~repro_torch.dist.sharding.Sharded` over a mesh (a training
program on several devices): each distinct tensor of a leaf is read
through its own alias, and a block's gradient is the sum of its holders'
(one a device: a copy on another device saw only the work done there,
the positions on one device share one tensor and so one gradient);
``grad_norm`` counts each block once.  For the dry run's wire count
(``dist.collectives``) the holders' sum counts as an all-reduce of the
block's gradient over every position that holds the block, and
``grad_norm``'s sum of a split leaf's per-block squares as an all-reduce
of one f32 scalar over the axes that split it.  The loop adds:

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

from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.dist.sharding import Sharded
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


def _alias(x):
    """``x`` read through detached aliases that need a gradient: one a
    distinct tensor of a :class:`Sharded`."""
    if isinstance(x, Sharded):
        return shd.map_distinct(lambda t: t.detach().requires_grad_(), x)
    return x.detach().requires_grad_()


def _inputs(x) -> list[torch.Tensor]:
    return shd.distinct(x) if isinstance(x, Sharded) else [x]


def _combined(x, grad_of: dict):
    """The gradient of leaf ``x`` (an alias) from each input's: a
    :class:`Sharded` block's is the sum of its holders' in position order,
    on the first holder's device (bf16 summed in f32, rounded once), given
    to every holder; counted as the all-reduce over the positions that hold
    the block."""
    if not isinstance(x, Sharded):
        return grad_of[id(x)]
    out = {}
    at = shd.positions_holding(x)
    for blk, held in shd.holders(x).items():
        dev = held[0].device
        grads = [grad_of[id(t)].to(dev) for t in held]
        total = grads[0] if len(grads) == 1 else col.sum_in_order(grads)
        col.count_wire("all-reduce", total.numel() * total.element_size(), at[blk])
        for t in held:
            out[id(t)] = total if t.device == dev else total.to(t.device)
    return Sharded(tuple(out[id(t)] for t in x.parts), x.mesh, x.spec)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, gradient tree) of ``loss_fn(params, batch)``; the gradient
    of a leaf the loss does not use is zeros.  ``params`` is read through
    detached aliases, so its tensors keep their flags and gain no
    ``.grad``.  A :class:`Sharded` leaf's gradient is laid out as the leaf
    (see the module docstring)."""
    paths, tensors = zip(*leaves(params))
    with torch.enable_grad():
        alias = [_alias(t) for t in tensors]
        flat = [t for a in alias for t in _inputs(a)]
        loss = loss_fn(build(zip(paths, alias)), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    grad_of = {id(t): g for t, g in zip(flat, grads)}
    return loss.detach(), build((path, _combined(a, grad_of)) for path, a in zip(paths, alias))


def _squares(g, device) -> torch.Tensor:
    """The f32 sum of squares of a gradient leaf, each block of a
    :class:`Sharded` once, on ``device``: the blocks' partial sums counted
    as an all-reduce of the scalar over the axes that split the leaf."""
    if not isinstance(g, Sharded):
        return torch.sum(g.float() ** 2)
    col.count_over("all-reduce", 4, g.mesh, [a for e in g.spec for a in shd.axes_of(e)])
    return sum(torch.sum(held[0].float() ** 2).to(device) for held in shd.holders(g).values())


def _copy(x):
    return shd.map_distinct(torch.clone, x) if isinstance(x, Sharded) else torch.clone(x)


def make_train_step(loss_fn: Callable, optimizer: Optimizer, grad_accum: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    parameters and state are updated in place.

    With ``grad_accum > 1`` the batch's leading axis is [accum, micro, ...]
    and the gradients (and loss) are summed in f32 over the micro-batches,
    then divided (parameters on one device).  ``grad_norm`` is the f32 L2
    norm over every leaf, on the loss's device.
    """

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            if any(isinstance(t, Sharded) for _, t in leaves(params)):
                raise ValueError("gradient accumulation takes parameters on one device")
            loss = torch.zeros((), dtype=torch.float32, device=next(iter(batch.values())).device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                             params)
            for i in range(grad_accum):
                l, g = value_and_grad(loss_fn, params, {k: v[i] for k, v in batch.items()})
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        gnorm = torch.sqrt(sum(_squares(g, loss.device) for _, g in leaves(grads)))
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
        self.params = tree_map(_copy, params) if donate else params
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
        state = ckpt.place(state, like)
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
