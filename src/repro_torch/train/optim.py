"""Optimizers with the JAX package's ``init`` / ``update`` shape
(``repro.train.optim``): AdamW for the small and medium archs, Adafactor
(factored second moment, no momentum) for the 1T-class ones, and SGD.

``update(grads, state, params)`` writes the new parameters and state into
``params`` and ``state`` in place under ``torch.no_grad()`` (the
counterpart of the reference program donating them) and returns both
trees.  The arithmetic is the reference's, op for op and in its rounding
order, not ``torch.optim``'s (AdamW there decays ``p`` before the step;
Adafactor's decay and clipping differ): the update is cast to the
parameter dtype before ``lr ·``, ``lr`` is rounded to that dtype (the
reference's weakly typed scalar), the bias corrections are computed in
f32 from an int32 step.  A leaf stacked over layers (rank ≥ 3, more than one
layer) is updated one layer slice at a time, as the reference's
``_layerwise`` maps it: the same values (Adafactor's RMS clip is per
slice, as there) with f32 temporaries a layer in size.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]  # (g, state, p) -> (p, state)
    state_logical_axes: Callable[[Any], Any] | None = None


def _layerwise(upd: Callable, p: torch.Tensor, *rest) -> None:
    """``upd(p, *rest)`` one layer slice at a time for a stacked leaf; the
    slices are views, so ``upd``'s in-place writes land in the leaf."""
    if p.dim() >= 3 and p.shape[0] > 1:
        for i in range(p.shape[0]):
            upd(p[i], *(tree_map(lambda t: t[i], r) for r in rest))
    else:
        upd(p, *rest)


def _step_counter(params) -> torch.Tensor:
    """The int32 step count, 0, on the parameters' device."""
    first = next(leaf for _, leaf in leaves(params))
    return torch.zeros((), dtype=torch.int32, device=first.device)


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python scalar times a bf16 array is a
    bf16 product in the reference (the scalar is weakly typed)."""
    return float(torch.tensor(x, dtype=dtype))


def _f32_zeros(shape, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=like.device)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: _f32_zeros(p.shape, p), params),
                "nu": tree_map(lambda p: _f32_zeros(p.shape, p), params),
                "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        t = state["step"].float()
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t

        def upd(p, g, mu, nu):
            g = g.float()
            mu_new = b1 * mu + (1 - b1) * g
            nu_new = b2 * nu + (1 - b2) * g * g
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps) + weight_decay * p.float()
            p.copy_(p - _scalar(lr, p.dtype) * u.to(p.dtype))
            mu.copy_(mu_new)
            nu.copy_(nu_new)

        tree_map(lambda p, g, mu, nu: _layerwise(upd, p, g, mu, nu),
                 params, grads, state["mu"], state["nu"])
        return params, state

    def state_axes(param_axes):
        return {"mu": param_axes, "nu": tree_map(lambda a: a, param_axes), "step": ()}

    return Optimizer(init, update, state_axes)


def adafactor(lr: float = 1e-3, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment: the state is O(rows + cols) a matrix."""

    def init(params):
        def per(p):
            if p.dim() >= 2:
                return {"vr": _f32_zeros(p.shape[:-1], p),
                        "vc": _f32_zeros((*p.shape[:-2], p.shape[-1]), p)}
            return {"v": _f32_zeros(p.shape, p)}

        return {"f": tree_map(per, params), "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"] += 1
        beta = 1.0 - state["step"].float() ** (-decay)

        def per(p, g, s):
            g = g.float()
            g2 = g * g + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
                u = g / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :], min=1e-30))
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g / torch.sqrt(torch.clamp(v, min=1e-30))
                s["v"].copy_(v)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            p.copy_(p - _scalar(lr, p.dtype) * u.to(p.dtype))

        def per_leaf(p, g, s):  # layer-sliced for stacked factored leaves
            if "vr" in s:
                _layerwise(per, p, g, s)
            else:
                per(p, g, s)

        tree_map(per_leaf, params, grads, state["f"])
        return params, state

    def state_axes(param_axes):
        def per(ax):
            if len(ax) >= 2:
                return {"vr": tuple(ax[:-1]), "vc": tuple(ax[:-2]) + (ax[-1],)}
            return {"v": tuple(ax)}

        return {"f": tree_map(per, param_axes), "step": ()}

    return Optimizer(init, update, state_axes)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        tree_map(lambda p, g: p.copy_(p - _scalar(lr, p.dtype) * g.to(p.dtype)), params, grads)
        state["step"] += 1
        return params, state

    return Optimizer(init, update, lambda ax: {"step": ()})
