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

The trees may hold :class:`~repro_torch.dist.sharding.Sharded` leaves
(a training program on a mesh): each distinct tensor is updated once (the
blocks on a repeated device are views of one base, a replicated block is
one tensor a device), every copy of a block by the same gradient.  The
state is laid out as its parameter minus the dimensions a moment reduces
(``state_logical_axes`` through ``spec_for`` gives the same specs).
Adafactor's means over a dimension split across the mesh, and its update
RMS, are the whole parameter's: each block's partial sum goes through a
``psum`` over the axes that split it before the division.  A plain tensor
is the one-position case of the same code.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Sharded, axes_of
from repro_torch.launch.mesh import Mesh
from repro_torch.tree import leaves, tree_map

Params = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]  # (g, state, p) -> (p, state)
    state_logical_axes: Callable[[Any], Any] | None = None


class _Leaf(NamedTuple):
    """One leaf's blocks, one a mesh position (a plain tensor: one position
    on its device), mapped position by position (``col.per_position``:
    once a distinct tensor) and summed over the mesh axes that split given
    dimensions of the parameter."""

    mesh: Mesh
    spec: tuple
    shape: tuple

    @staticmethod
    def of(p) -> "_Leaf":
        if isinstance(p, Sharded):
            return _Leaf(p.mesh, p.spec, p.shape)
        return _Leaf(Mesh(("one",), (1,), (p.device,)), (None,) * p.dim(), tuple(p.shape))

    def parts(self, x) -> tuple:
        parts = x.parts if isinstance(x, Sharded) else (x,)
        if len(parts) != len(self.mesh.devices):
            raise ValueError(f"a leaf of {len(parts)} parts beside a parameter of "
                             f"{len(self.mesh.devices)}")
        return parts

    def map(self, fn, *xs) -> tuple:
        return col.per_position(fn, self.mesh, *xs)

    def psum(self, parts, dims) -> tuple:
        """``parts`` summed over the mesh axes that split dimensions ``dims``
        of the parameter (the whole parameter's sum of a per-block one)."""
        axes = tuple(a for d in dims for a in axes_of(self.spec[d]))
        return col.psum(parts, self.mesh, axes)

    def sliced(self) -> "_Leaf":
        """A layer slice of a stacked leaf (the layers are never split)."""
        if self.spec[0] is not None:
            raise ValueError(f"a stacked leaf split over its layers ({self.spec})")
        return _Leaf(self.mesh, self.spec[1:], self.shape[1:])


def _state_leaf(p, shape_of, spec_of, dtype=torch.float32):
    """Zeros of a state leaf of parameter ``p``: ``shape_of(p.shape)`` on
    ``p``'s device, or a :class:`Sharded` by ``spec_of(p.spec)`` on its mesh."""
    if isinstance(p, Sharded):
        return shd.zeros(shape_of(p.shape), dtype, p.mesh, spec_of(p.spec))
    return torch.zeros(shape_of(tuple(p.shape)), dtype=dtype, device=p.device)


def _check_spec(state, p, spec_of, what: str) -> None:
    if isinstance(p, Sharded) and (not isinstance(state, Sharded)
                                   or state.spec != spec_of(p.spec)):
        got = state.spec if isinstance(state, Sharded) else "a plain tensor"
        raise ValueError(f"{what} laid out as {got}, its parameter as {p.spec}")


def _same(x):
    return x


def _layerwise(upd: Callable, p: torch.Tensor, *rest) -> None:
    """``upd(p, *rest)`` one layer slice at a time for a stacked leaf; the
    slices are views, so ``upd``'s in-place writes land in the leaf."""
    if p.dim() >= 3 and p.shape[0] > 1:
        for i in range(p.shape[0]):
            upd(p[i], *(tree_map(lambda t: t[i], r) for r in rest))
    else:
        upd(p, *rest)


def _step_counter(params):
    """The int32 step count, 0, on the parameters' device (their mesh)."""
    return _state_leaf(next(leaf for _, leaf in leaves(params)), lambda s: (), lambda s: (),
                       torch.int32)


def _count(state) -> _Leaf:
    """The step counter advanced (each distinct tensor once), as a leaf."""
    step = _Leaf.of(state["step"])
    step.map(lambda s: s.add_(1), step.parts(state["step"]))
    return step


def _scalar(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``: a Python scalar times a bf16 array is a
    bf16 product in the reference (the scalar is weakly typed)."""
    return float(torch.tensor(x, dtype=dtype))


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.01) -> Optimizer:
    def init(params):
        return {"mu": tree_map(lambda p: _state_leaf(p, _same, _same), params),
                "nu": tree_map(lambda p: _state_leaf(p, _same, _same), params),
                "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = _count(state)
        bcs = step.map(lambda t: (1 - b1 ** t.float(), 1 - b2 ** t.float()),
                       step.parts(state["step"]))

        def upd(p, g, mu, nu, bc):
            bc1, bc2 = bc
            g = g.float()
            mu_new = b1 * mu + (1 - b1) * g
            nu_new = b2 * nu + (1 - b2) * g * g
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + eps) + weight_decay * p.float()
            p.copy_(p - _scalar(lr, p.dtype) * u.to(p.dtype))
            mu.copy_(mu_new)
            nu.copy_(nu_new)

        def per_leaf(p, g, mu, nu):
            leaf = _Leaf.of(p)
            for m in (mu, nu):
                _check_spec(m, p, _same, "an AdamW moment")
            leaf.map(lambda p, g, mu, nu, bc: _layerwise(lambda *a: upd(*a, bc), p, g, mu, nu),
                     *(leaf.parts(x) for x in (p, g, mu, nu)), bcs)

        tree_map(per_leaf, params, grads, state["mu"], state["nu"])
        return params, state

    def state_axes(param_axes):
        return {"mu": param_axes, "nu": tree_map(lambda a: a, param_axes), "step": ()}

    return Optimizer(init, update, state_axes)


def _rows(shape):
    """Adafactor's row moment of a matrix leaf: its last dimension reduced
    (a shape or a spec)."""
    return tuple(shape[:-1])


def _cols(shape):
    """Its column moment: the second-to-last dimension reduced."""
    return (*shape[:-2], shape[-1])


def adafactor(lr: float = 1e-3, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second moment: the state is O(rows + cols) a matrix."""
    moments = {"vr": _rows, "vc": _cols, "v": _same}

    def init(params):
        def per(p):
            if len(p.shape) >= 2:
                return {"vr": _state_leaf(p, _rows, _rows), "vc": _state_leaf(p, _cols, _cols)}
            return {"v": _state_leaf(p, _same, _same)}

        return {"f": tree_map(per, params), "step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        step = _count(state)
        betas = step.map(lambda t: 1.0 - t.float() ** (-decay), step.parts(state["step"]))

        def per(leaf, p, g, s):
            """One leaf (or layer slice) of global shape ``leaf.shape``: its
            blocks ``p`` / ``g``, its moments' blocks ``s``."""
            n = leaf.shape
            g2 = leaf.map(lambda g: g.float() * g.float() + eps, g)
            if "vr" in s:
                rows = leaf.psum(leaf.map(lambda x: x.sum(dim=-1), g2), [-1])
                cols = leaf.psum(leaf.map(lambda x: x.sum(dim=-2), g2), [-2])
                vr = leaf.map(lambda b, v, r: b * v + (1 - b) * (r / n[-1]), betas, s["vr"], rows)
                vc = leaf.map(lambda b, v, c: b * v + (1 - b) * (c / n[-2]), betas, s["vc"], cols)
                vr_sum = leaf.psum(leaf.map(lambda v: v.sum(dim=-1, keepdim=True), vr), [-2])

                def scaled(g, vr, vc, vr_sum):
                    r = vr / torch.clamp(vr_sum / n[-2], min=1e-30)
                    return g.float() / torch.sqrt(torch.clamp(r[..., None] * vc[..., None, :],
                                                              min=1e-30))

                u = leaf.map(scaled, g, vr, vc, vr_sum)
                new = {"vr": vr, "vc": vc}
            else:
                v = leaf.map(lambda b, v, x: b * v + (1 - b) * x, betas, s["v"], g2)
                u = leaf.map(lambda g, v: g.float() / torch.sqrt(torch.clamp(v, min=1e-30)), g, v)
                new = {"v": v}
            for k, parts in new.items():
                leaf.map(lambda dst, src: dst.copy_(src), s[k], parts)
            uu = leaf.psum(leaf.map(lambda u: torch.sum(u * u), u), range(len(n)))
            numel = math.prod(n)

            def step_p(p, u, uu):
                rms = torch.sqrt(uu / numel + 1e-30)
                u = u / torch.clamp(rms / clip_threshold, min=1.0)
                p.copy_(p - _scalar(lr, p.dtype) * u.to(p.dtype))

            leaf.map(step_p, p, u, uu)

        def per_leaf(p, g, s):  # layer-sliced for stacked factored leaves
            leaf = _Leaf.of(p)
            for k, v in s.items():
                _check_spec(v, p, moments[k], f"Adafactor's {k}")
            ps, gs = leaf.parts(p), leaf.parts(g)
            ss = {k: leaf.parts(v) for k, v in s.items()}
            if "vr" in s and len(leaf.shape) >= 3 and leaf.shape[0] > 1:
                one = leaf.sliced()
                for i in range(leaf.shape[0]):
                    def at(parts, i=i):  # layer i of each block, a view a distinct tensor
                        return leaf.map(lambda t: t[i], parts)

                    per(one, at(ps), at(gs), {k: at(v) for k, v in ss.items()})
            else:
                per(leaf, ps, gs, ss)

        tree_map(per_leaf, params, grads, state["f"])
        return params, state

    def state_axes(param_axes):
        def per(ax):
            if len(ax) >= 2:
                return {"vr": _rows(ax), "vc": _cols(ax)}
            return {"v": tuple(ax)}

        return {"f": tree_map(per, param_axes), "step": ()}

    return Optimizer(init, update, state_axes)


def sgd(lr: float = 1e-2) -> Optimizer:
    def init(params):
        return {"step": _step_counter(params)}

    @torch.no_grad()
    def update(grads, state, params):
        def per_leaf(p, g):
            leaf = _Leaf.of(p)
            leaf.map(lambda p, g: p.copy_(p - _scalar(lr, p.dtype) * g.to(p.dtype)),
                     leaf.parts(p), leaf.parts(g))

        tree_map(per_leaf, params, grads)
        _count(state)
        return params, state

    return Optimizer(init, update, lambda ax: {"step": ()})
