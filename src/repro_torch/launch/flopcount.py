"""Flop and byte accounting of a PyTorch program, by the rules of the JAX
package's ``repro.launch.flopcount`` (which walks the jaxpr):

  * products (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and the
    attention kernels) count exactly, 2·M·N·K, by the formulas registered
    in ``torch.utils.flop_counter`` (``mv`` and ``dot`` 2 a multiply-add);
    ``addmm`` / ``baddbmm`` / ``addmv`` add one flop an output element for
    their sum, as the reference's separate ``add``;
  * elementwise ops (aten's ``pointwise`` tag) and reductions count one
    flop an output element, but for the sums a collective makes (the
    reference's ``psum`` is no flop either: its bytes are counted);
  * layout and metadata ops (views, reshapes, transposes, slices,
    concatenation, padding, dtype conversion, copies, fills and factories)
    are free;
  * ``bytes_naive`` is the operand bytes plus the result bytes of every op
    that is not free: the traffic of an eager program, which fuses nothing.

It counts what runs, through a ``TorchDispatchMode``: a backward counts
when autograd runs it, a rematerialised block counts its recomputation,
and a loop counts each trip.  ``torch.utils.flop_counter.FlopCounterMode``
alone would skip the elementwise work.

The flops are also split by operand dtype, since the H100's peaks differ
by dtype (``roofline.py``): products of bf16 / f16 operands, products of
f32 operands (the port's f32 products do not use TF32), and the rest
(elementwise work and products of other dtypes).

A program on a mesh runs every position in one process, so its count is
the sum over positions; on a mesh of one repeated device a replicated
value is computed once (``dist.collectives``), so the count is the whole
program's, the reference's global figure.  The hand-written kernels of
``kernels/ops.py`` are opaque here, as a ``pallas_call`` is to the
reference: no flops, their operand and result bytes (``opaque``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
from torch.utils import flop_counter as _fc
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.dist import collectives as col
from repro_torch.launch import lanes

aten = torch.ops.aten

# products: their flops from torch.utils.flop_counter's registered formulas,
# and matrix-vector / vector products (2 flops a multiply-add)
_PRODUCTS = {p for p in _fc.flop_registry if isinstance(p, torch._ops.OpOverloadPacket)}
_VECTOR = {aten.mv: lambda a, v: 2.0 * a.shape[0] * a.shape[1],
           aten.addmv: lambda b, a, v: 2.0 * a.shape[0] * a.shape[1],
           aten.dot: lambda a, b: 2.0 * a.shape[0], aten.vdot: lambda a, b: 2.0 * a.shape[0]}
_WITH_SUM = {aten.addmm, aten.baddbmm, aten.addmv}  # the product's flops + its sum

# free: layout, metadata, conversions, copies and fills (no flops, no traffic)
_FREE = {
    aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten.permute, aten.transpose,
    aten.t, aten.squeeze, aten.unsqueeze, aten.slice, aten.select, aten.narrow, aten.split,
    aten.split_with_sizes, aten.unbind, aten.chunk, aten.cat, aten.stack, aten.constant_pad_nd,
    aten.pad, aten.flip, aten._to_copy, aten.to, aten.clone, aten.copy_, aten.copy,
    aten.contiguous, aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided, aten.zeros, aten.zeros_like,
    aten.new_zeros, aten.ones, aten.ones_like, aten.new_ones, aten.full, aten.full_like,
    aten.new_full, aten.fill_, aten.fill, aten.zero_, aten.arange, aten.scalar_tensor,
    aten.as_strided, aten.view_as, aten.expand_as, aten.unfold, aten.slice_backward,
    aten.select_backward, aten.set_, aten.resize_, aten._reshape_alias, aten.diagonal,
    aten.repeat, aten.tile, aten.flatten, aten.unflatten, aten.movedim, aten.view_as_real,
    aten.view_as_complex, aten._local_scalar_dense, aten.item, aten.is_same_size,
}

# reductions: one flop an output element (aten's "reduction" tag covers most)
_REDUCTIONS = {aten.logsumexp, aten.cumsum, aten.cumprod, aten.cummax, aten.cummin,
               aten._softmax, aten._log_softmax, aten.softmax, aten.log_softmax, aten.norm,
               aten.linalg_vector_norm, aten.scatter_reduce, aten.index_reduce}


@dataclasses.dataclass
class Cost:
    """A program's count: ``flops`` and ``bytes_naive`` (the reference's
    fields), and the flops by dtype: bf16 / f16 products, f32 products,
    the rest."""

    flops: float = 0.0
    bytes_naive: float = 0.0
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    flops_other: float = 0.0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _bytes(x) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def _elems(x) -> float:
    return float(sum(t.numel() for t in _tensors(x)))


def _kind(func) -> str:
    """'product', 'free', 'flop' (elementwise / reduction) or 'move' (bytes only)."""
    packet = func._overloadpacket
    if packet in _PRODUCTS or packet in _VECTOR:
        return "product"
    if packet in _FREE or func.is_view:
        return "free"
    tags = func.tags
    if torch.Tag.pointwise in tags or torch.Tag.reduction in tags or packet in _REDUCTIONS:
        return "flop"
    return "move"


def tally(c: Cost, func, args, kwargs, out, times: int = 1) -> None:
    """Add one op's flops and bytes to ``c``, ``times`` over (the copies a
    shortcut dry run's op stands for, ``lanes.Lanes``)."""
    kind = _kind(func)
    if kind == "free":
        return
    if kind == "flop" and col.in_collective():
        kind = "move"  # a collective's sum: wire work (dist.collectives.WIRE), not flops
    if kind == "product":
        packet = func._overloadpacket
        f = float(_VECTOR[packet](*args[:3]) if packet in _VECTOR
                  else _fc.flop_registry[packet](*args, **kwargs, out_val=out))
        f *= times
        if packet in _WITH_SUM:
            sum_flops = _elems(out) * times
            c.flops_other += sum_flops
            c.flops += sum_flops
        dts = {t.dtype for t in _tensors(args) if t.is_floating_point()}
        if dts & {torch.bfloat16, torch.float16}:
            c.flops_bf16 += f
        elif dts == {torch.float32}:
            c.flops_f32 += f
        else:
            c.flops_other += f
        c.flops += f
    elif kind == "flop":
        n = _elems(out) * times
        c.flops += n
        c.flops_other += n
    c.bytes_naive += (_bytes(args) + _bytes(out)) * times


class _Mode(TorchDispatchMode):
    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        tally(self.cost, func, args, kwargs, out)
        return out


_active = threading.local()


def opaque(inputs, outputs) -> None:
    """A hand-written kernel's call under a count: its operand and result
    bytes, no flops (as the reference counts a ``pallas_call``)."""
    costs = getattr(_active, "costs", ())
    if costs:
        times = lanes.weight_of(list(_tensors(inputs)))
    for c in costs:
        c.bytes_naive += (_bytes(inputs) + _bytes(outputs)) * times


@contextlib.contextmanager
def collecting(cost: Cost):
    """Within it, :func:`opaque` adds to ``cost`` (a mode that calls
    :func:`tally` itself counts the ops)."""
    if not hasattr(_active, "costs"):
        _active.costs = []
    _active.costs.append(cost)
    try:
        yield cost
    finally:
        _active.costs.remove(cost)


@contextlib.contextmanager
def counting():
    """``with counting() as cost:`` counts every op run inside (nested
    counts each see all of it)."""
    cost = Cost()
    with collecting(cost), _Mode(cost):
        yield cost


def count(fn, *args) -> Cost:
    """The :class:`Cost` of running ``fn(*args)`` once (the reference's
    ``count(fn, *arg_specs)``; here the arguments are real tensors, often on
    the ``meta`` device)."""
    with counting() as cost:
        fn(*args)
    return cost
