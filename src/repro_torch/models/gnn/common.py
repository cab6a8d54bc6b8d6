"""Shared GNN plumbing of the JAX package's ``repro.models.gnn.common``:
graph batches, segment message passing, MLPs, losses.

Aggregation is built from first principles: gather node states along
``edge_src``, compute edge messages densely, sum (``index_add``) or max
(``scatter_reduce``) them into ``edge_dst``.  Edges are padded to static
shapes with ``edge_mask``; padded edges point at node 0 with zero weight.

Differences from the reference, kept on purpose:

* a segment sum of bf16 values (GraphCast's edge states) accumulates in
  f32 and rounds once to bf16; XLA's CPU scatter rounds every add to
  bf16 in edge order, and the card's bf16 atomics round every add in an
  order of their own, so neither is a reference to follow bit for bit;
* on the card ``index_add`` adds with atomics: a sum's last bits can
  differ from run to run.

A model's forward is written once over a graph view (:func:`view`):
:class:`Local` for a batch of tensors on one device, :class:`OnMesh` for a
batch of :class:`~repro_torch.dist.sharding.Sharded` arrays (the JAX
package's layout: node arrays split over the data axes, edge arrays too,
parameters replicated).  On a mesh each position holds its data slice's
node block and a ``1/model`` share of the slice's edges; an edge reads the
states at its ends through the halo gather (the node blocks all-gathered
over the data axes) and writes through the summed scatter (the edges'
values summed over the mesh and split to the node owners).  So every edge is worked once on the mesh and each data slice's
node work once a model replica; a replica's node states feed only its own
edges, so the holders' parameter gradients sum to the true gradient
(``train.trainer``'s combine), and the loss reads the first model
replica's sums.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import resolve_device
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import Sharded, coords
from repro_torch.launch.mesh import MODEL_AXIS, dp_axes
from repro_torch.models.layers import silu
from repro_torch.tree import build, leaves, tree_map


class GraphBatch(NamedTuple):
    """One (possibly multi-graph) padded graph batch: numpy arrays on the
    host (``data.graphs``), tensors once moved with :meth:`to`."""

    node_feat: torch.Tensor  # f32[N, F]
    positions: torch.Tensor  # f32[N, 3] (synthesized for non-geometric datasets)
    species: torch.Tensor  # int32[N]  (atomic number / node type bucket)
    edge_src: torch.Tensor  # int32[E]
    edge_dst: torch.Tensor  # int32[E]
    edge_feat: torch.Tensor  # f32[E, Fe]
    node_mask: torch.Tensor  # bool[N]
    edge_mask: torch.Tensor  # bool[E]
    labels: torch.Tensor  # int32[N] node classes (or -1); regression via graph_y
    graph_ids: torch.Tensor  # int32[N] graph id per node (0 for single graph)
    graph_y: torch.Tensor  # f32[B] per-graph regression target

    @property
    def n_graphs(self) -> int:
        return self.graph_y.shape[0]

    def to(self, device) -> "GraphBatch":
        """Every field as a tensor on ``device`` (numpy arrays copied in, the
        dtypes kept)."""
        return GraphBatch(*(torch.as_tensor(x).to(device) for x in self))


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: rows of ``data`` summed into
    ``num_segments`` rows by ``segment_ids``; a bf16 sum accumulates in f32
    and rounds once."""
    acc = data.float() if data.dtype == torch.bfloat16 else data
    out = acc.new_zeros((num_segments, *data.shape[1:])).index_add(0, segment_ids, acc)
    return out.to(data.dtype)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` of a 1-D ``data``: an empty segment is -inf."""
    out = data.new_full((num_segments,), float("-inf"))
    return out.scatter_reduce(0, segment_ids.long(), data, "amax", include_self=False)


def segment_mean(data, segment_ids, num_segments, mask=None):
    if mask is not None:
        data = data * mask[:, None].to(data.dtype)
        cnt = segment_sum(mask.to(data.dtype), segment_ids, num_segments)
    else:
        cnt = segment_sum(data.new_ones(data.shape[0]), segment_ids, num_segments)
    s = segment_sum(data, segment_ids, num_segments)
    return s / torch.clamp(cnt, min=1.0)[:, None]


def scatter_edges(edge_vals: torch.Tensor, dst: torch.Tensor, n_nodes: int,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked segment-sum of per-edge vectors into destination nodes."""
    if mask is not None:
        edge_vals = edge_vals * mask[..., None].to(edge_vals.dtype)
    return segment_sum(edge_vals, dst, n_nodes)


def mlp_params(generator: torch.Generator, dims: list[int], scale: float = 1.0,
               device=None) -> dict:
    """An MLP's weights ``normal · scale / sqrt(fan_in)`` drawn from
    ``generator`` (on its own device, layer by layer) and zero biases, f32
    on ``device`` (default: the generator's)."""
    dev = generator.device if device is None else device
    return {
        "w": [(torch.randn((a, b), generator=generator, device=generator.device)
               * scale / math.sqrt(a)).to(dev) for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), device=dev) for b in dims[1:]],
    }


def spec(*shape: int) -> torch.Tensor:
    """An f32 parameter spec on the ``meta`` device (nothing allocated)."""
    return torch.empty(shape, dtype=torch.float32, device="meta")


def random_params(specs, generator: torch.Generator, device, fan) -> dict:
    """Parameters in the shapes of ``specs``: ``normal / sqrt(fan(shape))``
    where ``fan`` gives an int, zeros where it gives None; the normals
    drawn from ``generator`` on its own device, leaf by leaf in sorted-key
    order, and moved to ``device`` (the values are not the JAX
    package's)."""
    dev = resolve_device(device)

    def one(s):
        f = fan(tuple(s.shape))
        if f is None:
            return torch.zeros(s.shape, dtype=torch.float32, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.div_(math.sqrt(f)).to(dev)

    return build((path, one(s)) for path, s in leaves(specs))


def params_from_arrays(specs, tree, device) -> dict:
    """The JAX package's parameter tree as numpy arrays, as the port's f32
    tensors on ``device``; every path and shape checked against ``specs``."""
    dev = resolve_device(device)
    want = dict(leaves(specs))
    got = dict(leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter paths differ: missing {sorted(map(str, set(want) - set(got)))}"
                         f", unexpected {sorted(map(str, set(got) - set(want)))}")
    out = []
    for path, s in want.items():
        t = torch.from_numpy(np.array(got[path], dtype=np.float32)).to(dev)
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"{path}: shape {tuple(t.shape)}, want {tuple(s.shape)}")
        out.append((path, t))
    return build(out)


def remat(enabled: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward when ``enabled`` and
    autograd is recording (``jax.checkpoint`` with nothing saveable)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def mlp_specs(dims: list[int]) -> dict:
    """An MLP's weights ``w[i]`` [dims[i], dims[i + 1]] and biases
    ``b[i]``, f32, on the ``meta`` device."""
    return {
        "w": [spec(a, b) for a, b in zip(dims[:-1], dims[1:])],
        "b": [spec(b) for b in dims[1:]],
    }


def mlp_apply(p: dict, x: torch.Tensor, act=silu, final_act: bool = False) -> torch.Tensor:
    """``x @ w + b`` a layer (weights cast to ``x``'s dtype), ``act``
    (``jax.nn.silu`` as XLA rounds it, by default) between layers and,
    with ``final_act``, after the last."""
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def node_class_loss(node_out: torch.Tensor, labels: torch.Tensor,
                    node_mask: torch.Tensor) -> torch.Tensor:
    """Masked softmax CE over nodes with labels >= 0."""
    mask = node_mask & (labels >= 0)
    logits = node_out.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, 1, torch.clamp(labels, min=0).long()[:, None])[:, 0]
    nll = torch.where(mask, lse - lab, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def graph_regression_loss(node_out: torch.Tensor, g: GraphBatch) -> torch.Tensor:
    """Per-graph energy: sum node scalars, MSE against graph_y."""
    e_node = node_out[..., 0] * g.node_mask
    e_graph = segment_sum(e_node, g.graph_ids, g.n_graphs)
    return torch.mean((e_graph - g.graph_y) ** 2)


def ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an int ``n >= 0`` by the reference's binary
    exponentiation (``lax.integer_pow``), so it rounds as the reference."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """Sinc-like Bessel radial basis with smooth polynomial cutoff."""
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    x = torch.clamp(r[..., None] / r_cut, 1e-5, 1.0)
    rb = float(np.sqrt(np.float32(2.0 / r_cut))) * torch.sin(n * np.pi * x) / (x * r_cut)
    u = torch.clamp(r / r_cut, 0.0, 1.0)
    fcut = 1 - 10 * ipow(u, 3) + 15 * ipow(u, 4) - 6 * ipow(u, 5)
    return rb * fcut[..., None]


# ---------------------------------------------------------------------------
# graph views: one model code path for a device and for a mesh
# ---------------------------------------------------------------------------


class Local:
    """A :class:`GraphBatch` of tensors on one device: ``map`` calls its
    function, a gather is the array itself, a scatter the plain segment
    sum."""

    def __init__(self, g: GraphBatch):
        self.g = g
        self.n = g.node_feat.shape[0]

    def map(self, fn, *args):
        return fn(*args)

    def unzip(self, out, k: int):
        return out

    def params(self, params):
        return params

    def sub(self, x, f):
        return f(x)

    def node(self, name: str):
        return getattr(self.g, name)

    edge = node

    def halo(self, x):
        return x

    def scatter(self, vals: torch.Tensor) -> torch.Tensor:
        """Masked edge values summed into their destinations."""
        return segment_sum(vals, self.g.edge_dst, self.n)

    def reduce(self, partial, dtype=None):
        return partial if dtype is None else partial.to(dtype)

    def pmax(self, partial):
        return partial

    def remat(self, enabled: bool, fn, *args):
        return remat(enabled, fn, *args)

    def node_class_loss(self, out, labels, node_mask):
        return node_class_loss(out, labels, node_mask)

    def graph_regression_loss(self, out):
        return graph_regression_loss(out, self.g)


class OnMesh:
    """A :class:`GraphBatch` of :class:`Sharded` arrays (nodes and edges
    over the data axes, ``graph_y`` replicated): every per-node or per-edge
    value is a tuple with one entry a mesh position.  Position ``p`` works
    its data slice's node block and the ``model``-th share of the slice's
    edges (the JAX package pads the edges to data x model)."""

    def __init__(self, g: GraphBatch):
        s = g.node_feat
        self.g, self.mesh = g, s.mesh
        self.dp = dp_axes(self.mesh)
        self.axes = tuple(self.mesh.axis_names)
        self.n = s.shape[0]
        mp = self.mesh.shape.get(MODEL_AXIS, 1)
        per = g.edge_src.shape[0] // (self.mesh.size(self.dp) * mp)
        if per * self.mesh.size(self.dp) * mp != g.edge_src.shape[0]:
            raise ValueError(f"{g.edge_src.shape[0]} edges do not split over "
                             f"{self.mesh.size(self.dp)} x {mp} positions")
        self.share = tuple(coords(self.mesh, p).get(MODEL_AXIS, 0) * per
                           for p in range(len(self.mesh.devices)))
        self.per = per

    def map(self, fn, *args):
        """``fn(*entries)`` a position (``collectives.per_position``)."""
        return col.per_position(fn, self.mesh, *args)

    def unzip(self, out, k: int):
        return tuple(tuple(o[i] for o in out) for i in range(k))

    def params(self, params):
        """The parameter tree of each position (its parts of the
        replicated leaves)."""
        return tuple(tree_map(lambda s: s.parts[p], params)
                     for p in range(len(self.mesh.devices)))

    def sub(self, x, f):
        return tuple(f(v) for v in x)

    def node(self, name: str):
        return getattr(self.g, name).parts

    def edge(self, name: str):
        """A position's share of its data slice's edges."""
        parts = getattr(self.g, name).parts
        return self.map(lambda t, s: t.narrow(0, s, self.per), parts, self.share)

    def halo(self, x):
        """Node blocks gathered whole over the data axes: each model
        position's edge share reads the gather, so a block's gradient is
        also summed over the model axes (``collectives.replicated``)."""
        rest = tuple(a for a in self.axes if a not in self.dp)
        return col.halo_gather(col.replicated(x, self.mesh, rest), self.mesh, self.dp)

    def scatter(self, vals):
        """Masked edge values summed into their destinations over the mesh
        (a float type narrower than f32 in f32, rounded once), each position
        given its node block (``collectives.scatter_sum``)."""
        return col.scatter_sum(vals, self.edge("edge_dst"), self.n, self.mesh, self.axes, self.dp)

    def reduce(self, partial, dtype=None):
        """Whole-graph partials summed over the mesh into node blocks."""
        return col.summed_scatter(partial, self.mesh, self.axes, self.dp, 0, dtype)

    def pmax(self, partial):
        """The elementwise maximum over the mesh (no gradient: the softmax's
        shift is a constant)."""
        return col.pmax(self.map(torch.Tensor.detach, partial), self.mesh, self.axes)

    def remat(self, enabled: bool, fn, *args):
        """``fn(*args)`` recomputed in the backward as one autograd node over
        every position (``transformer_mesh._Remat``): its distinct input
        tensors in, its distinct output tensors out."""
        if not (enabled and torch.is_grad_enabled()):
            return fn(*args)
        from repro_torch.models.transformer_mesh import _Remat

        flat: list = []
        shape_in = _skeleton(args, flat, {})
        shape_out = []

        def run(*ts):
            out_flat: list = []
            shape_out[:] = [_skeleton(fn(*_rebuild(shape_in, ts)), out_flat, {})]
            return out_flat

        outs = _Remat.apply(run, *flat)
        return _rebuild(shape_out[0], outs)

    def _first_replica_sum(self, parts):
        """The sum over the data axes of per-position values, on the lead
        device (the first model replica's group)."""
        return col.psum(parts, self.mesh, self.dp)[0]

    def node_class_loss(self, out, labels, node_mask):
        """:func:`node_class_loss` over every node block: the masked sum and
        the count summed over the data slices."""
        def part(o, lab, nm):
            mask = nm & (lab >= 0)
            logits = o.float()
            lse = torch.logsumexp(logits, dim=-1)
            lb = torch.gather(logits, 1, torch.clamp(lab, min=0).long()[:, None])[:, 0]
            return torch.stack([torch.where(mask, lse - lb, 0.0).sum(), mask.sum().float()])

        tot = self._first_replica_sum(self.map(part, out, labels, node_mask))
        return tot[0] / torch.clamp(tot[1], min=1)

    def graph_regression_loss(self, out):
        """:func:`graph_regression_loss`: each node block's per-graph sums,
        summed over the data slices, against the replicated ``graph_y``."""
        y = self.g.graph_y.parts[0]
        n_graphs = y.shape[0]

        def part(o, nm, gid):
            return segment_sum(o[..., 0] * nm, gid, n_graphs)

        e_graph = self._first_replica_sum(self.map(part, out, self.node("node_mask"),
                                                   self.node("graph_ids")))
        return torch.mean((e_graph - y) ** 2)


def _skeleton(v, flat: list, slot: dict):
    """``v`` (tensors in tuples, lists, named tuples and dicts) with each
    distinct tensor replaced by its index in ``flat`` (appended once)."""
    if isinstance(v, torch.Tensor):
        if id(v) not in slot:
            slot[id(v)] = len(flat)
            flat.append(v)
        return ("t", slot[id(v)])
    if isinstance(v, (tuple, list)):
        return (type(v), [_skeleton(x, flat, slot) for x in v])
    if isinstance(v, dict):
        return (dict, {k: _skeleton(x, flat, slot) for k, x in v.items()})
    return ("v", v)


def _rebuild(sk, ts):
    """The value :func:`_skeleton` described, with tensors ``ts``."""
    tag, body = sk
    if tag == "t":
        return ts[body]
    if tag == "v":
        return body
    if tag is dict:
        return {k: _rebuild(x, ts) for k, x in body.items()}
    items = [_rebuild(x, ts) for x in body]
    return tag(*items) if hasattr(tag, "_fields") else tag(items)


def view(g: GraphBatch):
    """:class:`OnMesh` for a batch of ``Sharded`` arrays, else :class:`Local`."""
    return OnMesh(g) if isinstance(g.node_feat, Sharded) else Local(g)
