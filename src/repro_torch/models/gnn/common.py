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
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import resolve_device
from repro_torch.models.layers import silu
from repro_torch.tree import build, leaves


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
