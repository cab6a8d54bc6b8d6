"""Graph generation and the fanout neighbor sampler (host-side, numpy),
the JAX package's ``repro.data.graphs``.

The GNN shapes name public datasets (cora / reddit / ogbn-products
scale); the graphs here are generated with the same (n_nodes, n_edges,
d_feat) and a power-law degree skew.  ``NeighborSampler`` does layered
fanout sampling (15-10) over a CSR adjacency; sampled blocks are padded
to static shapes with masks.  For a seed every function gives the
reference's arrays bit for bit; the batches are the port's
:class:`~repro_torch.models.gnn.common.GraphBatch` of numpy arrays
(``GraphBatch.to`` moves one to a device).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.gnn.common import GraphBatch


@dataclasses.dataclass
class HostGraph:
    """CSR adjacency + features on host."""

    indptr: np.ndarray  # int64[N+1]
    indices: np.ndarray  # int64[E]
    feat: np.ndarray  # f32[N, F]
    labels: np.ndarray  # int64[N]
    positions: np.ndarray  # f32[N, 3]
    species: np.ndarray  # int64[N]

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def n_edges(self) -> int:
        return self.indices.shape[0]


def _stable_order(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for non-negative int keys, as
    least-significant-digit passes over 16-bit digits (numpy radix-sorts a
    16-bit key in linear time: ~2.6x faster than the comparison sort at
    10^8 keys)."""
    out = np.arange(keys.shape[0])
    hi = int(keys.max()) if keys.size else 0
    shift = 0
    while True:
        digit = ((keys[out] >> shift) & 0xFFFF).astype(np.uint16)
        out = out[np.argsort(digit, kind="stable")]
        shift += 16
        if hi >> shift == 0:
            return out


def random_graph(
    n_nodes: int, n_edges: int, d_feat: int, n_classes: int = 16,
    *, seed: int = 0, skew: float = 0.8,
) -> HostGraph:
    """Power-law-ish random digraph in CSR (degree skew like real datasets)."""
    rng = np.random.default_rng(seed)
    src = (n_nodes * rng.random(n_edges) ** (1.0 + skew)).astype(np.int64) % n_nodes
    dst = rng.integers(0, n_nodes, n_edges)
    order = _stable_order(src)
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n_nodes))
    feat = rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    labels = rng.integers(0, n_classes, n_nodes)
    pos = rng.standard_normal((n_nodes, 3)).astype(np.float32)
    species = rng.integers(0, 16, n_nodes)
    return HostGraph(indptr, dst, feat, labels, pos, species)


def to_batch(g: HostGraph, n_classes: int) -> GraphBatch:
    """Full-batch GraphBatch (edge list from CSR)."""
    src = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    rel = g.positions[g.indices] - g.positions[src]
    edge_feat = np.concatenate(
        [rel, np.linalg.norm(rel, axis=1, keepdims=True)], axis=1).astype(np.float32)
    return GraphBatch(
        node_feat=g.feat,
        positions=g.positions,
        species=g.species.astype(np.int32),
        edge_src=src.astype(np.int32),
        edge_dst=g.indices.astype(np.int32),
        edge_feat=edge_feat,
        node_mask=np.ones(g.n_nodes, bool),
        edge_mask=np.ones(g.n_edges, bool),
        labels=g.labels.astype(np.int32),
        graph_ids=np.zeros(g.n_nodes, np.int32),
        graph_y=np.zeros((1,), np.float32),
    )


class NeighborSampler:
    """Layered fanout sampling (GraphSAGE-style) with static padded output."""

    def __init__(self, g: HostGraph, fanouts: tuple[int, ...], seed: int = 0):
        self.g = g
        self.fanouts = fanouts
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> GraphBatch:
        g = self.g
        nodes = [seeds.astype(np.int64)]
        src_all, dst_all = [], []
        frontier = seeds.astype(np.int64)
        deg_all = np.diff(g.indptr)
        for f in self.fanouts:
            deg = deg_all[frontier]
            # sample up to f neighbors per frontier node (with replacement
            # when deg > 0; isolated nodes contribute nothing)
            has = deg > 0
            idx = np.repeat(np.arange(frontier.shape[0]), np.where(has, f, 0))
            base = g.indptr[frontier[idx]]
            d = deg[idx]
            off = (self.rng.random(idx.shape[0]) * d).astype(np.int64)
            nbrs = g.indices[base + off]
            src_all.append(nbrs)  # message flows neighbor -> frontier node
            dst_all.append(frontier[idx])
            frontier = np.unique(nbrs)
            nodes.append(frontier)

        node_ids = np.unique(np.concatenate(nodes))
        lut = np.zeros(g.n_nodes, np.int64)
        lut[node_ids] = np.arange(node_ids.shape[0])
        src = lut[np.concatenate(src_all)]
        dst = lut[np.concatenate(dst_all)]

        # pad to static shapes: nodes -> seeds·Π(1+f), edges -> seeds·Σ(Πf)
        max_nodes = int(seeds.shape[0] * np.prod([f + 1 for f in self.fanouts]))
        max_edges = 0
        m = seeds.shape[0]
        for f in self.fanouts:
            m *= f
            max_edges += m
        n, e = node_ids.shape[0], src.shape[0]
        n_pad, e_pad = min(n, max_nodes), min(e, max_edges)

        feat = np.zeros((max_nodes, g.feat.shape[1]), np.float32)
        feat[:n_pad] = g.feat[node_ids[:n_pad]]
        pos = np.zeros((max_nodes, 3), np.float32)
        pos[:n_pad] = g.positions[node_ids[:n_pad]]
        spec = np.zeros(max_nodes, np.int32)
        spec[:n_pad] = g.species[node_ids[:n_pad]]
        labels = np.full(max_nodes, -1, np.int32)
        labels[lut[seeds]] = g.labels[seeds]  # loss only on seed nodes

        es = np.zeros(max_edges, np.int32)
        ed = np.zeros(max_edges, np.int32)
        es[:e_pad] = src[:e_pad]
        ed[:e_pad] = dst[:e_pad]
        edge_feat = np.zeros((max_edges, 4), np.float32)
        rel = pos[ed[:e_pad]] - pos[es[:e_pad]]
        edge_feat[:e_pad, :3] = rel
        edge_feat[:e_pad, 3] = np.linalg.norm(rel, axis=1)

        node_mask = np.zeros(max_nodes, bool)
        node_mask[:n_pad] = True
        edge_mask = np.zeros(max_edges, bool)
        edge_mask[:e_pad] = True
        return GraphBatch(
            node_feat=feat, positions=pos, species=spec,
            edge_src=es, edge_dst=ed, edge_feat=edge_feat,
            node_mask=node_mask, edge_mask=edge_mask, labels=labels,
            graph_ids=np.zeros(max_nodes, np.int32),
            graph_y=np.zeros((1,), np.float32),
        )


def molecule_batch(
    batch: int, n_nodes: int, n_edges: int, *, seed: int = 0
) -> GraphBatch:
    """Batched small molecules: kNN point clouds flattened with graph_ids."""
    rng = np.random.default_rng(seed)
    N, E = batch * n_nodes, batch * n_edges
    pos = rng.standard_normal((batch, n_nodes, 3)).astype(np.float32) * 2.0
    # kNN edges per molecule
    d = np.linalg.norm(pos[:, :, None] - pos[:, None, :], axis=-1)
    np.einsum("bii->bi", d)[:] = np.inf
    k = max(1, n_edges // n_nodes)
    nn = np.argsort(d, axis=-1)[:, :, :k]  # [B, n, k]
    src = np.tile(np.arange(n_nodes)[None, :, None], (batch, 1, k))
    offs = (np.arange(batch) * n_nodes)[:, None, None]
    es = (src + offs).reshape(-1)[:E]
    ed = (nn + offs).reshape(-1)[:E]
    species = rng.integers(0, 8, N).astype(np.int32)
    feat = np.eye(8, dtype=np.float32)[species]
    rel = pos.reshape(N, 3)[ed] - pos.reshape(N, 3)[es]
    edge_feat = np.concatenate(
        [rel, np.linalg.norm(rel, axis=1, keepdims=True)], axis=1
    ).astype(np.float32)
    y = rng.standard_normal(batch).astype(np.float32)
    return GraphBatch(
        node_feat=feat, positions=pos.reshape(N, 3).astype(np.float32),
        species=species, edge_src=es.astype(np.int32), edge_dst=ed.astype(np.int32),
        edge_feat=edge_feat, node_mask=np.ones(N, bool), edge_mask=np.ones(es.shape[0], bool),
        labels=np.full(N, -1, np.int32),
        graph_ids=np.repeat(np.arange(batch), n_nodes).astype(np.int32),
        graph_y=y,
    )
