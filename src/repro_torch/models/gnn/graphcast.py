"""GraphCast-style encoder-processor-decoder GNN (arXiv:2212.12794), the
JAX package's ``repro.models.gnn.graphcast``.

Interaction-network blocks with residuals and sum aggregation, the
processor structure of GraphCast (n_layers=16, d_hidden=512, sum
aggregator):

    e'  = e + MLP_e([e, h_src, h_dst])
    h'  = h + MLP_n([h, Σ_{e into i} e'])

GraphCast's native deployment encodes a lat-lon grid onto a refined
icosahedral mesh (mesh_refinement=6) and decodes back; here the
encoder/decoder are feature MLPs over the supplied graph, with the native
config recorded in the arch file.  Node and edge states are bf16 (the MLP
weights cast to bf16 at use); the decoder runs in f32.  The edge states'
segment sum accumulates in f32 and rounds once (``common.segment_sum``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class GraphCastCfg:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    in_dim: int = 227
    edge_dim: int = 4
    out_dim: int = 227
    mesh_refinement: int = 6  # native config (recorded; generic graphs supplied)
    # remat a layer (recomputed in the backward); the program builder turns it
    # off for the full-batch giant graph
    remat: bool = True


def param_specs(cfg: GraphCastCfg) -> dict:
    d = cfg.d_hidden
    lay = [
        {
            "edge_mlp": C.mlp_specs([3 * d, d, d]),
            "node_mlp": C.mlp_specs([2 * d, d, d]),
        }
        for _ in range(cfg.n_layers)
    ]
    return {
        "node_enc": C.mlp_specs([cfg.in_dim, d, d]),
        "edge_enc": C.mlp_specs([max(cfg.edge_dim, 1), d, d]),
        "layers": lay,
        "node_dec": C.mlp_specs([d, d, cfg.out_dim]),
    }


def _fan(shape):
    return shape[0] if len(shape) == 2 else None


def init(cfg: GraphCastCfg, generator: torch.Generator, device="cuda") -> dict:
    """The reference's rule: ``normal / sqrt(fan_in)`` a weight, zero
    biases (:func:`common.random_params`)."""
    return C.random_params(param_specs(cfg), generator, device, _fan)


def params_from_arrays(cfg: GraphCastCfg, tree, device="cuda") -> dict:
    return C.params_from_arrays(param_specs(cfg), tree, device)


def encode(cfg: GraphCastCfg, params, g: C.GraphBatch):
    """The bf16 node and edge states (h [N, d], e [E, d]) the processor
    starts from (on a mesh: node blocks and edge shares, a tuple each)."""
    G = C.view(g)
    P = G.params(params)
    h = G.map(lambda p, nf: C.mlp_apply(p["node_enc"], nf).to(torch.bfloat16), P,
              G.node("node_feat"))

    def edges(p, ef, src):
        ef = ef if cfg.edge_dim else ef.new_ones((src.shape[0], 1))
        return C.mlp_apply(p["edge_enc"], ef).to(torch.bfloat16)

    e = G.map(edges, P, G.edge("edge_feat"), G.edge("edge_src"))
    return h, e


def layer(lp, g: C.GraphBatch, h, e, G=None):
    """One processor block: (h, e) -> (h', e') (on a mesh the tuples of
    :func:`encode`, ``lp`` a tree a position)."""
    G = C.view(g) if G is None else G

    def edge_part(lp, e, hf, src, dst, em):
        hs = hf.index_select(0, src)
        hd = hf.index_select(0, dst)
        e = e + C.mlp_apply(lp["edge_mlp"], torch.cat([e, hs, hd], dim=-1))
        return e, e * em[..., None].to(e.dtype)

    e, vals = G.unzip(G.map(edge_part, lp, e, G.halo(h), G.edge("edge_src"), G.edge("edge_dst"),
                            G.edge("edge_mask")), 2)
    agg = G.scatter(vals)
    h = G.map(lambda lp, h, a: h + C.mlp_apply(lp["node_mlp"], torch.cat([h, a], dim=-1)),
              lp, h, agg)
    return h, e


def forward(cfg: GraphCastCfg, params, g: C.GraphBatch):
    G = C.view(g)
    P = G.params(params)
    h, e = encode(cfg, params, g)
    for i in range(cfg.n_layers):
        h, e = G.remat(cfg.remat, layer, G.sub(P, lambda p: p["layers"][i]), g, h, e, G)
    return G.map(lambda p, h: C.mlp_apply(p["node_dec"], h.float()), P, h)


def loss_fn(cfg: GraphCastCfg, params, g: C.GraphBatch) -> torch.Tensor:
    out = forward(cfg, params, g)
    G = C.view(g)
    if g.labels is not None and cfg.out_dim > 1:
        return G.node_class_loss(out, G.node("labels"), G.node("node_mask"))
    return G.graph_regression_loss(out)
