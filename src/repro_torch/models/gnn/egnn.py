"""EGNN — E(n)-equivariant GNN (Satorras et al., arXiv:2102.09844), the
JAX package's ``repro.models.gnn.egnn``.

The paper's equations (Eq. 3-6):

    m_ij  = φ_e(h_i, h_j, ‖x_i − x_j‖², a_ij)
    x_i'  = x_i + (1/C) Σ_j (x_i − x_j) · φ_x(m_ij)
    h_i'  = φ_h(h_i, Σ_j m_ij)

Equivariance comes free: only squared distances enter φ_e and coordinate
updates are radial.  Assigned config: n_layers=4, d_hidden=64.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common as C


@dataclasses.dataclass(frozen=True)
class EGNNCfg:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    in_dim: int = 16
    edge_dim: int = 0
    out_dim: int = 1
    update_coords: bool = True
    # remat a layer (recomputed in the backward); the program builder turns it
    # off for the full-batch giant graph
    remat: bool = True


def param_specs(cfg: EGNNCfg) -> dict:
    d, e = cfg.d_hidden, cfg.edge_dim
    lay = []
    for _ in range(cfg.n_layers):
        lay.append({
            "phi_e": C.mlp_specs([2 * d + 1 + e, d, d]),
            "phi_x": C.mlp_specs([d, d, 1]),
            "phi_h": C.mlp_specs([2 * d, d, d]),
        })
    return {
        "embed": C.mlp_specs([cfg.in_dim, d]),
        "layers": lay,
        "readout": C.mlp_specs([d, d, cfg.out_dim]),
    }


def _fan(shape):
    return shape[0] if len(shape) == 2 else None


def init(cfg: EGNNCfg, generator: torch.Generator, device="cuda") -> dict:
    """The reference's rule: ``normal / sqrt(fan_in)`` a weight, zero
    biases (:func:`common.random_params`)."""
    return C.random_params(param_specs(cfg), generator, device, _fan)


def params_from_arrays(cfg: EGNNCfg, tree, device="cuda") -> dict:
    return C.params_from_arrays(param_specs(cfg), tree, device)


def forward(cfg: EGNNCfg, params, g: C.GraphBatch):
    """Per-node outputs [N, out_dim]: a tensor for a batch on one device, a
    tuple of node blocks (one a position) for a batch on a mesh
    (:func:`common.view`)."""
    G = C.view(g)
    P = G.params(params)
    d = cfg.d_hidden
    h = G.map(lambda p, nf: C.mlp_apply(p["embed"], nf), P, G.node("node_feat"))
    x = G.node("positions")
    edges = (G.edge("edge_src"), G.edge("edge_dst"), G.edge("edge_feat"), G.edge("edge_mask"))

    def edge_part(lp, hf, xf, src, dst, ef, em):
        """An edge share's message, and with coordinates its update and
        degree columns, masked: [E, d (+ 3 + 1)]."""
        hs = hf.index_select(0, src)
        hd = hf.index_select(0, dst)
        xs = xf.index_select(0, src)
        xd = xf.index_select(0, dst)
        d2 = torch.sum((xd - xs) ** 2, dim=-1, keepdim=True)
        feats = [hd, hs, d2]
        if cfg.edge_dim:
            feats.append(ef)
        m = C.mlp_apply(lp["phi_e"], torch.cat(feats, dim=-1), final_act=True)
        m = m * em[:, None].to(m.dtype)
        cols = [m]
        if cfg.update_coords:
            w = C.mlp_apply(lp["phi_x"], m)  # [E, 1]
            cols += [(xd - xs) * w, xf.new_ones((m.shape[0], 1))]
        return torch.cat(cols, dim=-1) * em[:, None].to(m.dtype)

    def node_part(lp, h, x, agg):
        if cfg.update_coords:
            x = x + agg[:, d:d + 3] / torch.clamp(agg[:, d + 3:], min=1.0)
        h = h + C.mlp_apply(lp["phi_h"], torch.cat([h, agg[:, :d]], dim=-1))
        return h, x

    def one_layer(lp, h, x):
        vals = G.map(edge_part, lp, G.halo(h), G.halo(x), *edges)
        return G.unzip(G.map(node_part, lp, h, x, G.scatter(vals)), 2)

    for i in range(cfg.n_layers):
        h, x = G.remat(cfg.remat, one_layer, G.sub(P, lambda p: p["layers"][i]), h, x)
    return G.map(lambda p, h: C.mlp_apply(p["readout"], h), P, h)


def loss_fn(cfg: EGNNCfg, params, g: C.GraphBatch) -> torch.Tensor:
    out = forward(cfg, params, g)
    G = C.view(g)
    if cfg.out_dim == 1:  # graph-level energy regression
        return G.graph_regression_loss(out)
    return G.node_class_loss(out, G.node("labels"), G.node("node_mask"))
