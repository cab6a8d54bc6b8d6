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


def forward(cfg: EGNNCfg, params, g: C.GraphBatch) -> torch.Tensor:
    n = g.node_feat.shape[0]
    h = C.mlp_apply(params["embed"], g.node_feat)
    x = g.positions

    def one_layer(lp, h, x):
        hs = h.index_select(0, g.edge_src)
        hd = h.index_select(0, g.edge_dst)
        xs = x.index_select(0, g.edge_src)
        xd = x.index_select(0, g.edge_dst)
        d2 = torch.sum((xd - xs) ** 2, dim=-1, keepdim=True)
        feats = [hd, hs, d2]
        if cfg.edge_dim:
            feats.append(g.edge_feat)
        m = C.mlp_apply(lp["phi_e"], torch.cat(feats, dim=-1), final_act=True)
        m = m * g.edge_mask[:, None].to(m.dtype)
        if cfg.update_coords:
            w = C.mlp_apply(lp["phi_x"], m)  # [E, 1]
            dx = C.scatter_edges((xd - xs) * w, g.edge_dst, n, g.edge_mask)
            deg = C.scatter_edges(x.new_ones((m.shape[0], 1)), g.edge_dst, n, g.edge_mask)
            x = x + dx / torch.clamp(deg, min=1.0)
        agg = C.scatter_edges(m, g.edge_dst, n, g.edge_mask)
        h = h + C.mlp_apply(lp["phi_h"], torch.cat([h, agg], dim=-1))
        return h, x

    for lp in params["layers"]:
        h, x = C.remat(cfg.remat, one_layer, lp, h, x)
    return C.mlp_apply(params["readout"], h)


def loss_fn(cfg: EGNNCfg, params, g: C.GraphBatch) -> torch.Tensor:
    out = forward(cfg, params, g)
    if cfg.out_dim == 1:  # graph-level energy regression
        return C.graph_regression_loss(out, g)
    return C.node_class_loss(out, g.labels, g.node_mask)
