"""MACE — higher-order equivariant message passing (arXiv:2206.07697), the
JAX package's ``repro.models.gnn.mace``.

The ACE construction, per layer:

  A-basis  (one-particle):  A_i^{(c, l3 m3)} = Σ_j Σ_{l1 l2} R^{l1l2l3}_c(r_ij)
                             · CG^{l1 l2 l3}_{m1 m2 m3} Y_{l1 m1}(r̂_ij) X_j^{(c, l2 m2)}
  B-basis  (correlation ν): symmetric CG products of A with itself up to
                             correlation_order (assigned: 3)
  message:  m_i = Σ_paths W_path · B_path;   X' = Lin(m) + Lin_species(X)
  readout:  site energies from the l=0 channels, summed per graph.

CG coefficients, SH and all coupling paths come from ``so3`` (exact,
host-precomputed); device work is dense products + one segment sum per
path; a correlation-2 product is made once for the b2 path and every
correlation-3 chain that starts from it, and the chains that share their
outer product take it once.  The reference's ``.at[..., l-block].add``
updates are out-of-place block sums here, added in the reference's
order.  The species-indexed
residual mix ``Σ_c X[x, c, v] · W_res[s_x, c, d]`` runs a species at a time
on nodes sorted by species, not on a gathered [N, C, C] weight tensor
(the same products, without N·C² memory).  Assigned config: n_layers=2,
d_hidden=128 channels, l_max=2, ν=3, n_rbf=8.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from itertools import groupby

import torch

from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import so3


@dataclasses.dataclass(frozen=True)
class MACECfg:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128  # channels
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    n_species: int = 32
    out_dim: int = 1  # site-energy readout
    # remat a layer (recomputed in the backward); the program builder turns it
    # off for the full-batch giant graph
    remat: bool = True


@lru_cache(maxsize=None)
def a_paths(l_max: int) -> tuple[tuple[int, int, int], ...]:
    """(l_sh, l_node, l_out) triples for the A-basis."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, l3))
    return tuple(out)


@lru_cache(maxsize=None)
def b2_paths(l_max: int) -> tuple[tuple[int, int, int], ...]:
    """(la, lb, lout) with la <= lb (symmetric) for correlation-2 products."""
    out = []
    for la in range(l_max + 1):
        for lb in range(la, l_max + 1):
            for lo in range(abs(la - lb), min(l_max, la + lb) + 1):
                out.append((la, lb, lo))
    return tuple(out)


@lru_cache(maxsize=None)
def b3_paths(l_max: int) -> tuple[tuple[int, int, int, int, int], ...]:
    """((la, lb)->lab, lc)->lout chains for correlation-3 products."""
    out = []
    for (la, lb, lab) in b2_paths(l_max):
        for lc in range(l_max + 1):
            for lo in range(abs(lab - lc), min(l_max, lab + lc) + 1):
                out.append((la, lb, lab, lc, lo))
    return tuple(out)


def param_specs(cfg: MACECfg) -> dict:
    Cn = cfg.d_hidden
    nA, nB2, nB3 = len(a_paths(cfg.l_max)), len(b2_paths(cfg.l_max)), len(b3_paths(cfg.l_max))
    lay = []
    for _ in range(cfg.n_layers):
        lay.append({
            "radial": C.mlp_specs([cfg.n_rbf, 64, nA * Cn]),
            "w_b1": C.spec(Cn, Cn),
            "w_b2": C.spec(nB2, Cn, Cn),
            "w_b3": C.spec(nB3, Cn, Cn),
            "w_res": C.spec(cfg.n_species, Cn, Cn),
            "readout": C.mlp_specs([Cn, 16, cfg.out_dim]),
        })
    return {
        "species_embed": C.spec(cfg.n_species, Cn),
        "layers": lay,
    }


def _fan(shape):
    return max(shape[-2] if len(shape) >= 2 else shape[-1], 1)


def init(cfg: MACECfg, generator: torch.Generator, device="cuda") -> dict:
    """The reference's rule: every leaf, 1-D biases included,
    ``normal / sqrt(fan)`` with fan the second-last dimension (the last
    for a 1-D leaf) (:func:`common.random_params`)."""
    return C.random_params(param_specs(cfg), generator, device, _fan)


def params_from_arrays(cfg: MACECfg, tree, device="cuda") -> dict:
    return C.params_from_arrays(param_specs(cfg), tree, device)


def _sl(l: int) -> slice:
    return slice(l * l, (l + 1) * (l + 1))


def _cg_product(cg: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("abc,xna,xnb->xnc", cg, a, b)`` as the outer product of a and
    b over (a, b) times the flattened CG table."""
    outer = (a[..., :, None] * b[..., None, :]).flatten(-2)
    return outer @ cg.flatten(0, 1)


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("xcv,cd->xdv", x, w)``: channel mixing of irreps [X, C, v]."""
    return (x.transpose(1, 2) @ w).transpose(1, 2)


def _species_groups(species: torch.Tensor, n_species: int):
    """(order, inverse, counts): nodes sorted by species (stable), the
    permutation back, and the nodes a species (a host list).  A ``meta``
    tensor has no values: its nodes count as split evenly over the species
    (the products' shapes sum to the same flops)."""
    sp = species.long()
    order = torch.argsort(sp, stable=True)
    if sp.is_meta:
        n = sp.shape[0]
        counts = [n // n_species + (s < n % n_species) for s in range(n_species)]
    else:
        counts = torch.bincount(sp, minlength=n_species).tolist()
    return order, torch.argsort(order), counts


def _species_mix(X: torch.Tensor, w_res: torch.Tensor, groups) -> torch.Tensor:
    """``einsum("xcv,xcd->xdv", X, w_res[species])`` a species at a time."""
    order, inverse, counts = groups
    parts = [_mix(xs, w_res[s]) for s, xs in enumerate(X.index_select(0, order).split(counts))
             if xs.shape[0]]
    return torch.cat(parts).index_select(0, inverse)


def _blocks_sum(blocks: list, L: int, template: torch.Tensor) -> torch.Tensor:
    """The per-degree blocks [.., 2l+1] concatenated over l (zeros where a
    degree got no term)."""
    return torch.cat([b if b is not None else template.new_zeros(
        (*template.shape[:-1], 2 * l + 1)) for l, b in enumerate(blocks[:L + 1])], dim=-1)


def _add(blocks: list, l: int, t: torch.Tensor) -> None:
    blocks[l] = t if blocks[l] is None else blocks[l] + t


def forward(cfg: MACECfg, params, g: C.GraphBatch):
    """Site energies [N, out_dim]: a tensor for a batch on one device, a
    tuple of node blocks on a mesh (:func:`common.view`)."""
    G = C.view(g)
    P = G.params(params)
    Cn, L = cfg.d_hidden, cfg.l_max
    dim = so3.irrep_dim(L)
    N = G.n

    def geometry(pos, src, dst, em):
        rel = pos.index_select(0, dst) - pos.index_select(0, src)
        r = torch.sqrt(torch.sum(rel**2, dim=-1) + 1e-9)
        Y = so3.real_sph_harm(rel, L)  # [E, dim]
        return Y, C.bessel_rbf(r, cfg.n_rbf, cfg.r_cut), em.float()  # [E, n_rbf]

    src, dst = G.edge("edge_src"), G.edge("edge_dst")
    Y, rbf, emask = G.unzip(G.map(geometry, G.halo(G.node("positions")), src, dst,
                                  G.edge("edge_mask")), 3)
    groups = G.map(lambda sp: _species_groups(sp, cfg.n_species), G.node("species"))

    def embed(p, sp):  # node irreps: X[N, C, dim], l=0 slot from species embedding
        h0 = p["species_embed"].index_select(0, sp)  # [N, C]
        X = torch.cat([h0[..., None], h0.new_zeros((sp.shape[0], Cn, dim - 1))], dim=-1)
        return X, X.new_zeros((sp.shape[0], cfg.out_dim))

    X, site_e = G.unzip(G.map(embed, P, G.node("species")), 2)
    pathsA = a_paths(L)

    def a_partial(lp, Xf, Y, rbf, emask, src, dst):
        """The A-basis summed over an edge share into every node [N, C, dim]."""
        dev = Xf.device
        Rw = C.mlp_apply(lp["radial"], rbf).reshape(-1, len(pathsA), Cn)  # [E, nA, C]
        Xs = Xf.index_select(0, src)  # [E, C, dim]
        A = [None] * (L + 1)
        for pi, (l1, l2, l3) in enumerate(pathsA):
            cg = so3.cg_tensor(l1, l2, l3, dev)
            # einsum("abc,ea,exb->exc"): Y's degree-l1 block into the CG table, then
            # each edge's [C, 2l2+1] by its [2l2+1, 2l3+1]
            t = torch.einsum("abc,ea->ebc", cg, Y[:, _sl(l1)])
            contrib = torch.bmm(Xs[:, :, _sl(l2)], t)  # [E, C, 2l3+1]
            contrib = contrib * (Rw[:, pi, :] * emask[:, None])[:, :, None]
            _add(A, l3, C.segment_sum(contrib, dst, N))
        return _blocks_sum(A, L, Xf)

    def node_part(lp, A, X, site_e, groups):
        dev = X.device
        # B-basis: correlation 1..3 with per-path channel mixing
        msg = list(_mix(A, lp["w_b1"]).split([2 * l + 1 for l in range(L + 1)], dim=-1))
        prods = {}  # (la, lb, lab): the correlation-2 product a chain starts from
        for pi, (la, lb, lo) in enumerate(b2_paths(L)):
            prods[la, lb, lo] = _cg_product(so3.cg_tensor(la, lb, lo, dev), A[:, :, _sl(la)],
                                            A[:, :, _sl(lb)])
            _add(msg, lo, _mix(prods[la, lb, lo], lp["w_b2"][pi]))
        if cfg.correlation >= 3:
            # the chains that share (la, lb, lab, lc) share their outer product: one
            # product with their CG tables side by side, split by lout
            for (la, lb, lab, lc), group in groupby(enumerate(b3_paths(L)), key=lambda t: t[1][:4]):
                group = list(group)
                cgs = [so3.cg_tensor(lab, lc, p[4], dev) for _, p in group]
                p3s = _cg_product(torch.cat(cgs, dim=-1), prods[la, lb, lab], A[:, :, _sl(lc)])
                for (pi, (*_, lo)), p3 in zip(group, p3s.split([c.shape[-1] for c in cgs], -1)):
                    _add(msg, lo, _mix(p3, lp["w_b3"][pi]))

        X = torch.cat(msg, dim=-1) + _species_mix(X, lp["w_res"], groups)
        site_e = site_e + C.mlp_apply(lp["readout"], X[:, :, 0])
        return X, site_e

    def one_layer(lp, X, site_e):
        A = G.reduce(G.map(a_partial, lp, G.halo(X), Y, rbf, emask, src, dst))
        return G.unzip(G.map(node_part, lp, A, X, site_e, groups), 2)

    for i in range(cfg.n_layers):
        X, site_e = G.remat(cfg.remat, one_layer, G.sub(P, lambda p: p["layers"][i]), X, site_e)

    return site_e


def loss_fn(cfg: MACECfg, params, g: C.GraphBatch) -> torch.Tensor:
    out = forward(cfg, params, g)
    G = C.view(g)
    if cfg.out_dim == 1:
        return G.graph_regression_loss(out)
    return G.node_class_loss(out, G.node("labels"), G.node("node_mask"))
