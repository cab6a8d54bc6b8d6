"""EquiformerV2 — equivariant graph attention via eSCN convolutions
(arXiv:2306.12059), the JAX package's ``repro.models.gnn.equiformer_v2``.

The eSCN trick: rotate each edge's irreps into the frame where the edge
points along +z; there the SO(3) tensor-product convolution becomes an SO(2)
linear layer coupling only (+m, −m) pairs, and restricting to m ≤ m_max
(assigned: 2) turns the O(L⁶) CG contraction into dense products.  Per block:

  1. per-edge Wigner rotation to the edge frame (``so3.align_blocks``,
     computed once a forward: ``edge_rotation``);
  2. SO(2) convolution over concatenated (src ‖ dst) features for
     m = 0..m_max, with a radial gate on the output;
  3. multi-head attention: logits from the m=0 (invariant) channel,
     softmax over each destination's incoming edges (segment max/sum);
  4. rotate messages back, aggregate, residual; then an S2-style gated FFN.

With ``edge_chunks > 1`` the attention runs over edge chunks with an
online softmax, as a :class:`torch.autograd.Function` (the reference's
custom VJP): its forward keeps only node-sized statistics, its backward
recomputes each chunk's messages.  On a mesh (``common.OnMesh``) each
position runs the sweep over its edge share into whole-graph running
(max, sum, acc) statistics (:class:`_ChunkedPartial`), which are combined
over the mesh: ``m = pmax(m_s)``, ``l = Σ l_s·exp(m_s − m)``, ``acc = Σ
acc_s·exp(m_s − m)`` summed into the node blocks; the one-chunk softmax
takes the global segment max the same way.  Assigned config: n_layers=12,
d_hidden=128, l_max=6, m_max=2, n_heads=8.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from repro_torch.models.gnn import common as C
from repro_torch.models.gnn import so3
from repro_torch.tree import build, leaves


@dataclasses.dataclass(frozen=True)
class EquiformerV2Cfg:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128  # channels per irrep degree
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    r_cut: float = 6.0
    n_species: int = 32
    out_dim: int = 1
    # process edges in chunks with ONLINE-softmax attention: the per-layer
    # [E, C, (L+1)²] edge working set shrinks by edge_chunks×
    edge_chunks: int = 1
    # remat a layer (recomputed in the backward); the program builder turns it
    # off for the full-batch giant graph
    remat: bool = True


def _n_l(cfg, m):  # number of degrees carrying an |m| component
    return cfg.l_max + 1 - m


def param_specs(cfg: EquiformerV2Cfg) -> dict:
    Cn = cfg.d_hidden
    lay = []
    for _ in range(cfg.n_layers):
        d: dict = {
            "radial": C.mlp_specs([cfg.n_rbf, 64, Cn]),
            "attn": C.mlp_specs([Cn + cfg.n_rbf, 64, cfg.n_heads]),
            "out_proj": C.spec(Cn, Cn),
            "ffn_gate": C.mlp_specs([Cn, Cn, (cfg.l_max + 1) * Cn]),
            "ffn_l0": C.mlp_specs([Cn, Cn, Cn]),
        }
        # SO(2) conv weights: m=0 real; m>0 a (W1, W2) pair
        two = 2 * Cn  # src ‖ dst concat
        d["w0"] = C.spec(_n_l(cfg, 0) * two, _n_l(cfg, 0) * Cn)
        for m in range(1, cfg.m_max + 1):
            nl = _n_l(cfg, m)
            d[f"w{m}_r"] = C.spec(nl * two, nl * Cn)
            d[f"w{m}_i"] = C.spec(nl * two, nl * Cn)
        lay.append(d)
    return {
        "species_embed": C.spec(cfg.n_species, Cn),
        "feat_embed": C.mlp_specs([cfg.n_rbf, Cn]),  # placeholder edge-degree feat
        "layers": lay,
        "readout": C.mlp_specs([Cn, Cn, cfg.out_dim]),
    }


def _fan(shape):
    return max(shape[0], 1) if len(shape) >= 2 else None


def init(cfg: EquiformerV2Cfg, generator: torch.Generator, device="cuda") -> dict:
    """The reference's rule: ``normal / sqrt(shape[0])`` a leaf of rank >= 2,
    zeros otherwise (:func:`common.random_params`)."""
    return C.random_params(param_specs(cfg), generator, device, _fan)


def params_from_arrays(cfg: EquiformerV2Cfg, tree, device="cuda") -> dict:
    return C.params_from_arrays(param_specs(cfg), tree, device)


def _m_index(cfg, m):
    """Flat irrep indices of the +m and -m components across degrees."""
    plus = [l * l + l + m for l in range(m, cfg.l_max + 1)]
    minus = [l * l + l - m for l in range(m, cfg.l_max + 1)]
    return np.array(plus), np.array(minus)


@lru_cache(maxsize=None)
def _conv_layout(cfg: EquiformerV2Cfg) -> tuple[list, np.ndarray]:
    """The SO(2) conv's components (|m| <= m_max) in the order the conv
    reads and writes them: m = 0, then +1, -1, +2, -2, ... each over its
    degrees; -> the index groups and their concatenation (flat irrep
    indices)."""
    idx = [_m_index(cfg, 0)[0]]
    for m in range(1, cfg.m_max + 1):
        idx += list(_m_index(cfg, m))
    return idx, np.concatenate(idx)


def edge_rotation(cfg: EquiformerV2Cfg, rel: torch.Tensor) -> torch.Tensor:
    """The rows of each edge's rotation to its frame (``so3.align_blocks``)
    that the conv reads: R [E, K, (L+1)²] with row k the component
    ``_conv_layout(cfg)[1][k]`` (zero outside its degree's block).  It
    depends on the geometry alone, so a forward computes it once for every
    layer and chunk; ``x @ Rᵀ`` rotates irreps x [E, C, (L+1)²] to the
    conv's components, ``y @ R`` rotates the conv's output back."""
    L = cfg.l_max
    blocks = so3.align_blocks(rel, L)
    _, flat = _conv_layout(cfg)
    R = rel.new_zeros((rel.shape[0], flat.shape[0], so3.irrep_dim(L)))
    for l, D in enumerate(blocks):
        ks = [k for k, f in enumerate(flat) if l * l <= f < (l + 1) ** 2]
        rows = torch.as_tensor(flat[ks] - l * l, device=rel.device)
        R[:, ks, l * l:(l + 1) ** 2] = D.index_select(1, rows)
    return R


NEG = -1e30


def _edge_messages(cfg, lp, xs, xd, R_c, rbf_c, em_c):
    """Per-edge eSCN conv + attention logits for one edge block, from the
    gathered source and destination irreps xs, xd [Ec, C, dim] and the
    edges' rotation rows ``R_c`` (``edge_rotation``).

    Returns (msg [Ec, C, dim] rotated back to the global frame,
    logits [Ec] — head-averaged invariant attention logits, masked to NEG).
    The conv's output is zero past ``m_max``, so only its components are
    rotated (the reference rotates every component, then reads these).
    """
    Cn = cfg.d_hidden
    Ec = xs.shape[0]
    Rt = R_c.transpose(1, 2)
    cat = torch.cat([xs @ Rt, xd @ Rt], dim=1)  # [Ec, 2C, K] in the edge frame

    idx, _ = _conv_layout(cfg)
    ends = np.cumsum([0] + [len(i) for i in idx])
    group = [cat[:, :, ends[i]:ends[i + 1]].reshape(Ec, -1) for i in range(len(idx))]
    parts = [(group[0] @ lp["w0"]).reshape(Ec, Cn, len(idx[0]))]
    for m in range(1, cfg.m_max + 1):  # SO(2) complex-pair mixing
        n = len(idx[2 * m - 1])
        xp, xm = group[2 * m - 1], group[2 * m]
        parts.append((xp @ lp[f"w{m}_r"] - xm @ lp[f"w{m}_i"]).reshape(Ec, Cn, n))
        parts.append((xp @ lp[f"w{m}_i"] + xm @ lp[f"w{m}_r"]).reshape(Ec, Cn, n))
    y = torch.cat(parts, dim=-1) * C.mlp_apply(lp["radial"], rbf_c)[:, :, None]
    inv = y[:, :, 0]  # invariant channel (l = 0, m = 0) after conv
    logits = C.mlp_apply(lp["attn"], torch.cat([inv, rbf_c], dim=-1)).mean(-1)
    logits = torch.where(em_c > 0, logits, NEG)
    return y @ R_c, logits


def _agg_sweep(cfg, lp, X, chunks, N):
    """Forward chunk sweep with online softmax.  Returns (acc, m, l): the
    messages weighted by ``exp(logit - m)`` summed into every node, the
    running max and the weights' sum."""
    Cn, dim = cfg.d_hidden, so3.irrep_dim(cfg.l_max)
    m = X.new_full((N,), NEG)
    l = X.new_zeros((N,))
    acc = X.new_zeros((N, Cn, dim))
    for src_c, dst_c, R_c, rbf_c, em_c in zip(*chunks):
        msg, logits = _edge_messages(cfg, lp, X.index_select(0, src_c), X.index_select(0, dst_c),
                                     R_c, rbf_c, em_c)
        m_new = torch.maximum(m, C.segment_max(logits, dst_c, N))
        corr = torch.exp(m - m_new)
        a = torch.exp(logits - m_new.index_select(0, dst_c)) * em_c
        l = l * corr + C.segment_sum(a, dst_c, N)
        acc.mul_(corr[:, None, None]).index_add_(0, dst_c, msg * a[:, None, None])
        m = m_new
    return acc, m, l


def _agg_fwd(cfg, lp, X, chunks, N):
    """Forward chunk sweep with online softmax. Returns (agg, m, l)."""
    acc, m, l = _agg_sweep(cfg, lp, X, chunks, N)
    return acc.div_(torch.clamp(l, min=1e-9)[:, None, None]), m, l


def _agg_bwd(cfg, paths, chunks, X, m, dacc, dl, lp_leaves):
    """(dX, d leaves) of ``acc`` and ``l`` of :func:`_agg_sweep` (``m`` a
    constant) for their cotangents ``dacc`` [N, C, dim] and ``dl`` [N]:
    each chunk's messages recomputed and pulled through."""
    dX = torch.zeros_like(X)
    dlp = [torch.zeros_like(t) for t in lp_leaves]
    for src_c, dst_c, R_c, rbf_c, em_c in zip(*chunks):
        with torch.enable_grad():
            xs = X.index_select(0, src_c).requires_grad_()
            xd = X.index_select(0, dst_c).requires_grad_()
            leaves_ = [t.detach().requires_grad_() for t in lp_leaves]
            msg, logits = _edge_messages(cfg, build(zip(paths, leaves_)), xs, xd,
                                         R_c, rbf_c, em_c)
            a = torch.exp(logits - m.index_select(0, dst_c)) * em_c
            grads = torch.autograd.grad(
                (msg * a[:, None, None], a), [xs, xd, *leaves_],
                (dacc.index_select(0, dst_c), dl.index_select(0, dst_c)), allow_unused=True)
        dX.index_add_(0, src_c, grads[0]).index_add_(0, dst_c, grads[1])
        for d, g in zip(dlp, grads[2:]):
            if g is not None:
                d.add_(g)
    return dX, dlp


class _ChunkedAgg(torch.autograd.Function):
    """Flash-style attention over edge chunks (the reference's
    ``_chunked_agg`` custom VJP).  The forward runs without a graph and saves
    only node-sized tensors (``m``, ``l``, ``agg``) and the inputs; the
    backward recomputes each chunk's messages and pulls the cotangents through:

      agg = acc / l,  acc = Σ_chunks accpart(logits, msg),  l = Σ_chunks lpart
      dacc = dagg / l
      dl   = -(dagg · agg) / l        (per node)
      m is a constant of the softmax (standard max-subtraction backward).

    A chunk's ``accpart`` / ``lpart`` are segment sums of ``msg · a`` / ``a``
    into the destinations, so their cotangents are ``dacc`` / ``dl``
    gathered at each edge's destination; the gradient of the gathered
    source and destination irreps is added into ``dX`` by edge, with no
    node-sized tensor a chunk.  No gradient flows to the chunk arrays (the
    reference's backward gives them zeros)."""

    @staticmethod
    def forward(ctx, cfg, N, paths, chunks, X, *lp_leaves):
        lp = build(zip(paths, lp_leaves))
        agg, m, l = _agg_fwd(cfg, lp, X, chunks, N)
        ctx.cfg, ctx.N, ctx.paths, ctx.chunks = cfg, N, paths, chunks
        ctx.save_for_backward(X, m, l, agg, *lp_leaves)
        return agg

    @staticmethod
    def backward(ctx, dagg):
        X, m, l, agg, *lp_leaves = ctx.saved_tensors
        linv = 1.0 / torch.clamp(l, min=1e-9)
        dacc = dagg * linv[:, None, None]
        dl = -torch.sum(dagg * agg, dim=(1, 2)) * linv
        dX, dlp = _agg_bwd(ctx.cfg, ctx.paths, ctx.chunks, X, m, dacc, dl, lp_leaves)
        return (None, None, None, None, dX, *dlp)


class _ChunkedPartial(torch.autograd.Function):
    """One mesh position's sweep over its edge share: the unnormalised
    (acc [N, C, dim], l [N], m [N]) of :func:`_agg_sweep`, every node of the
    graph; ``m`` has no gradient (the softmax's shift), the backward
    recomputes each chunk (:func:`_agg_bwd`)."""

    @staticmethod
    def forward(ctx, cfg, N, paths, chunks, X, *lp_leaves):
        acc, m, l = _agg_sweep(cfg, build(zip(paths, lp_leaves)), X, chunks, N)
        ctx.cfg, ctx.paths, ctx.chunks = cfg, paths, chunks
        ctx.save_for_backward(X, m, *lp_leaves)
        ctx.mark_non_differentiable(m)
        return acc, l, m

    @staticmethod
    def backward(ctx, dacc, dl, _dm):
        X, m, *lp_leaves = ctx.saved_tensors
        N = X.shape[0]
        dacc = dacc if dacc is not None else X.new_zeros((N, *X.shape[1:]))
        dl = dl if dl is not None else X.new_zeros((N,))
        dX, dlp = _agg_bwd(ctx.cfg, ctx.paths, ctx.chunks, X, m, dacc, dl, lp_leaves)
        return (None, None, None, None, dX, *dlp)


def _chunked_agg(cfg, lp, X, chunks, N):
    paths, lp_leaves = zip(*leaves(lp))
    return _ChunkedAgg.apply(cfg, N, paths, chunks, X, *lp_leaves)


def _dense_agg(G, cfg, lp, Xf, geo, N):
    """The one-chunk attention: softmax over each destination's edges, the
    segment max taken over the whole graph (``G.pmax``)."""
    src, dst, R, rbf, emask = geo
    msg, logits = G.unzip(G.map(
        lambda lp, Xf, src, dst, R, rbf, em: _edge_messages(
            cfg, lp, Xf.index_select(0, src), Xf.index_select(0, dst), R, rbf, em),
        lp, Xf, src, dst, R, rbf, emask), 2)
    lmax = G.pmax(G.map(lambda lg, dst: C.segment_max(lg, dst, N), logits, dst))

    def weigh(msg, lg, lmax, dst, em):
        a = torch.exp(lg - lmax.index_select(0, dst)) * em
        return msg * a[:, None, None], a

    num, a = G.unzip(G.map(weigh, msg, logits, lmax, dst, emask), 2)
    den = G.scatter(a)
    return G.map(lambda n, d: n / torch.clamp(d, min=1e-9)[:, None, None], G.scatter(num), den)


def _mesh_chunked_agg(G, cfg, lp, Xf, chunks, N):
    """The chunked attention on a mesh: each position's running statistics
    (:class:`_ChunkedPartial`) combined over the mesh into node blocks."""
    def sweep(lp, Xf, ch):
        paths, lp_leaves = zip(*leaves(lp))
        return _ChunkedPartial.apply(cfg, N, paths, ch, Xf, *lp_leaves)

    acc, l, m_s = G.unzip(G.map(sweep, lp, Xf, chunks), 3)
    m = G.pmax(m_s)
    w = G.map(lambda ms, mm: torch.exp(ms - mm), m_s, m)
    acc = G.reduce(G.map(lambda a, w: a * w[:, None, None], acc, w))
    l = G.reduce(G.map(lambda l, w: l * w, l, w))
    return G.map(lambda a, l: a / torch.clamp(l, min=1e-9)[:, None, None], acc, l)


def forward(cfg: EquiformerV2Cfg, params, g: C.GraphBatch):
    """Per-node outputs [N, out_dim]: a tensor for a batch on one device, a
    tuple of node blocks on a mesh (:func:`common.view`)."""
    G = C.view(g)
    P = G.params(params)
    N = G.n
    Cn, L = cfg.d_hidden, cfg.l_max
    dim = so3.irrep_dim(L)

    def geometry(pos, src, dst, em):
        rel = pos.index_select(0, dst) - pos.index_select(0, src)
        r = torch.sqrt(torch.sum(rel**2, dim=-1) + 1e-9)
        # the rotation once for every layer
        return C.bessel_rbf(r, cfg.n_rbf, cfg.r_cut), em.float(), edge_rotation(cfg, rel)

    src, dst = G.edge("edge_src"), G.edge("edge_dst")
    rbf, emask, R = G.unzip(G.map(geometry, G.halo(G.node("positions")), src, dst,
                                  G.edge("edge_mask")), 3)

    def embed(p, sp):
        h0 = p["species_embed"].index_select(0, sp)
        return torch.cat([h0[..., None], h0.new_zeros((sp.shape[0], Cn, dim - 1))], dim=-1)

    X = G.map(embed, P, G.node("species"))

    nc = max(1, cfg.edge_chunks)
    if nc > 1 and not isinstance(G, C.Local):
        # a position's edge share in chunks of the one-device size (as many
        # chunk passes in all as on one device)
        nc = max(1, -(-nc // len(G.mesh.devices)))
        chunked = True
    else:
        chunked = nc > 1
    if chunked:  # pad + block the edge arrays once (padding: node 0, mask 0)
        def blocks(t):  # padded edges: node 0, mask 0, a zero rotation
            pad = (-t.shape[0]) % nc
            t = torch.nn.functional.pad(t, (0, 0) * (t.dim() - 1) + (0, pad))
            return t.reshape(nc, -1, *t.shape[1:]).unbind(0)

        chunks = G.map(lambda *ts: tuple(blocks(t) for t in ts), src, dst, R, rbf, emask)
    gate_width = [2 * l + 1 for l in range(L + 1)]

    def node_part(lp, X, agg):
        X = X + (agg.transpose(1, 2) @ lp["out_proj"]).transpose(1, 2)

        # S2-gated FFN: per-degree scalar gates from the invariant channel
        inv_n = X[:, :, 0]
        gates = torch.sigmoid(C.mlp_apply(lp["ffn_gate"], inv_n).reshape(-1, Cn, L + 1))
        scale = gates.repeat_interleave(torch.as_tensor(gate_width, device=X.device), dim=2,
                                        output_size=dim)
        X = X * scale
        return torch.cat([X[:, :, :1] + C.mlp_apply(lp["ffn_l0"], inv_n)[..., None],
                          X[:, :, 1:]], dim=-1)

    def one_layer(lp, X):
        Xf = G.halo(X)
        if not chunked:
            agg = _dense_agg(G, cfg, lp, Xf, (src, dst, R, rbf, emask), N)
        elif isinstance(G, C.Local):
            agg = _chunked_agg(cfg, lp, Xf, chunks, N)
        else:
            agg = _mesh_chunked_agg(G, cfg, lp, Xf, chunks, N)
        return G.map(node_part, lp, X, agg)

    for i in range(cfg.n_layers):
        X = G.remat(cfg.remat, one_layer, G.sub(P, lambda p: p["layers"][i]), X)

    return G.map(lambda p, X: C.mlp_apply(p["readout"], X[:, :, 0]), P, X)


def loss_fn(cfg: EquiformerV2Cfg, params, g: C.GraphBatch) -> torch.Tensor:
    out = forward(cfg, params, g)
    G = C.view(g)
    if cfg.out_dim == 1:
        return G.graph_regression_loss(out)
    return G.node_class_loss(out, G.node("labels"), G.node("node_mask"))
