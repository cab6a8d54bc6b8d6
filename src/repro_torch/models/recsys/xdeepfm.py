"""xDeepFM — CIN + DNN + linear CTR model (arXiv:1803.05170), the JAX
package's ``repro.models.recsys.xdeepfm``.

Assigned config: 39 sparse fields, embed_dim=10, CIN 200-200-200, DNN
400-400.  The hot path is the embedding lookup over large tables (39
tables of 10⁶ rows stacked ``[F, R, D]``): one gather a field for the
single-valued fields (``field_embed``), ``embedding_bag`` (PyTorch's
EmbeddingBag semantics) for multi-hot ones.

CIN (Compressed Interaction Network), layer k with H_k feature maps:

    x^{k+1}_n,d = Σ_{h,m} W^k_{n,h,m} · x^k_{h,d} · x^0_{m,d}

an outer product along the field axis compressed by W.  The reference
builds ``z = [B, H, F, D]`` whole; at ``serve_bulk``'s B = 262,144 a
200-map layer's ``z`` is 81.8 GB.  Here ``cin_pooled`` takes the batch in
chunks whose ``z`` stays under ``CIN_CHUNK_BYTES`` (each chunk's layer one
product ``W [N, H·F] @ z [H·F, rows·D]``); under autograd each chunk is
recomputed in the backward (``torch.utils.checkpoint``), so only its
inputs and pooled outputs are kept.  Sum-pooling over d of every layer
feeds the logit.  ``retrieval_score`` scores one user against N
candidates as one ``[N, D] @ [D]`` product.

On a mesh (``launch.programs.build_recsys``) the tables and the linear
term split their rows over ``model`` (the ``("fields", "rows", None)``
axes): each model shard gathers the rows it holds and zeroes the rest,
then a ``psum`` over ``model`` (one nonzero term a sum: exact); the dense
part is replicated and runs a position, the batch split over the data
axes; a loss or a logit is read once a data slice (its first model
shard).  The wire count (``dist.collectives``): the ``psum`` forward, the
loss's sum over the data slices, and the trainer's sums of each leaf's
gradient over its holders; the summed rows are read by the replicated dense
part alike at every model position, so their gradient needs no sum.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import resolve_device
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import Sharded, axes_of, block_index
from repro_torch.launch.mesh import dp_axes
from repro_torch.models.gnn import common as C
from repro_torch.tree import build, leaves

# the largest [rows, H, F, D] f32 intermediate a CIN chunk builds (1 GiB: with its gradient
# and the layer's output a chunk's backward holds under 3 GiB)
CIN_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class XDeepFMCfg:
    name: str = "xdeepfm"
    n_fields: int = 39
    embed_dim: int = 10
    rows_per_field: int = 1_000_000  # 10⁶–10⁹ regime; 39 tables stacked
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_dims: tuple[int, ...] = (400, 400)

    @property
    def n_params(self) -> int:
        return sum(t.numel() for _, t in leaves(param_specs(self)))


def param_specs(cfg: XDeepFMCfg) -> dict:
    """Every parameter as an f32 ``meta``-device tensor (nothing allocated)."""
    F, D, R = cfg.n_fields, cfg.embed_dim, cfg.rows_per_field

    def spec(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    cin, h_prev = [], F
    for h in cfg.cin_layers:
        cin.append(spec(h, h_prev, F))
        h_prev = h
    return {
        "tables": spec(F, R, D),
        "linear": spec(F, R),
        "cin": cin,
        "cin_out": spec(sum(cfg.cin_layers), 1),
        "dnn": C.mlp_specs([F * D, *cfg.mlp_dims, 1]),
        "bias": spec(),
    }


def param_axes(cfg: XDeepFMCfg) -> dict:
    """The logical axes of each parameter (the JAX program builder's)."""
    n = len(cfg.mlp_dims) + 1
    return {
        "tables": ("fields", "rows", None),
        "linear": ("fields", "rows"),
        "cin": [(None, None, None) for _ in cfg.cin_layers],
        "cin_out": (None, None),
        "dnn": {"w": [(None, None) for _ in range(n)], "b": [(None,) for _ in range(n)]},
        "bias": (),
    }


def init(cfg: XDeepFMCfg, generator: torch.Generator, device="cuda") -> dict:
    """Random parameters by the reference's rule: ``0.01 · normal`` for a
    leaf of rank >= 2, zeros otherwise; the normals drawn from
    ``generator`` on its own device, leaf by leaf in sorted-key order, and
    moved to ``device`` (the values are not the JAX package's)."""
    dev = resolve_device(device)

    def one(s):
        if s.dim() < 2:
            return torch.zeros(s.shape, dtype=torch.float32, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(0.01).to(dev)

    return build((path, one(s)) for path, s in leaves(param_specs(cfg)))


def params_from_arrays(cfg: XDeepFMCfg, tree, device="cuda") -> dict:
    """The JAX package's parameter tree as numpy arrays, as the port's
    tensors on ``device``; every path and shape checked against
    :func:`param_specs`."""
    return C.params_from_arrays(param_specs(cfg), tree, device)


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, bag_ids: torch.Tensor, n_bags: int,
                  weights: torch.Tensor | None = None, mode: str = "sum") -> torch.Tensor:
    """PyTorch-EmbeddingBag semantics: ``table`` [R, D], flat multi-hot
    ``ids`` with the bag each belongs to -> [n_bags, D], each bag the sum
    (``weights``-scaled) of its rows, or with ``mode="mean"`` divided by
    ``max(count, 1)``."""
    emb = table[ids.long()]
    if weights is not None:
        emb = emb * weights[:, None]
    out = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    out = out.index_add(0, bag_ids.long(), emb)
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=torch.float32, device=emb.device)
        cnt = cnt.index_add(0, bag_ids.long(), torch.ones_like(ids, dtype=torch.float32))
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def _by_field(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Field f's row ``ids[..., f]`` of table f: ``table`` [F, R, ...],
    ``ids`` int[..., F] -> [..., F, ...]."""
    f = torch.arange(table.shape[0], device=table.device)
    return table[f, ids.long()]


def field_embed(params, ids: torch.Tensor) -> torch.Tensor:
    """Single-valued fields: ids int32[B, F] -> [B, F, D]."""
    return _by_field(params["tables"], ids)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _cin_rows(ws: list[torch.Tensor], x0: torch.Tensor) -> torch.Tensor:
    """The CIN of rows ``x0`` [c, F, D]: -> every layer's maps summed over
    d, [c, Σ H_k].  A layer is one product ``W [N, H·F] @ z [H·F, c·D]``,
    ``z[h, m, b, d] = x^k[b, h, d] · x^0[b, m, d]``."""
    c, F, D = x0.shape
    x0t = x0.permute(1, 0, 2)  # [F, c, D]
    xk = x0t
    pooled = []
    for W in ws:
        N, H = W.shape[0], W.shape[1]
        z = (xk[:, None] * x0t[None]).reshape(H * F, c * D)
        xk = (W.reshape(N, H * F) @ z).reshape(N, c, D)
        pooled.append(xk.sum(dim=-1).T)
    return torch.cat(pooled, dim=-1)


def cin_chunk_rows(ws: list[torch.Tensor], x0: torch.Tensor,
                   chunk_bytes: int = CIN_CHUNK_BYTES) -> int:
    """Rows a CIN chunk takes: its widest ``z`` (H·F·D f32 a row) within
    ``chunk_bytes``."""
    F, D = x0.shape[1:]
    widest = max(W.shape[1] for W in ws) * F * D * 4
    return max(1, chunk_bytes // widest)


def cin_pooled(ws: list[torch.Tensor], x0: torch.Tensor,
               chunk_bytes: int = CIN_CHUNK_BYTES) -> torch.Tensor:
    """The CIN's pooled maps [B, Σ H_k] of ``x0`` [B, F, D], the batch in
    chunks of at most ``chunk_bytes`` of ``z``; under autograd each chunk
    is recomputed in the backward, so no chunk's ``z`` is kept."""
    rows = cin_chunk_rows(ws, x0, chunk_bytes)
    remat = torch.is_grad_enabled() and (x0.requires_grad or any(W.requires_grad for W in ws))
    out = []
    for x in x0.split(rows):
        if remat:
            out.append(checkpoint(_cin_rows, ws, x, use_reentrant=False))
        else:
            out.append(_cin_rows(ws, x))
    return torch.cat(out) if len(out) > 1 else out[0]


def _logit(params, x0: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """The logit [B] from the field embeddings [B, F, D] and the summed
    linear term [B]."""
    cin_out = (cin_pooled(params["cin"], x0) @ params["cin_out"])[:, 0]
    dnn_out = C.mlp_apply(params["dnn"], x0.reshape(x0.shape[0], -1),
                          act=torch.nn.functional.relu)[:, 0]
    return lin + cin_out + dnn_out + params["bias"]


def forward(cfg: XDeepFMCfg, params, ids: torch.Tensor) -> torch.Tensor:
    """CTR logits [B] for ids int32[B, F]."""
    return _logit(params, field_embed(params, ids), _by_field(params["linear"], ids).sum(dim=1))


def _ctr_loss(logit: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The stable logistic loss of each row."""
    y = labels.float()
    return torch.clamp(logit, min=0) - logit * y + torch.log1p(torch.exp(-logit.abs()))


def loss_fn(cfg: XDeepFMCfg, params, batch) -> torch.Tensor:
    """The mean logistic loss of ``batch`` {"ids" [B, F], "labels" [B]}."""
    return _ctr_loss(forward(cfg, params, batch["ids"]), batch["labels"]).mean()


def retrieval_score(cfg: XDeepFMCfg, params, user_ids: torch.Tensor,
                    cand_ids: torch.Tensor) -> torch.Tensor:
    """Scores of one user (ids [F]) against N candidates (field 0's table,
    the item id field): the user's mean field embedding times each
    candidate's row, [N]."""
    u = field_embed(params, user_ids[None]).reshape(-1, cfg.embed_dim).mean(dim=0)
    return params["tables"][0][cand_ids.long()] @ u


# ---------------------------------------------------------------------------
# on a mesh of several devices
# ---------------------------------------------------------------------------


_pp = col.per_position


def _masked(t: torch.Tensor, ids: torch.Tensor, r0: int, take) -> torch.Tensor:
    """``take(t, local ids)`` where a block of rows ``r0 ..`` of ``t``
    (its dimension 1) holds the id, zero elsewhere."""
    n = t.shape[1]
    local = ids.long() - r0
    got = take(t, local.clamp(0, n - 1))
    ok = (local >= 0) & (local < n)
    return torch.where(ok.reshape(ok.shape + (1,) * (got.dim() - ok.dim())), got, 0.0)


def _rows_of(table: Sharded, ids, mesh, take) -> tuple:
    """``take`` of ``ids`` (each position's) over a table whose rows split
    over the model axis: each position's row block, summed over the axes
    the rows split over."""
    rax = axes_of(table.spec[1])
    n = table.parts[0].shape[1]
    starts = [block_index(mesh, p, rax) * n for p in range(len(mesh.devices))]
    return col.psum(_pp(lambda t, i, r0: _masked(t, i, r0, take), mesh, table.parts, ids, starts),
                    mesh, rax)


def _dense_parts(params) -> tuple[list, tuple]:
    """The paths of the replicated dense parameters and each position's
    tuple of them."""
    paths = [p for p, _ in leaves(params) if p[0] not in ("tables", "linear")]
    by_path = dict(leaves(params))
    n = len(by_path[paths[0]].parts)
    return paths, tuple(tuple(by_path[p].parts[i] for p in paths) for i in range(n))


def _check_layout(params) -> None:
    for path, s in leaves(params):
        split = [d for d, e in enumerate(s.spec) if e is not None]
        if split and not (path[0] in ("tables", "linear") and split == [1]):
            raise ValueError(f"{path} split as {s.spec}: the mesh programs split only the "
                             "tables' and the linear term's rows")


def _logits_on(params, ids: Sharded, mesh) -> tuple:
    """Each position's logits of its rows of ``ids``."""
    _check_layout(params)
    x0 = _rows_of(params["tables"], ids.parts, mesh, _by_field)
    lin = _pp(lambda t: t.sum(dim=1), mesh, _rows_of(params["linear"], ids.parts, mesh, _by_field))
    paths, dense = _dense_parts(params)
    return _pp(lambda x0, lin, d: _logit(build(zip(paths, d)), x0, lin), mesh, x0, lin, dense)


def forward_on(cfg: XDeepFMCfg, params, ids: Sharded, *, mesh) -> torch.Tensor:
    """:func:`forward` on ``mesh``: ``params`` :class:`Sharded` by the
    program's layout, ``ids`` [B, F] split over the data axes; the logits
    [B] on the mesh's lead device."""
    return col.over_slices(torch.cat, _logits_on(params, ids, mesh), mesh)


def loss_on(cfg: XDeepFMCfg, params, batch, *, mesh) -> torch.Tensor:
    """:func:`loss_fn` on ``mesh``: each data slice's summed loss read once
    and divided by the global batch; differentiable in every part."""
    ids, labels = batch["ids"], batch["labels"]
    logits = _logits_on(params, ids, mesh)
    sums = _pp(lambda z, y: _ctr_loss(z, y).sum(), mesh, logits, labels.parts)
    total = col.over_slices(col.sum_in_order, sums, mesh)
    # the all-reduce over the data slices every position would run
    col.count_over("all-reduce", total.numel() * total.element_size(), mesh, dp_axes(mesh))
    return total / ids.shape[0]


def retrieval_on(cfg: XDeepFMCfg, params, user_ids: Sharded, cand_ids: Sharded, *,
                 mesh) -> torch.Tensor:
    """:func:`retrieval_score` on ``mesh``: the user (replicated) looked up
    in the row blocks; field 0's table gathered whole over the axes its rows
    split over, and each position's candidates (split over the data axes)
    taken from it (a data slice's model shards share the gather and the
    scores on one device); the scores [N] on the mesh's lead device."""
    tables = params["tables"]
    u = _rows_of(tables, _pp(lambda i: i[None], mesh, user_ids.parts), mesh, _by_field)
    u = _pp(lambda e: e.reshape(-1, cfg.embed_dim).mean(dim=0), mesh, u)
    items = col.all_gather(_pp(lambda t: t[0], mesh, tables.parts), mesh,
                           axes_of(tables.spec[1]), 0)
    scores = _pp(lambda t, i, u: t[i.long()] @ u, mesh, items, cand_ids.parts, u)
    return col.over_slices(torch.cat, scores, mesh)


def flops_forward(cfg: XDeepFMCfg, batch: int) -> float:
    """The JAX builder's model flops of a forward over ``batch`` rows."""
    F, D = cfg.n_fields, cfg.embed_dim
    cin = sum(h * hp * F * D for h, hp in zip(cfg.cin_layers, (F, *cfg.cin_layers[:-1])))
    dnn = F * D * cfg.mlp_dims[0] + sum(
        a * b for a, b in zip(cfg.mlp_dims, (*cfg.mlp_dims[1:], 1)))
    return 2.0 * batch * (F * D + cin + dnn)

