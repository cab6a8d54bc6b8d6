"""Program builders: one (arch × shape × mesh) cell -> a runnable program.

``build(arch_id, shape_id, mesh)`` returns a :class:`Program` whose
``in_specs`` are tensors on the ``meta`` device in the JAX builder's
shapes and dtypes (uint32 words as int32): nothing is allocated.

* engine (k²-triples, the paper's program): the sharded serve step or the
  all-preds sweep.  The batch specs and the arena's tree count and level
  tables are the cell's; the arena's word widths are an estimate made
  without a store (``_engine_forest_specs``) and differ from a real
  store's.  ``inputs(program, store, mesh, batch)`` makes the concrete
  arguments on the mesh's devices, with the store's own widths.
* lm (the five transformer archs): ``train_4k`` a training step
  ``fn(params, opt_state, batch)`` of the arch's optimizer,
  ``prefill_32k`` a prefill program ``fn(params, tokens)``,
  ``decode_32k`` / ``long_500k`` a decode step ``fn(params, cache,
  tokens_new, lengths)``, on one device or, on a mesh of several, laid
  out by ``dist.sharding.spec_for`` under the shape's rules
  (``Program.in_shardings``, the JAX builder's) and run by
  ``models/transformer_mesh.py``.  ``lm_inputs(program, device)`` makes
  seeded parameters and optimizer state, a batch, a prompt or a cache, at
  the cell's batch and length or smaller ones, placed on the program's
  mesh; ``shard_params`` places a parameter tree (``params_from_arrays``'s)
  on a mesh.
* recsys (xDeepFM): ``train_batch`` a training step, ``serve_p99`` /
  ``serve_bulk`` a forward ``fn(params, ids)``, ``retrieval_cand``
  ``fn(params, user, candidates)``, on one device or a mesh (the tables'
  rows over ``model``, the batch over the data axes);
  ``recsys_inputs(program, device)`` makes seeded parameters, state and a
  ``ctr_batch``, placed on the program's mesh.

* gnn (EGNN, MACE, GraphCast, EquiformerV2): each graph shape a
  training step ``fn(params, opt_state, batch)`` of AdamW, the batch a
  ``GraphBatch``, on one device or a mesh (the JAX package's layout: node
  and edge arrays over the data axes, parameters and state replicated;
  ``models/gnn/common.py``); ``gnn_inputs(program, device)`` makes seeded
  parameters, state and the shape's graph (a full random graph, a 15-10
  fanout sample, or batched molecules), padded and placed on the mesh.

``program.fn(*inputs(...))`` runs the cell: size bytes or memory from
what the inputs hold, not from ``in_specs``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.configs import base as cb
from repro_torch.core import engine as eng, k2forest
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, hybrid_ks
from repro_torch.core.query import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Sharded
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import MODEL_AXIS, Mesh
from repro_torch.data import graphs as gdata, recsys as rdata
from repro_torch.models import transformer as tfm, transformer_mesh as tmesh
from repro_torch.models.gnn import common as gnn_common, egnn, equiformer_v2, graphcast, mace
from repro_torch.models.recsys import xdeepfm
from repro_torch.train import optim
from repro_torch.tree import keystr, leaves, tree_map
from repro_torch.train.trainer import make_train_step


class Program(NamedTuple):
    name: str
    fn: Callable
    # meta-device tensors: engine, the padded arena (word widths estimated)
    # then the batch; lm, the parameter tree then the optimizer state and
    # batch / tokens / cache, tokens, lengths
    in_specs: tuple
    meta: K2Meta | None = None  # engine: the tree geometry ``fn`` traverses
    # analytic model flops, the JAX package's figure for the same cell
    model_flops: float = 0.0
    cfg: Any = None  # lm, recsys, gnn: the model config ``fn`` runs
    opt: Any = None  # a train program: the Optimizer ``fn`` steps with
    # lm on a mesh of several devices: the mesh, the shape's sharding rules and
    # the partition spec of each ``in_specs`` leaf (the JAX builder's in_shardings)
    mesh: Mesh | None = None
    rules: dict | None = None
    in_shardings: tuple | None = None


def _spec(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def default_mesh() -> Mesh:
    """The (data, model) serve mesh over every visible card
    (:func:`launch.mesh.serve_mesh_shape`); raises without a card."""
    from repro_torch.core.query import resolve_device

    resolve_device("cuda")
    return meshlib.make_mesh(meshlib.serve_mesh_shape(torch.cuda.device_count()),
                             ("data", MODEL_AXIS))


# ---------------------------------------------------------------------------
# engine (k²-triples) programs — the paper's serving path
# ---------------------------------------------------------------------------


def _engine_forest_specs(cfg, mesh: Mesh) -> tuple[K2Meta, K2Forest]:
    """Arena specs without a store (no build, no allocation), as the JAX
    builder makes them.

    The tree count (padded to the mesh) and the level tables are exact.
    The word widths are an estimate: ~5 bits a triple (the paper's
    structure-only figure at dbpedia sparsity, Table 2) with a 4× margin.
    A real store is wider or narrower (the full config's ``t_words`` are
    about 7× the estimate's 916 words a tree);
    :func:`inputs` passes the store's own arena and checks only the tree
    count and geometry.
    """
    p_pad = _pad_to(cfg.n_preds, mesh.shape[MODEL_AXIS])
    meta = K2Meta(hybrid_ks(max(cfg.n_subjects, cfg.n_objects)))
    h = meta.n_levels
    bits_per_tree = max(4096, 20 * cfg.n_triples // cfg.n_preds)
    wt = (bits_per_tree * 3 // 4 + 31) // 32
    wl = (bits_per_tree // 4 + 31) // 32
    return meta, K2Forest(
        t_words=_spec(p_pad, wt), t_rank=_spec(p_pad, wt), l_words=_spec(p_pad, wl),
        ones_before=_spec(p_pad, max(h - 1, 1)), level_start=_spec(p_pad, h),
        nnz=_spec(p_pad),
    )


def build_engine(arch: cb.ArchSpec, shape: cb.ShapeSpec, mesh: Mesh, *,
                 smoke: bool = False) -> Program:
    """The serve step (``serve_64k``: ``fn(shards, batch)``) or the
    all-preds sweep (``unbounded_4k``: ``fn(shards, keys, axes)``) of the
    engine arch, sharded over ``mesh``; results land on ``mesh.lead``."""
    cfg = arch.smoke_cfg if smoke else arch.cfg
    meta, fspecs = _engine_forest_specs(cfg, mesh)
    b = 256 if smoke else shape.dims["batch"]
    name = f"{arch.arch_id}:{shape.shape_id}"
    if shape.dims.get("unbounded"):
        return Program(
            name=name, fn=eng.make_sharded_unbounded_scan(meta, mesh, cfg.cap),
            in_specs=(fspecs, _spec(b), _spec(b)), meta=meta,
            model_flops=2.0 * b * cfg.n_preds * cfg.cap * 4,
        )
    return Program(
        name=name, fn=eng.make_sharded_serve_step(meta, mesh, cfg.cap),
        in_specs=(fspecs, eng.ServeBatch(*(_spec(b) for _ in range(4)))), meta=meta,
        model_flops=2.0 * b * cfg.cap * meta.n_levels * 2,
    )


def inputs(program: Program, store, mesh: Mesh, batch) -> tuple:
    """The concrete arguments of ``program.fn`` for ``store`` (a
    ``K2TriplesStore`` of the program's geometry) on ``mesh`` (the one the
    program was built for): the forest padded to the model axis and
    sharded, and ``batch`` on the mesh's lead device — a ``ServeBatch``
    for the serve step, ``(keys, axes)`` for the sweep."""
    if program.meta is None:
        raise ValueError(f"{program.name} is not an engine program (see lm_inputs)")
    fspec, *bspecs = program.in_specs
    if store.meta != program.meta:
        raise ValueError(f"the store's trees {store.meta.ks} are not the program's "
                         f"{program.meta.ks}")
    f = eng.pad_preds(store.forest, mesh.shape[MODEL_AXIS])
    if f.n_preds != fspec.n_preds:
        raise ValueError(f"the store pads to {f.n_preds} trees, the program holds "
                         f"{fspec.n_preds}")
    if isinstance(bspecs[0], eng.ServeBatch):
        args = (eng.upload_batch(batch, mesh.lead),)
        lanes, want = args[0], bspecs[0].op.shape
    else:
        keys, axes = batch
        args = lanes = tuple(k2forest.as_lanes(a, mesh.lead) for a in (keys, axes))
        want = bspecs[0].shape
    if any(a.shape != want for a in lanes):
        raise ValueError(f"{program.name} takes lanes of shape {tuple(want)}, got "
                         f"{[tuple(a.shape) for a in lanes]}")
    return (eng.shard_forest(f, mesh), *args)


# ---------------------------------------------------------------------------
# LM (transformer) programs: prefill and decode on one device
# ---------------------------------------------------------------------------


def lm_train_flops(cfg: tfm.TransformerCfg, tokens: int) -> float:
    """6·N_active·tokens: a training step's model flops."""
    return 6.0 * cfg.n_active_params * tokens


def _param_dtype(arch: cb.ArchSpec) -> torch.dtype:
    return torch.bfloat16 if arch.param_dtype == "bfloat16" else torch.float32


def _lm_dims(shape: cb.ShapeSpec, smoke: bool) -> tuple[int, int]:
    return (2, 64) if smoke else (shape.dims["global_batch"], shape.dims["seq_len"])


def _opt(arch: cb.ArchSpec) -> optim.Optimizer:
    """The arch's optimizer at the reference builder's rates."""
    return optim.adafactor(1e-3) if arch.optimizer == "adafactor" else optim.adamw(3e-4)


def _mesh_specs(cfg: tfm.TransformerCfg, kind: str, mesh: Mesh, rules: dict, B: int,
                S: int, opt: optim.Optimizer | None = None) -> tuple:
    """The partition specs of an LM program's inputs at batch ``B`` and
    length ``S``, as the JAX builder's ``in_shardings``: parameters by
    ``spec_for`` over their logical axes; train, the optimizer state by
    ``spec_for`` over ``opt.state_logical_axes`` and tokens / labels over
    every data axis; prefill tokens over every data axis; a decode cache by
    ``spec_for`` over ``KV_AXES``, tokens and lengths over ``("batch",)``."""
    pspecs = tfm.param_specs(cfg)
    paxes = tfm.param_axes(pspecs)
    psh = tree_map(lambda t, ax: shd.spec_for(mesh, ax, tuple(t.shape), rules), pspecs, paxes)
    dp = meshlib.dp_axes(mesh)
    rows = ((dp if len(dp) > 1 else (dp[0] if dp else None)), None)
    if kind == "train":
        osh = tree_map(lambda t, ax: shd.spec_for(mesh, ax, tuple(t.shape), rules),
                       opt.init(pspecs), opt.state_logical_axes(paxes))
        return psh, osh, {"tokens": rows, "labels": rows}
    if kind == "prefill":
        return psh, rows
    cache = shd.spec_for(mesh, tmesh.KV_AXES, (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head),
                         rules)
    bsh = shd.spec_for(mesh, ("batch",), (B,), rules)
    return psh, {"k": cache, "v": cache}, bsh, bsh


def _check_axes(name: str, mesh: Mesh) -> None:
    if MODEL_AXIS not in mesh.shape or set(mesh.axis_names) - {"pod", "data", MODEL_AXIS}:
        raise ValueError(f"{name}: a program's mesh has a {MODEL_AXIS!r} axis and otherwise "
                         f"'pod' / 'data', not {mesh.axis_names}")


def _check_lm_mesh(cfg: tfm.TransformerCfg, shape: cb.ShapeSpec, mesh: Mesh, B: int) -> None:
    name = f"{cfg.name}:{shape.shape_id}"
    _check_axes(name, mesh)
    mp = mesh.shape[MODEL_AXIS]
    if cfg.moe and cfg.moe.n_experts % mp:
        raise ValueError(f"{name}: {cfg.moe.n_experts} experts do not split over {mp} model "
                         "shards (the expert-parallel MoE needs them to)")
    dp = mesh.size(meshlib.dp_axes(mesh))
    if shape.kind in ("prefill", "train") and B % dp:
        raise ValueError(f"{name}: a batch of {B} does not split over {dp} data slices")


def _placed(x, mesh: Mesh, spec) -> Sharded:
    """``x`` on ``mesh`` by ``spec``: a tensor is split (views on its own
    device); a ``Sharded`` must already be so."""
    if isinstance(x, Sharded):
        if x.mesh != mesh or x.spec != tuple(spec):
            raise ValueError(f"an input split as {x.spec} on {x.mesh.sizes}, the program's "
                             f"layout is {tuple(spec)} on {mesh.sizes}")
        return x
    return shd.shard(x, mesh, spec)


def _place(tree, mesh: Mesh, specs):
    """Every leaf of ``tree`` placed by the spec at its path in ``specs``."""
    return tree_map(lambda x, spec: _placed(x, mesh, spec), tree, specs)


def shard_params(params: tfm.Params, mesh: Mesh, rules: dict | None = None) -> dict:
    """A parameter tree (``tfm.init``'s or ``params_from_arrays``'s) on
    ``mesh``: each leaf split by ``spec_for`` over its logical axes under
    ``rules`` (views where the mesh names the tree's device)."""
    return tree_map(lambda t, ax: shd.shard(t, mesh, shd.spec_for(mesh, ax, tuple(t.shape), rules)),
                    params, tfm.param_axes(params))


def _place_args(cfg: tfm.TransformerCfg, mesh: Mesh, rules: dict, args, opt=None,
                memo: dict | None = None) -> tuple:
    """An LM program's arguments on ``mesh`` by the specs of their own
    shapes: tensors split (views on their own device), ``Sharded`` ones
    checked.  ``memo``: the specs already made, by (B, S) (making them
    makes ``meta`` optimizer state)."""
    kind = "train" if opt is not None else ("prefill" if len(args) == 2 else "decode")
    if kind == "train":
        B, S = args[2]["tokens"].shape
    else:
        B, S = args[1].shape if kind == "prefill" else args[1]["k"].shape[1:3]
    memo = {} if memo is None else memo
    if (B, S) not in memo:
        memo[B, S] = _mesh_specs(cfg, kind, mesh, rules, B, S, opt)
    return tuple(_place(a, mesh, sp) for a, sp in zip(args, memo[B, S]))


def _mesh_fn(cfg: tfm.TransformerCfg, kind: str, mesh: Mesh, rules: dict,
             opt: optim.Optimizer | None, memo: dict) -> Callable:
    """The program function on ``mesh``: its arguments placed by
    :func:`_place_args` (``memo`` its specs by (B, S))."""
    if kind == "train":
        run = make_train_step(partial(tmesh.loss_fn, cfg, mesh=mesh, rules=rules), opt)
    else:
        step = partial(tmesh.prefill, rules=rules) if kind == "prefill" else tmesh.decode_step
        run = partial(step, cfg, mesh=mesh)

    def fn(*args):
        return run(*_place_args(cfg, mesh, rules, args, opt, memo))
    return fn


def place(program: Program, args) -> tuple:
    """``args`` of a program placed on its mesh once, as its ``fn`` would
    place them on every call (an LM's by :func:`lm_place`, a GNN's by
    :func:`gnn_place_on`, a recsys one's by ``in_shardings``); a
    one-device program's as they are."""
    if program.mesh is None:
        return tuple(args)
    if isinstance(program.cfg, tfm.TransformerCfg):
        return lm_place(program, args)
    if isinstance(args[-1], gnn_common.GraphBatch):
        return gnn_place_on(program.mesh, program.in_shardings, args)
    return tuple(_place(a, program.mesh, sp) for a, sp in zip(args, program.in_shardings))


def lm_place(program: Program, args) -> tuple:
    """``args`` of an LM program placed on its mesh once, as its ``fn``
    would place them on every call; a one-device program's as they are."""
    if program.mesh is None:
        return tuple(args)
    return _place_args(program.cfg, program.mesh, program.rules, args, program.opt)


def build_lm(arch: cb.ArchSpec, shape: cb.ShapeSpec, mesh: Mesh | None = None, *,
             smoke: bool = False, rules: dict | None = None) -> Program:
    """``train_4k``: ``fn(params, opt_state, {"tokens", "labels"} int32[B,
    S])`` -> (params, opt_state, {"loss", "grad_norm"}), one step of the
    arch's optimizer (``program.opt``), the parameters and state updated
    in place; ``prefill_32k``: ``fn(params, tokens int32[B, S])`` ->
    (logits [B, V] f32, cache); a decode shape: ``fn(params, cache [L, B,
    S, Kv, dh] bf16, tokens_new int32[B], lengths int32[B])`` -> (logits,
    cache), the cache written in place.  Smoke programs are B = 2, S = 64,
    as in the JAX builder.

    ``mesh`` (default: the current card) of one device: the program runs
    wherever its inputs are.  Of several: the program runs on it, its
    inputs laid out by ``program.in_shardings`` (tensors are split as they
    come, ``Sharded`` ones taken as they are); logits come back [B, V] on
    the mesh's lead device, the cache as ``Sharded`` blocks, a train
    step's loss and ``grad_norm`` on the lead device, its parameters and
    state as the ``Sharded`` trees it was given, updated in place.
    ``rules`` amend the shape's sharding rules (``{"seq_sp": None}``: the
    residual stream whole in each data slice)."""
    cfg: tfm.TransformerCfg = arch.smoke_cfg if smoke else arch.cfg
    B, S = _lm_dims(shape, smoke)
    pspecs = tfm.param_specs(cfg, _param_dtype(arch))
    name = f"{arch.arch_id}:{shape.shape_id}"
    kind = {"train": "train", "prefill": "prefill"}.get(shape.kind, "decode")
    opt = _opt(arch) if kind == "train" else None
    if kind == "train":
        in_specs = (pspecs, opt.init(pspecs), {"tokens": _spec(B, S), "labels": _spec(B, S)})
    elif kind == "prefill":
        in_specs = (pspecs, _spec(B, S))
    else:
        in_specs = (pspecs, tfm.KVCache.specs(cfg, B, S), _spec(B), _spec(B))
    flops = lm_train_flops(cfg, B * S) if kind == "train" else _lm_flops(cfg, kind, B, S)
    if mesh is None:
        meshlib.make_mesh((1, 1), ("data", MODEL_AXIS))  # the current card, or raise
    elif len(mesh.devices) > 1:
        _check_lm_mesh(cfg, shape, mesh, B)
        rules = {**shape.rules_override, **(rules or {})}
        specs = {(B, S): _mesh_specs(cfg, kind, mesh, rules, B, S, opt)}
        return Program(
            name=name, fn=_mesh_fn(cfg, kind, mesh, rules, opt, specs), in_specs=in_specs,
            model_flops=flops, cfg=cfg, opt=opt, mesh=mesh, rules=rules,
            in_shardings=specs[B, S],
        )
    if kind == "train":
        fn = make_train_step(lambda p, b: tfm.loss_fn(cfg, p, b), opt)
    elif kind == "prefill":
        fn = lambda p, t: tfm.prefill(cfg, p, t)  # noqa: E731
    else:
        fn = lambda p, c, t, ln: tfm.decode_step(cfg, p, c, t, ln)  # noqa: E731
    return Program(name=name, fn=fn, in_specs=in_specs, model_flops=flops, cfg=cfg, opt=opt)


def _lm_flops(cfg: tfm.TransformerCfg, kind: str, B: int, S: int) -> float:
    """The JAX builder's model flops of a prefill or decode cell."""
    if kind == "prefill":
        return 2.0 * cfg.n_active_params * B * S
    return (2.0 * cfg.n_active_params * B
            + 4.0 * B * S * cfg.n_layers * cfg.n_kv_heads * cfg.d_head)


def lm_inputs(program: Program, device="cuda", *, seed: int = 0, batch: int | None = None,
              seq_len: int | None = None) -> tuple:
    """The concrete arguments of an LM program on ``device``: parameters
    from ``tfm.init`` with a generator on ``device`` seeded ``seed``, in
    the program's parameter dtype; then for train ``program.opt.init`` of
    them and one ``TokenStream(vocab, seq_len, seed=seed)`` batch of
    tokens and labels, for prefill ``TokenStream`` prompts, for decode a
    cache of bf16 normals (seed ``seed + 1``) of ``seq_len`` positions, one
    ``TokenStream`` token a sequence and ``lengths`` ``seq_len - 1`` (the
    new token takes the last slot).
    ``batch`` and ``seq_len`` default to the program's and may not exceed
    them.  A program on a mesh of several devices gets them made on
    ``device`` and placed on its mesh by the specs of their shapes
    (``in_shardings`` at the program's own sizes): views where the mesh
    names ``device``."""
    dev = resolve_device(device)
    if not isinstance(program.cfg, tfm.TransformerCfg):
        raise ValueError(f"{program.name} is not an LM program")
    cfg = program.cfg
    pspecs, *rest = program.in_specs
    if program.opt is not None:
        B, S = rest[1]["tokens"].shape
    else:
        B, S = rest[0].shape if len(rest) == 1 else rest[0]["k"].shape[1:3]
    b, s = B if batch is None else batch, S if seq_len is None else seq_len
    if not (1 <= b <= B and 1 <= s <= S):
        raise ValueError(f"{program.name} takes batch <= {B} and length <= {S}, "
                         f"asked for {b} x {s}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tfm.init(cfg, gen, device=dev, dtype=pspecs["embed"].dtype)
    if program.opt is not None:
        data = TokenStream(cfg.vocab, s, seed=seed).batch(b)
        args = (params, program.opt.init(params), {k: torch.from_numpy(v).to(dev)
                                                   for k, v in data.items()})
    elif len(rest) == 1:
        toks = TokenStream(cfg.vocab, s, seed=seed).batch(b)["tokens"]
        args = (params, torch.from_numpy(toks).to(dev))
    else:
        gen.manual_seed(seed + 1)
        cache = {k: torch.randn((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head), generator=gen,
                                dtype=torch.bfloat16, device=dev) for k in ("k", "v")}
        toks = TokenStream(cfg.vocab, 1, seed=seed).batch(b)["tokens"][:, 0]
        args = (params, cache, torch.from_numpy(toks).to(dev),
                torch.full((b,), s - 1, dtype=torch.int32, device=dev))
    return lm_place(program, args)


# ---------------------------------------------------------------------------
# GNN programs: a training step on one device
# ---------------------------------------------------------------------------

GNN_MODULES = {
    "mace": mace,
    "graphcast": graphcast,
    "egnn": egnn,
    "equiformer-v2": equiformer_v2,
}

# weights applied once an edge (the rest once a node), for ``model_flops``
EDGE_KEYS = ("edge_mlp", "phi_e", "phi_x", "w0", "w1_r", "w1_i", "w2_r", "w2_i", "attn",
             "radial")


def _gnn_sizes(shape: cb.ShapeSpec, smoke: bool) -> tuple[int, int, int, int, int]:
    """(nodes, edges, d_feat, n_classes, graphs) of a graph cell, as the JAX
    builder's: a fanout sample pads to seeds·Π(1+f) nodes and seeds·Σ Π f
    edges (16 seeds smoke), molecules are B x 30 nodes and B x 64 edges (B
    128, 8 smoke), a full graph is the dataset's (256 x 1,024 smoke)."""
    d = shape.dims
    if shape.shape_id == "minibatch_lg":
        seeds = 16 if smoke else d["batch_nodes"]
        f = d["fanouts"]
        n = seeds * int(np.prod([x + 1 for x in f]))
        e, m = 0, seeds
        for x in f:
            m *= x
            e += m
        return n, e, d["d_feat"], d["n_classes"], 1
    if shape.shape_id == "molecule":
        b = 8 if smoke else d["batch"]
        return b * d["n_nodes"], b * d["n_edges"], 8, 0, b
    n, e = (256, 1024) if smoke else (d["n_nodes"], d["n_edges"])
    return n, e, d["d_feat"], d["n_classes"], 1


def gnn_flops(pspecs: dict, n: int, e: int) -> float:
    """The JAX builder's model flops of a GNN training step: 2 flops a
    weight entry (the last two dimensions of a leaf of rank >= 2) a node or,
    for the ``EDGE_KEYS`` weights, an edge; x3 for forward and backward."""
    per_edge = per_node = 0
    for path, w in leaves(pspecs):
        if w.dim() < 2:
            continue
        sz = w.shape[-2] * w.shape[-1]
        if any(k in keystr(path) for k in EDGE_KEYS):
            per_edge += sz
        else:
            per_node += sz
    return 3.0 * 2.0 * (e * per_edge + n * per_node)


def _gnn_layout(in_specs, mesh: Mesh) -> tuple:
    """The JAX package's ``in_shardings`` of a GNN program's ``in_specs``:
    parameters and state replicated, every node and edge array over the
    data axes, ``graph_y`` replicated."""
    pspecs, ospecs, gb = in_specs
    dp = meshlib.dp_axes(mesh)
    data = dp if len(dp) > 1 else (dp[0] if dp else None)

    def rep(t):
        return (None,) * t.dim()

    def split(f, t):
        return rep(t) if f == "graph_y" else (data,) + (None,) * (t.dim() - 1)

    return (tree_map(rep, pspecs), tree_map(rep, ospecs),
            gnn_common.GraphBatch(*(split(f, t) for f, t in zip(gb._fields, gb))))


def _gnn_padded(mesh: Mesh | None, n: int, e: int) -> tuple[int, int]:
    """Nodes padded to the data slices, edges to data x model (the JAX
    package's rule)."""
    if mesh is None:
        return n, e
    dp = mesh.size(meshlib.dp_axes(mesh))
    return _pad_to(n, dp), _pad_to(e, dp * mesh.shape[MODEL_AXIS])


def build_gnn(arch: cb.ArchSpec, shape: cb.ShapeSpec, mesh: Mesh | None = None, *,
              smoke: bool = False) -> Program:
    """One AdamW step of a GNN arch on a graph shape: ``fn(params,
    opt_state, batch GraphBatch)`` -> (params, opt_state, {"loss",
    "grad_norm"}), the parameters and state updated in place.  The cfg
    follows the JAX builder: ``out_dim`` the shape's classes (1 without),
    ``in_dim`` its feature width where the arch has one, ``edge_chunks=128``
    at >= 10 M edges, remat off for ``ogb_products`` (full configs).
    ``in_specs`` are the batch's padded sizes; the program runs a batch of
    any size (``gnn_inputs``' cut graphs).  On a mesh of several devices
    the nodes pad to the data slices and the edges to data x model, and
    the arguments are laid out by ``program.in_shardings`` (the JAX
    package's; tensors split as they come, ``Sharded`` ones checked); the
    parameters and state come back as the ``Sharded`` trees, the metrics
    on the lead device."""
    name = f"{arch.arch_id}:{shape.shape_id}"
    if mesh is None:
        meshlib.make_mesh((1, 1), ("data", MODEL_AXIS))  # the current card, or raise
    elif len(mesh.devices) > 1:
        _check_axes(name, mesh)
    else:
        mesh = None
    mod = GNN_MODULES[arch.arch_id]
    n, e, d_feat, n_classes, n_graphs = _gnn_sizes(shape, smoke)
    n, e = _gnn_padded(mesh, n, e)
    cfg = arch.smoke_cfg if smoke else arch.cfg
    cfg = dataclasses.replace(cfg, out_dim=n_classes or 1, **(
        {"in_dim": d_feat} if hasattr(cfg, "in_dim") else {}))
    if hasattr(cfg, "edge_chunks") and not smoke and e >= 10_000_000:
        cfg = dataclasses.replace(cfg, edge_chunks=128)
    if shape.shape_id == "ogb_products" and not smoke:
        cfg = dataclasses.replace(cfg, remat=False)
    pspecs = mod.param_specs(cfg)

    def meta(*size, dtype=torch.float32):
        return torch.empty(size, dtype=dtype, device="meta")

    i32 = torch.int32
    gb = gnn_common.GraphBatch(
        node_feat=meta(n, d_feat), positions=meta(n, 3), species=meta(n, dtype=i32),
        edge_src=meta(e, dtype=i32), edge_dst=meta(e, dtype=i32), edge_feat=meta(e, 4),
        node_mask=meta(n, dtype=torch.bool), edge_mask=meta(e, dtype=torch.bool),
        labels=meta(n, dtype=i32), graph_ids=meta(n, dtype=i32), graph_y=meta(n_graphs),
    )
    opt = _opt(arch)
    step = make_train_step(partial(mod.loss_fn, cfg), opt)
    in_specs = (pspecs, opt.init(pspecs), gb)
    flops = gnn_flops(pspecs, n, e)
    if mesh is None:
        return Program(name=name, fn=step, in_specs=in_specs, model_flops=flops, cfg=cfg, opt=opt)
    specs = _gnn_layout(in_specs, mesh)

    def fn(params, opt_state, batch):
        return step(*gnn_place_on(mesh, specs, (params, opt_state, batch)))

    return Program(name=name, fn=fn, in_specs=in_specs, model_flops=flops, cfg=cfg, opt=opt,
                   mesh=mesh, in_shardings=specs)


def gnn_place_on(mesh: Mesh, specs, args) -> tuple:
    """A GNN program's (params, state, batch) on ``mesh`` by ``specs``
    (``in_shardings``): tensors split (views on their own device),
    ``Sharded`` ones checked; a batch's node and edge counts must divide
    (``gnn_pad``)."""
    params, state, batch = args
    return (_place(params, mesh, specs[0]), _place(state, mesh, specs[1]),
            gnn_common.GraphBatch(*(_placed(x, mesh, sp) for x, sp in zip(batch, specs[2]))))


def gnn_pad(batch: gnn_common.GraphBatch, n: int, e: int) -> gnn_common.GraphBatch:
    """``batch`` (tensors or numpy) padded to ``n`` nodes and ``e`` edges:
    masked nodes (label -1, graph 0) and masked edges at node 0."""
    def pad(x, to, fill=0):
        x = torch.as_tensor(x)
        if x.shape[0] == to:
            return x
        if x.shape[0] > to:
            raise ValueError(f"a batch of {x.shape[0]} rows padded to {to}")
        return torch.cat([x, x.new_full((to - x.shape[0], *x.shape[1:]), fill)])

    nodes = ("node_feat", "positions", "species", "node_mask", "graph_ids")
    edges = ("edge_src", "edge_dst", "edge_feat", "edge_mask")
    return batch._replace(**{f: pad(getattr(batch, f), n) for f in nodes},
                          **{f: pad(getattr(batch, f), e) for f in edges},
                          labels=pad(batch.labels, n, -1), graph_y=torch.as_tensor(batch.graph_y))


def gnn_graph(program: Program, *, seed: int = 0, n_nodes: int | None = None,
              n_edges: int | None = None) -> gdata.HostGraph | None:
    """The host graph a GNN program's batch comes from (None for molecules):
    ``random_graph`` at the program's node and edge counts (for
    ``minibatch_lg``, which samples from it, the dataset's, or the smoke
    full graph's 256 x 1,024 for a smoke program), or at ``n_nodes`` /
    ``n_edges``, at most those (a cut graph: the mean degree and skew kept
    by the caller's choice), with the shape's feature width and classes,
    seeded ``seed``."""
    arch_id, shape_id = program.name.split(":")
    if arch_id not in GNN_MODULES:
        raise ValueError(f"{program.name} is not a GNN program")
    shape = cb.get(arch_id).shape(shape_id)
    if shape_id == "molecule":
        if n_nodes is not None or n_edges is not None:
            raise ValueError(f"{program.name}: a molecule batch is not cut")
        return None
    gb = program.in_specs[2]
    N, E = gb.node_feat.shape[0], gb.edge_src.shape[0]
    if shape_id == "minibatch_lg":  # the host graph the seeds are drawn from
        seeds = N // int(np.prod([x + 1 for x in shape.dims["fanouts"]]))
        N, E = ((256, 1024) if seeds < shape.dims["batch_nodes"]
                else (shape.dims["n_nodes"], shape.dims["n_edges"]))
    n, e = N if n_nodes is None else n_nodes, E if n_edges is None else n_edges
    if not (1 <= n <= N and 0 <= e <= E):
        raise ValueError(f"{program.name} takes a graph of at most {N} nodes and {E} edges, "
                         f"asked for {n} x {e}")
    return gdata.random_graph(n, e, gb.node_feat.shape[1], shape.dims["n_classes"], seed=seed)


def gnn_batch(program: Program, graph: gdata.HostGraph | None, *, seed: int = 0
              ) -> gnn_common.GraphBatch:
    """A GNN program's batch (numpy) from ``graph`` (``gnn_graph``'s):
    the whole graph (``to_batch``) for a full-graph shape; for
    ``minibatch_lg`` a ``NeighborSampler`` sample (the shape's fanouts,
    seeded ``seed``) of the program's seed count drawn from ``seed``
    without replacement; for ``molecule`` ``molecule_batch`` seeded
    ``seed``, its 60 kNN edges a molecule padded with masked edges at node
    0 to the program's 64."""
    arch_id, shape_id = program.name.split(":")
    dims = cb.get(arch_id).shape(shape_id).dims
    gb = program.in_specs[2]
    N, E = gb.node_feat.shape[0], gb.edge_src.shape[0]
    if shape_id == "molecule":
        b = gdata.molecule_batch(N // dims["n_nodes"], dims["n_nodes"], dims["n_edges"],
                                 seed=seed)
        pad = E - b.edge_src.shape[0]
        return b._replace(**{k: np.concatenate([getattr(b, k), np.zeros(
            (pad, *getattr(b, k).shape[1:]), getattr(b, k).dtype)])
            for k in ("edge_src", "edge_dst", "edge_feat", "edge_mask")})
    if shape_id == "minibatch_lg":
        f = dims["fanouts"]
        seeds = N // int(np.prod([x + 1 for x in f]))
        picked = np.random.default_rng(seed).choice(graph.n_nodes, seeds, replace=False)
        return gdata.NeighborSampler(graph, f, seed=seed).sample(picked)
    return gdata.to_batch(graph, dims["n_classes"])


def gnn_inputs(program: Program, device="cuda", *, seed: int = 0, n_nodes: int | None = None,
               n_edges: int | None = None, graph: gdata.HostGraph | None = None,
               mesh: Mesh | None = None) -> tuple:
    """The concrete arguments of a GNN program on ``device``: parameters
    from the arch's ``init`` with a generator on ``device`` seeded
    ``seed``, AdamW's state, and the shape's batch (``gnn_batch``) from
    ``graph`` or, by default, ``gnn_graph(program, seed=seed, n_nodes=,
    n_edges=)`` (pass a graph built once to share it between programs).
    On ``mesh`` (default the program's own; one device: none) the batch is
    padded as the JAX package pads (``gnn_pad``: nodes to the data slices,
    edges to data x model) and everything is placed by the program's
    layout (views where the mesh names ``device``)."""
    dev = resolve_device(device)
    arch_id = program.name.split(":")[0]
    if arch_id not in GNN_MODULES:
        raise ValueError(f"{program.name} is not a GNN program")
    if graph is None:
        graph = gnn_graph(program, seed=seed, n_nodes=n_nodes, n_edges=n_edges)
    params = GNN_MODULES[arch_id].init(program.cfg, torch.Generator(device=dev).manual_seed(seed),
                                       device=dev)
    batch = gnn_batch(program, graph, seed=seed).to(dev)
    args = (params, program.opt.init(params), batch)
    mesh = program.mesh if mesh is None else mesh
    if mesh is None or len(mesh.devices) == 1:
        return args
    n, e = _gnn_padded(mesh, batch.node_feat.shape[0], batch.edge_src.shape[0])
    return gnn_place_on(mesh, _gnn_layout(program.in_specs, mesh),
                        (params, args[1], gnn_pad(batch, n, e)))


# ---------------------------------------------------------------------------
# recsys (xDeepFM) programs
# ---------------------------------------------------------------------------


def _recsys_dims(shape: cb.ShapeSpec, smoke: bool) -> tuple[int, int]:
    """(batch, candidates) of a recsys cell (the JAX builder's smoke sizes)."""
    return (64 if smoke else shape.dims["batch"],
            (4096 if smoke else shape.dims.get("n_candidates", 0)))


def _recsys_specs(cfg: xdeepfm.XDeepFMCfg, kind: str, mesh: Mesh, opt=None) -> tuple:
    """The partition specs of a recsys program's inputs, as the JAX
    builder's ``in_shardings``: parameters by ``spec_for`` (the tables'
    and the linear term's rows over ``model``), the optimizer state by
    ``state_logical_axes``; ids over the data axes, a retrieval user
    replicated and its candidates over the data axes."""
    pspecs = xdeepfm.param_specs(cfg)
    paxes = xdeepfm.param_axes(cfg)
    psh = tree_map(lambda t, ax: shd.spec_for(mesh, ax, tuple(t.shape)), pspecs, paxes)
    dp = meshlib.dp_axes(mesh)
    data = dp if len(dp) > 1 else (dp[0] if dp else None)
    if kind == "retrieval":
        return psh, (None,), (data,)
    if kind == "forward":
        return psh, (data, None)
    osh = tree_map(lambda t, ax: shd.spec_for(mesh, ax, tuple(t.shape)), opt.init(pspecs),
                   opt.state_logical_axes(paxes))
    return psh, osh, {"ids": (data, None), "labels": (data,)}


def build_recsys(arch: cb.ArchSpec, shape: cb.ShapeSpec, mesh: Mesh | None = None, *,
                 smoke: bool = False) -> Program:
    """``train_batch``: ``fn(params, opt_state, {"ids" int32[B, F],
    "labels" int32[B]})`` -> (params, opt_state, {"loss", "grad_norm"}),
    one AdamW step in place; ``serve_p99`` / ``serve_bulk``: ``fn(params,
    ids)`` -> logits [B]; ``retrieval_cand``: ``fn(params, user int32[F],
    candidates int32[N])`` -> scores [N].  Smoke programs are B = 64 and N
    = 4,096, as in the JAX builder.  ``mesh`` as :func:`build_lm`'s: on
    several devices the inputs are laid out by ``program.in_shardings``
    (tensors split as they come), results land on the lead device."""
    cfg: xdeepfm.XDeepFMCfg = arch.smoke_cfg if smoke else arch.cfg
    B, nc = _recsys_dims(shape, smoke)
    pspecs = xdeepfm.param_specs(cfg)
    name = f"{arch.arch_id}:{shape.shape_id}"
    kind = shape.kind
    opt = _opt(arch) if kind == "train" else None
    F = cfg.n_fields
    if kind == "retrieval":
        in_specs = (pspecs, _spec(F), _spec(nc))
        flops = 2.0 * nc * cfg.embed_dim
    elif kind == "forward":
        in_specs = (pspecs, _spec(B, F))
        flops = xdeepfm.flops_forward(cfg, B)
    else:
        in_specs = (pspecs, opt.init(pspecs), {"ids": _spec(B, F), "labels": _spec(B)})
        flops = 3.0 * xdeepfm.flops_forward(cfg, B)
    if mesh is None:
        meshlib.make_mesh((1, 1), ("data", MODEL_AXIS))  # the current card, or raise
    elif len(mesh.devices) > 1:
        _check_axes(name, mesh)
        dp = mesh.size(meshlib.dp_axes(mesh))
        if (nc if kind == "retrieval" else B) % dp:
            raise ValueError(f"{name}: {nc if kind == 'retrieval' else B} rows do not split "
                             f"over {dp} data slices")
        specs = _recsys_specs(cfg, kind, mesh, opt)
        run = {"retrieval": xdeepfm.retrieval_on, "forward": xdeepfm.forward_on}.get(kind)
        if run is None:
            step = make_train_step(partial(xdeepfm.loss_on, cfg, mesh=mesh), opt)
        else:
            step = partial(run, cfg, mesh=mesh)

        def fn(*args):
            return step(*(_place(a, mesh, sp) for a, sp in zip(args, specs)))

        return Program(name=name, fn=fn, in_specs=in_specs, model_flops=flops, cfg=cfg, opt=opt,
                       mesh=mesh, in_shardings=specs)
    if kind == "retrieval":
        fn = partial(xdeepfm.retrieval_score, cfg)
    elif kind == "forward":
        fn = partial(xdeepfm.forward, cfg)
    else:
        fn = make_train_step(partial(xdeepfm.loss_fn, cfg), opt)
    return Program(name=name, fn=fn, in_specs=in_specs, model_flops=flops, cfg=cfg, opt=opt)


def recsys_inputs(program: Program, device="cuda", *, seed: int = 0,
                  batch: int | None = None) -> tuple:
    """The concrete arguments of a recsys program on ``device``:
    parameters from ``xdeepfm.init`` with a generator on ``device`` seeded
    ``seed``; then for train AdamW's state and one ``ctr_batch(batch, F,
    R, seed=seed)`` of ids and labels, for a forward program that batch's
    ids, for retrieval the user of ``ctr_batch(1, ...)`` and ``batch``
    candidate rows of field 0 drawn uniformly from ``seed``.  ``batch``
    (the candidates for retrieval) defaults to the program's and may not
    exceed it.  A program on a mesh of several devices gets them placed
    by ``in_shardings`` (views where the mesh names ``device``)."""
    dev = resolve_device(device)
    cfg = program.cfg
    if not isinstance(cfg, xdeepfm.XDeepFMCfg):
        raise ValueError(f"{program.name} is not a recsys program")
    pspecs, *rest = program.in_specs
    most = rest[1]["ids"].shape[0] if program.opt is not None else rest[-1].shape[0]
    b = most if batch is None else batch
    if not 1 <= b <= most:
        raise ValueError(f"{program.name} takes at most {most} rows, asked for {b}")
    params = xdeepfm.init(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    F, R = cfg.n_fields, cfg.rows_per_field
    if len(rest) == 2 and program.opt is None:  # retrieval
        user = rdata.ctr_batch(1, F, R, seed=seed)["ids"][0]
        cands = np.random.default_rng(seed).integers(0, R, b).astype(np.int32)
        args = (params, torch.from_numpy(user).to(dev), torch.from_numpy(cands).to(dev))
    else:
        data = {k: torch.from_numpy(v).to(dev)
                for k, v in rdata.ctr_batch(b, F, R, seed=seed).items()}
        args = ((params, program.opt.init(params), data) if program.opt is not None
                else (params, data["ids"]))
    if program.mesh is None:
        return args
    return tuple(_place(a, program.mesh, sp) for a, sp in zip(args, program.in_shardings))


# ---------------------------------------------------------------------------


def build(arch_id: str, shape_id: str, mesh: Mesh | None = None, *,
          smoke: bool = False, rules: dict | None = None) -> Program:
    """The program of one cell.  ``mesh`` defaults to :func:`default_mesh`
    for the engine and to the current card for an LM, GNN or recsys
    program; ``rules`` amend an LM program's sharding rules."""
    arch = cb.get(arch_id)
    shape = arch.shape(shape_id)
    if shape.skip:
        raise ValueError(f"{arch_id}:{shape_id} skipped: {shape.skip}")
    if rules and arch.family != "lm":
        raise ValueError(f"{arch_id}: sharding rules are an LM program's option")
    if arch.family == "lm":
        return build_lm(arch, shape, mesh, smoke=smoke, rules=rules)
    if arch.family == "recsys":
        return build_recsys(arch, shape, mesh, smoke=smoke)
    if arch.family == "gnn":
        return build_gnn(arch, shape, mesh, smoke=smoke)
    return build_engine(arch, shape, default_mesh() if mesh is None else mesh, smoke=smoke)


def all_cells(include_engine: bool = True):
    for arch_id, arch in cb.ARCHS.items():
        if arch.family == "engine" and not include_engine:
            continue
        for s in arch.shapes:
            if not s.skip:
                yield arch_id, s.shape_id
