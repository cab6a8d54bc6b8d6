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
  tokens_new, lengths)``, on one device.  ``lm_inputs(program, device)``
  makes seeded parameters and optimizer state, a batch, a prompt or a
  cache, at the cell's batch and length or smaller ones.

``program.fn(*inputs(...))`` runs the cell: size bytes or memory from
what the inputs hold, not from ``in_specs``.  A mesh of more than one
device for an LM program and the GNN and recsys archs are refused
(ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import base as cb
from repro_torch.core import engine as eng, k2forest
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, hybrid_ks
from repro_torch.core.query import resolve_device
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import MODEL_AXIS, Mesh
from repro_torch.models import transformer as tfm
from repro_torch.train import optim
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
    cfg: Any = None  # lm: the TransformerCfg ``fn`` runs
    opt: Any = None  # lm train: the Optimizer ``fn`` steps with


def _spec(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _lead_device(mesh: Mesh) -> torch.device:
    """The one device an LM program runs on; a larger mesh is refused."""
    if len(mesh.devices) != 1:
        raise ValueError(f"an LM program runs on one device, the mesh holds {mesh.sizes}: the "
                         "sharded LM and the expert-parallel MoE (dist/, moe_ffn_shmap) are "
                         "not ported (ROADMAP Queue 1 item 3)")
    return mesh.lead


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


def build_lm(arch: cb.ArchSpec, shape: cb.ShapeSpec, mesh: Mesh | None = None, *,
             smoke: bool = False) -> Program:
    """``train_4k``: ``fn(params, opt_state, {"tokens", "labels"} int32[B,
    S])`` -> (params, opt_state, {"loss", "grad_norm"}), one step of the
    arch's optimizer (``program.opt``), the parameters and state updated
    in place; ``prefill_32k``: ``fn(params, tokens int32[B, S])`` ->
    (logits [B, V] f32, cache); a decode shape: ``fn(params, cache [L, B,
    S, Kv, dh] bf16, tokens_new int32[B], lengths int32[B])`` -> (logits,
    cache), the cache written in place.  Smoke programs are B = 2, S = 64,
    as in the JAX builder.  ``mesh`` (default: the current card) must hold
    one device; the program runs wherever its inputs are."""
    _lead_device(meshlib.make_mesh((1, 1), ("data", MODEL_AXIS)) if mesh is None else mesh)
    cfg: tfm.TransformerCfg = arch.smoke_cfg if smoke else arch.cfg
    B, S = _lm_dims(shape, smoke)
    pspecs = tfm.param_specs(cfg, _param_dtype(arch))
    name = f"{arch.arch_id}:{shape.shape_id}"
    if shape.kind == "train":
        opt = _opt(arch)
        return Program(
            name=name, fn=make_train_step(lambda p, b: tfm.loss_fn(cfg, p, b), opt),
            in_specs=(pspecs, opt.init(pspecs), {"tokens": _spec(B, S), "labels": _spec(B, S)}),
            model_flops=lm_train_flops(cfg, B * S), cfg=cfg, opt=opt,
        )
    if shape.kind == "prefill":
        return Program(
            name=name, fn=lambda p, t: tfm.prefill(cfg, p, t), in_specs=(pspecs, _spec(B, S)),
            model_flops=2.0 * cfg.n_active_params * B * S, cfg=cfg,
        )
    return Program(
        name=name, fn=lambda p, c, t, ln: tfm.decode_step(cfg, p, c, t, ln),
        in_specs=(pspecs, tfm.KVCache.specs(cfg, B, S), _spec(B), _spec(B)),
        model_flops=2.0 * cfg.n_active_params * B
        + 4.0 * B * S * cfg.n_layers * cfg.n_kv_heads * cfg.d_head,
        cfg=cfg,
    )


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
    them."""
    dev = resolve_device(device)
    if program.cfg is None:
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
        return params, program.opt.init(params), {k: torch.from_numpy(v).to(dev)
                                                  for k, v in data.items()}
    if len(rest) == 1:
        toks = TokenStream(cfg.vocab, s, seed=seed).batch(b)["tokens"]
        return params, torch.from_numpy(toks).to(dev)
    gen.manual_seed(seed + 1)
    cache = {k: torch.randn((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head), generator=gen,
                            dtype=torch.bfloat16, device=dev) for k in ("k", "v")}
    toks = TokenStream(cfg.vocab, 1, seed=seed).batch(b)["tokens"][:, 0]
    return (params, cache, torch.from_numpy(toks).to(dev),
            torch.full((b,), s - 1, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------


def build(arch_id: str, shape_id: str, mesh: Mesh | None = None, *,
          smoke: bool = False) -> Program:
    """The program of one cell.  ``mesh`` defaults to :func:`default_mesh`
    for the engine and to the current card for an LM program."""
    if arch_id not in cb.ARCHS:
        raise KeyError(f"{arch_id!r} is not registered: the GNN and recsys archs are not "
                       "ported (ROADMAP Queue 1 item 3)")
    arch = cb.get(arch_id)
    shape = arch.shape(shape_id)
    if shape.skip:
        raise ValueError(f"{arch_id}:{shape_id} skipped: {shape.skip}")
    if arch.family == "lm":
        return build_lm(arch, shape, mesh, smoke=smoke)
    return build_engine(arch, shape, default_mesh() if mesh is None else mesh, smoke=smoke)


def all_cells(include_engine: bool = True):
    for arch_id, arch in cb.ARCHS.items():
        if arch.family == "engine" and not include_engine:
            continue
        for s in arch.shapes:
            if not s.skip:
                yield arch_id, s.shape_id
