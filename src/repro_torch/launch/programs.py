"""Program builders: one (arch × shape × mesh) cell -> a runnable program.

``build(arch_id, shape_id, mesh)`` returns a :class:`Program` whose
``in_specs`` are tensors on the ``meta`` device, the JAX builder's specs
(uint32 words as int32): nothing is allocated.  The batch specs and the
arena's tree count and level tables are the cell's; the arena's word
widths are an estimate made without a store (``_engine_forest_specs``)
and differ from a real store's.  ``inputs(program, store, mesh, batch)``
makes the concrete arguments on the mesh's devices, with the store's own
widths, and ``program.fn(*inputs(...))`` runs the cell: size bytes or
memory from what ``inputs`` returns, not from ``in_specs``.

Cell kinds: engine — sharded SPARQL serve batches (the paper's program).
The LM, GNN and recsys builders are not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs import base as cb
from repro_torch.core import engine as eng, k2forest
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, hybrid_ks
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import MODEL_AXIS, Mesh


class Program(NamedTuple):
    name: str
    fn: Callable
    # meta-device tensors: the padded arena (word widths estimated), then the batch
    in_specs: tuple
    meta: K2Meta  # the tree geometry ``fn`` traverses
    # analytic model flops, the JAX package's figure for the same cell
    model_flops: float = 0.0


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


def build(arch_id: str, shape_id: str, mesh: Mesh | None = None, *,
          smoke: bool = False) -> Program:
    """The program of one cell; ``mesh`` defaults to :func:`default_mesh`."""
    if arch_id not in cb.ARCHS:
        raise KeyError(f"{arch_id!r} is not registered: only the engine family is "
                       "ported (LM, GNN and recsys wait for ROADMAP Queue 1 item 3)")
    arch = cb.get(arch_id)
    return build_engine(arch, arch.shape(shape_id),
                        default_mesh() if mesh is None else mesh, smoke=smoke)


def all_cells():
    for arch_id, arch in cb.ARCHS.items():
        for s in arch.shapes:
            yield arch_id, s.shape_id
