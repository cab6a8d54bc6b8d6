"""The arch registry and the engine program builder of ``repro_torch``
against the JAX package's ``repro.configs`` / ``repro.launch.programs``:

* ``ARCHS["k2triples"]`` field by field (cfg, smoke cfg, shapes, dims,
  source), ``all_cells()``, and ``build``'s refusal of a family the port
  lacks;
* ``build_engine``'s meta-device ``in_specs`` against the JAX
  ``ShapeDtypeStruct``s (uint32 as int32) for both shapes, smoke and
  full, on (1, 1) and (2, 4) meshes, and ``model_flops``;
* the smoke cells run for real: the smoke store on a (1, 1) and a (2, 4)
  mesh of the ``cpu`` device against the JAX program's ``fn`` on a (1, 1)
  JAX mesh, every field exact (``serve_64k`` at B = 256 with all six ops;
  ``unbounded_4k`` at B = 256).  The JAX side traces with
  ``REPRO_SCAN_BACKEND=jnp`` (its traversal reference; the Pallas kernels
  give the same bits, ``tests/test_k2_scan.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.core import engine as jeng, k2triples as jk2triples
from repro.data import rdf as jrdf
from repro.launch import programs as jprograms
from repro_torch.configs import ARCHS
from repro_torch.core import engine as eng, k2triples
from repro_torch.data import rdf
from repro_torch.launch import mesh as meshlib, programs

SHAPES = ("serve_64k", "unbounded_4k")
MESHES = ((1, 1), (2, 4))


def _jax_mesh(shape):
    return AbstractMesh(shape, ("data", "model"))


def _mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _same_fields(got, want):
    """Every field of the port's dataclass equals the JAX one's; the JAX
    class may hold more (fields of the families not ported)."""
    jfields = {f.name for f in dataclasses.fields(want)}
    for f in dataclasses.fields(got):
        assert f.name in jfields, f.name
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_registry_like_jax():
    spec, jspec = ARCHS["k2triples"], JARCHS["k2triples"]
    for f in dataclasses.fields(spec):
        got, want = getattr(spec, f.name), getattr(jspec, f.name)
        if f.name in ("cfg", "smoke_cfg"):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        elif f.name == "shapes":
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _same_fields(g, w)
                assert not w.skip and not w.rules_override
        else:
            assert got == want, f.name
    assert spec.source == "this paper" and spec.shape("unbounded_4k").dims["unbounded"] == 1
    with pytest.raises(KeyError):
        spec.shape("decode_32k")
    assert set(ARCHS) == {"k2triples"}
    assert list(programs.all_cells()) == [
        c for c in jprograms.all_cells() if JARCHS[c[0]].family == "engine"]


def test_build_refuses_an_unported_family(monkeypatch):
    mesh = _mesh((1, 1))
    for arch_id, jspec in JARCHS.items():
        if jspec.family != "engine":
            with pytest.raises(KeyError, match="Queue 1 item 3"):
                programs.build(arch_id, jspec.shapes[0].shape_id, mesh)
    with pytest.raises(KeyError, match="unknown shape"):
        programs.build("k2triples", "train_4k", mesh)
    # the default mesh is every visible card: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        programs.build("k2triples", "serve_64k")


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mshape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_in_specs_and_flops_like_jax(mshape, shape, smoke):
    prog = programs.build("k2triples", shape, _mesh(mshape), smoke=smoke)
    jprog = jprograms.build("k2triples", shape, _jax_mesh(mshape), smoke=smoke)
    assert prog.name == jprog.name and prog.model_flops == jprog.model_flops
    fspec, *bspecs = prog.in_specs
    got = [getattr(fspec, f.name) for f in dataclasses.fields(fspec)]
    got += list(bspecs[0]) if isinstance(bspecs[0], eng.ServeBatch) else bspecs
    want = jax.tree.leaves(jprog.in_specs)
    assert len(got) == len(want) == (10 if shape == "serve_64k" else 8)
    for g, w in zip(got, want):
        assert g.device.type == "meta"  # nothing allocated
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.int32 and w.dtype in (jnp.int32, jnp.uint32)
    assert isinstance(prog.in_specs[1], eng.ServeBatch) == (shape == "serve_64k")
    jspec = JARCHS["k2triples"]
    jmeta, _ = jprograms._engine_forest_specs(jspec.smoke_cfg if smoke else jspec.cfg,
                                              _jax_mesh(mshape))
    assert prog.meta.ks == jmeta.ks


# ---------------------------------------------------------------------------
# the smoke cells, run
# ---------------------------------------------------------------------------


def _smoke_store(rdf_mod, k2t, **kw):
    cfg = ARCHS["k2triples"].smoke_cfg
    ds = rdf_mod.generate(cfg.n_triples, n_subjects=cfg.n_subjects, n_preds=cfg.n_preds,
                          n_objects=cfg.n_objects, seed=0)
    return ds, k2t.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                   n_objects=ds.n_objects, n_preds=ds.n_preds, **kw)


def _serve_batch(ids, n_preds):
    """256 lanes: all six ops on real triples, then predicates 0, P + 1 and
    a dead lane."""
    rng = np.random.default_rng(0)
    op = rng.integers(0, 6, 256).astype(np.int32)
    rows = ids[rng.integers(0, ids.shape[0], 256)]
    s, p, o = (rows[:, i].astype(np.int32) for i in range(3))
    p = np.where(op >= 3, 0, p).astype(np.int32)
    op[-3:], p[-3:] = [1, 2, -1], [0, n_preds + 1, 1]
    return op, s, p, o


def _sweep_keys(ids):
    axes = (np.arange(256) % 2).astype(np.int32)
    rows = ids[np.random.default_rng(1).integers(0, ids.shape[0], 256)]
    return np.where(axes == 1, rows[:, 2], rows[:, 0]).astype(np.int32), axes


@pytest.fixture(scope="module")
def smoke():
    """The smoke store (both packages), the inputs, and the JAX programs'
    answers on a (1, 1) mesh."""
    ds, store = _smoke_store(rdf, k2triples, device="cpu")
    _, jstore = _smoke_store(jrdf, jk2triples)
    batch = _serve_batch(ds.ids, ds.n_preds)
    keys = _sweep_keys(ds.ids)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_SCAN_BACKEND", "jnp")
        prog = jprograms.build("k2triples", "serve_64k", mesh, smoke=True)
        r = prog.fn(jstore.forest, jeng.ServeBatch(*(jnp.asarray(a) for a in batch)))
        want["serve_64k"] = {f: np.asarray(getattr(r, f)) for f in eng.RESULT_FIELDS}
        prog = jprograms.build("k2triples", "unbounded_4k", mesh, smoke=True)
        want["unbounded_4k"] = [np.asarray(a) for a in
                                prog.fn(jstore.forest, *(jnp.asarray(a) for a in keys))]
    return store, dict(serve_64k=eng.ServeBatch(*batch), unbounded_4k=keys), want


def _same(got, want):
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, (g.dtype, want.dtype, g.shape,
                                                             want.shape)
    assert np.array_equal(g, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mshape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_smoke_cells_like_jax(smoke, shape, mshape):
    store, batches, want = smoke
    mesh = _mesh(mshape)
    prog = programs.build("k2triples", shape, mesh, smoke=True)
    assert store.meta == prog.meta
    got = prog.fn(*programs.inputs(prog, store, mesh, batches[shape]))
    if shape == "serve_64k":
        for f in eng.RESULT_FIELDS:
            _same(getattr(got, f), want[shape][f])
        op = batches[shape].op
        assert got.hit[op == 0].any() and got.count[(op == 1) | (op == 2)].sum() > 0
        assert not got.valid[op >= 3].any()  # no index: unbounded lanes answer nothing
    else:
        for g, w in zip(got, want[shape], strict=True):
            _same(g, w)
        assert got[2].sum() > 0


def test_inputs_refusals_and_meta_specs(smoke):
    store, batches, _ = smoke
    mesh = _mesh((2, 4))
    prog = programs.build("k2triples", "serve_64k", mesh, smoke=True)
    full = programs.build("k2triples", "serve_64k", mesh)
    with pytest.raises(ValueError, match="trees"):
        programs.inputs(full, store, mesh, batches["serve_64k"])
    short = eng.ServeBatch(*(a[:128] for a in batches["serve_64k"]))
    with pytest.raises(ValueError, match="lanes of shape"):
        programs.inputs(prog, store, mesh, short)
    sweep = programs.build("k2triples", "unbounded_4k", mesh, smoke=True)
    with pytest.raises(ValueError):
        programs.inputs(sweep, store, mesh, batches["unbounded_4k"][:1])
    # the meta specs never reach a kernel: the wrappers refuse the device
    on_meta = meshlib.Mesh(("data", "model"), (1, 1), (torch.device("meta"),))
    prog = programs.build("k2triples", "serve_64k", on_meta, smoke=True)
    fspec, q = prog.in_specs
    with pytest.raises(ValueError, match="CUDA card or the CPU"):
        prog.fn(eng.shard_forest(fspec, on_meta), q)
