"""The arch registry and the program builder of ``repro_torch`` against
the JAX package's ``repro.configs`` / ``repro.launch.programs``:

* every registered arch (``k2triples``, the five LM archs, the four GNN
  archs and ``xdeepfm``: all of the JAX registry) field by field (cfg,
  smoke cfg, shapes with their dims, rules and skips, optimizer, parameter
  dtype, source), ``all_cells()`` against the JAX one, and ``build``'s
  refusals (a GNN program on a mesh of several devices; a batch that does
  not split over the data slices) beside the mesh programs it builds
  (``train_4k`` included);
* ``build_engine``'s meta-device ``in_specs`` against the JAX
  ``ShapeDtypeStruct``s (uint32 as int32) for both shapes, smoke and
  full, on (1, 1) and (2, 4) meshes, and ``model_flops``; the same for
  ``build_lm``'s train, prefill and decode programs of every LM arch
  (the train program's optimizer state is the arch's optimizer's);
* the smoke cells run for real: the smoke store on a (1, 1) and a (2, 4)
  mesh of the ``cpu`` device against the JAX program's ``fn`` on a (1, 1)
  JAX mesh, every field exact (``serve_64k`` at B = 256 with all six ops;
  ``unbounded_4k`` at B = 256).  The JAX side traces with
  ``REPRO_SCAN_BACKEND=jnp`` (its traversal reference; the Pallas kernels
  give the same bits, ``tests/test_k2_scan.py``).  LM smoke programs
  (B = 2, S = 64) run on the JAX parameters against the JAX programs'
  ``fn``, logits within 5e-2 (``tests/test_torch_transformer.py``'s
  whole-model bound), and ``lm_inputs`` makes seeded arguments, for the
  train program parameters, optimizer state and a ``TokenStream`` batch
  that one step consumes.
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
from repro_torch.data import rdf, tokens
from repro_torch.launch import mesh as meshlib, programs
from repro_torch.models import transformer as tfm

SHAPES = ("serve_64k", "unbounded_4k")
LM_ARCHS = ("command-r-plus-104b", "tinyllama-1.1b", "gemma2-27b", "kimi-k2-1t-a32b",
            "olmoe-1b-7b")
LM_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
PORTED = ("engine", "lm", "gnn", "recsys")
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
    assert set(ARCHS) == {"k2triples", "xdeepfm", *LM_ARCHS, "mace", "graphcast", "egnn",
                          "equiformer-v2"} == set(JARCHS)
    assert list(ARCHS) == [a for a in JARCHS if JARCHS[a].family in PORTED]  # JAX's order
    for arch_id, spec in ARCHS.items():
        jspec = JARCHS[arch_id]
        assert [f.name for f in dataclasses.fields(spec)] == [
            f.name for f in dataclasses.fields(jspec)]
        for f in dataclasses.fields(spec):
            got, want = getattr(spec, f.name), getattr(jspec, f.name)
            if f.name in ("cfg", "smoke_cfg"):
                assert type(got).__name__ == type(want).__name__
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            elif f.name == "shapes":
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    _same_fields(g, w)
                    assert [x.name for x in dataclasses.fields(g)] == [
                        x.name for x in dataclasses.fields(w)]
            else:
                assert got == want, (arch_id, f.name)
    spec = ARCHS["k2triples"]
    assert spec.source == "this paper" and spec.shape("unbounded_4k").dims["unbounded"] == 1
    with pytest.raises(KeyError):
        spec.shape("decode_32k")
    assert ARCHS["kimi-k2-1t-a32b"].param_dtype == "bfloat16"
    assert ARCHS["kimi-k2-1t-a32b"].source == "arXiv:2501.kimi2; unverified"
    assert ARCHS["gemma2-27b"].shape("long_500k").rules_override == {
        "batch": None, "kv_seq": ("pod", "data", "model")}
    for include in (True, False):
        assert list(programs.all_cells(include)) == [
            c for c in jprograms.all_cells(include) if JARCHS[c[0]].family in PORTED]
    assert ("tinyllama-1.1b", "train_4k") in set(programs.all_cells())
    assert ("xdeepfm", "serve_bulk") in set(programs.all_cells())
    assert ARCHS["xdeepfm"].source == "arXiv:1803.05170; paper"


def test_build_refuses_an_unported_family(monkeypatch):
    mesh = _mesh((1, 1))
    assert all(jspec.family in PORTED for jspec in JARCHS.values())  # no family left unported
    gnn = [a for a, jspec in JARCHS.items() if jspec.family == "gnn"]
    assert gnn == ["mace", "graphcast", "egnn", "equiformer-v2"]
    for arch_id in gnn:  # a mesh of several devices too (tests/test_torch_gnn_mesh.py)
        shape = JARCHS[arch_id].shapes[0].shape_id
        assert programs.build(arch_id, shape, _mesh((1, 2)), smoke=True).mesh.sizes == (1, 2)
        assert programs.build(arch_id, shape, mesh, smoke=True).mesh is None
    with pytest.raises(KeyError):
        programs.build("gcn-cora", "full_graph_sm", mesh)
    for arch_id in LM_ARCHS:  # a mesh of several devices: every program, train_4k too
        for shape in ("train_4k", "decode_32k"):
            prog = programs.build(arch_id, shape, _mesh((1, 2)), smoke=True)
            assert prog.mesh.sizes == (1, 2) and (prog.opt is not None) == (shape == "train_4k")
    with pytest.raises(ValueError, match="does not split over 4 data"):  # B = 2 a step
        programs.build("tinyllama-1.1b", "train_4k", _mesh((4, 1)), smoke=True)
    for shape in ("train_batch", "retrieval_cand"):  # the recsys arch, on a mesh too
        assert programs.build("xdeepfm", shape, _mesh((2, 4)), smoke=True).mesh.sizes == (2, 4)
    assert programs.build("olmoe-1b-7b", "prefill_32k", _mesh((2, 4))).in_shardings[1] == (
        "data", None)
    with pytest.raises(KeyError, match="unknown shape"):
        programs.build("k2triples", "train_4k", mesh)
    with pytest.raises(KeyError, match="unknown shape"):
        programs.build("tinyllama-1.1b", "serve_64k", mesh)
    # the default mesh is every visible card, or one for an LM program: none here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        programs.build("k2triples", "serve_64k")
    with pytest.raises(ValueError, match="CUDA"):
        programs.build("tinyllama-1.1b", "prefill_32k")
    prog = programs.build("tinyllama-1.1b", "prefill_32k", mesh, smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        programs.lm_inputs(prog)


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


# ---------------------------------------------------------------------------
# LM programs
# ---------------------------------------------------------------------------


def _port_leaves(specs):
    """The leaves of an ``in_specs`` tuple in ``jax.tree.leaves`` order."""
    out = []
    for x in specs:
        out += [leaf for _, leaf in tfm._leaves(x)] if isinstance(x, dict) else [x]
    return out


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("shape", LM_SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_in_specs_and_flops_like_jax(arch, shape, smoke):
    prog = programs.build(arch, shape, _mesh((1, 1)), smoke=smoke)
    jprog = jprograms.build(arch, shape, _jax_mesh((1, 1)), smoke=smoke)
    assert prog.name == jprog.name and prog.model_flops == jprog.model_flops
    assert prog.meta is None and prog.cfg is (ARCHS[arch].smoke_cfg if smoke else ARCHS[arch].cfg)
    got, want = _port_leaves(prog.in_specs), jax.tree.leaves(jprog.in_specs)
    assert len(got) == len(want) and len(prog.in_specs) == len(jprog.in_specs)
    for g, w in zip(got, want):
        assert g.device.type == "meta"  # nothing allocated
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    cfg = prog.cfg
    assert programs.lm_train_flops(cfg, 4096) == jprograms.lm_train_flops(cfg, 4096)


LM_RUNS = (("tinyllama-1.1b", "prefill_32k"), ("gemma2-27b", "decode_32k"),
           ("olmoe-1b-7b", "long_500k"))


@pytest.mark.parametrize("arch,shape", LM_RUNS)
def test_lm_smoke_cells_like_jax(arch, shape):
    """The smoke program on the JAX parameters and inputs against the JAX
    program's ``fn`` (a (1, 1) JAX mesh)."""
    auto = (jax.sharding.AxisType.Auto,) * 2  # the builder's sharding constraints need Auto axes
    jprog = jprograms.build(arch, shape, jax.make_mesh((1, 1), ("data", "model"), axis_types=auto),
                            smoke=True)
    prog = programs.build(arch, shape, _mesh((1, 1)), smoke=True)
    rng = np.random.default_rng(len(arch))
    jargs = jax.tree.map(lambda s: jnp.asarray(
        rng.integers(0, prog.cfg.vocab, s.shape) if s.dtype == jnp.int32
        else rng.standard_normal(s.shape) * (0.3 if s.ndim < 5 else 1.0)).astype(s.dtype),
        jprog.in_specs)
    if shape != "prefill_32k":
        jargs = (*jargs[:3], jnp.asarray([63, 40], jnp.int32))  # lengths
    args = [tfm.params_from_arrays(prog.cfg, jax.tree.map(np.asarray, jargs[0]), device="cpu")]
    for a in jargs[1:]:
        args.append({k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).bfloat16()
                     for k, v in a.items()} if isinstance(a, dict)
                    else torch.from_numpy(np.array(a)))
    logits, cache = prog.fn(*args)
    jlogits, jcache = jax.jit(jprog.fn)(*jargs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=5e-2, atol=5e-2)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k].astype(jnp.float32)), rtol=5e-2, atol=5e-2)


def test_lm_inputs():
    mesh = _mesh((1, 1))
    pre = programs.build("tinyllama-1.1b", "prefill_32k", mesh, smoke=True)
    params, toks = programs.lm_inputs(pre, "cpu", seed=3, batch=1, seq_len=16)
    want = tokens.TokenStream(pre.cfg.vocab, 16, seed=3).batch(1)["tokens"]
    assert toks.dtype == torch.int32 and np.array_equal(toks.numpy(), want)
    again, _ = programs.lm_inputs(pre, "cpu", seed=3)
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tfm._leaves(params), tfm._leaves(again)))
    logits, cache = pre.fn(params, toks)
    assert logits.shape == (1, pre.cfg.vocab) and cache["k"].shape[2] == 16
    dec = programs.build("kimi-k2-1t-a32b", "long_500k", mesh, smoke=True)
    params, cache, new, lengths = programs.lm_inputs(dec, "cpu", seq_len=10)
    assert params["embed"].dtype == torch.bfloat16  # the arch's parameter dtype
    assert cache["k"].shape == (2, 2, 10, 2, 8) and cache["v"].dtype == torch.bfloat16
    assert new.dtype == lengths.dtype == torch.int32 and lengths.tolist() == [9, 9]
    logits, _ = dec.fn(params, cache, new, lengths)
    assert torch.isfinite(logits).all()
    for bad in (dict(batch=3), dict(seq_len=65), dict(batch=0)):
        with pytest.raises(ValueError, match="takes batch"):
            programs.lm_inputs(dec, "cpu", **bad)
    engine = programs.build("k2triples", "serve_64k", mesh, smoke=True)
    with pytest.raises(ValueError, match="not an LM program"):
        programs.lm_inputs(engine, "cpu")
    with pytest.raises(ValueError, match="not an engine program"):
        programs.inputs(pre, None, mesh, None)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_train_program_like_jax(arch, smoke):
    """``train_4k``: the in_specs (parameters, the arch's optimizer state on
    the ``meta`` device, the int32 token / label batch) leaf for leaf and
    the model flops against the JAX builder's."""
    prog = programs.build(arch, "train_4k", _mesh((1, 1)), smoke=smoke)
    jprog = jprograms.build(arch, "train_4k", _jax_mesh((1, 1)), smoke=smoke)
    assert prog.name == jprog.name and prog.model_flops == jprog.model_flops
    B, S = (2, 64) if smoke else (256, 4096)
    assert prog.model_flops == programs.lm_train_flops(prog.cfg, B * S)
    assert len(prog.in_specs) == len(jprog.in_specs) == 3
    for got, want in zip(prog.in_specs, jprog.in_specs):
        got, want = list(tfm._leaves(got)), jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got] == [tuple(k.key for k in p) for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            assert g.device.type == "meta", path  # nothing allocated
            assert tuple(g.shape) == tuple(w.shape), path
            assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    assert (ARCHS[arch].optimizer == "adafactor") == ("f" in prog.in_specs[1])


def test_lm_train_inputs():
    """``lm_inputs`` of a train program: seeded parameters, the
    optimizer's fresh state and a ``TokenStream`` batch that one step of
    ``fn`` consumes; the batch is at most the cell's 256 sequences."""
    mesh = _mesh((1, 1))
    prog = programs.build("olmoe-1b-7b", "train_4k", mesh, smoke=True)
    params, state, batch = programs.lm_inputs(prog, "cpu", seed=2, seq_len=16)
    want = tokens.TokenStream(prog.cfg.vocab, 16, seed=2).batch(2)
    for k in ("tokens", "labels"):
        assert batch[k].dtype == torch.int32 and np.array_equal(batch[k].numpy(), want[k])
    assert int(state["step"]) == 0 and state["mu"]["embed"].dtype == torch.float32
    before = params["layers"]["router"].clone()
    _, state, m = prog.fn(params, state, batch)
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))
    assert float(m["grad_norm"]) > 0 and not torch.equal(params["layers"]["router"], before)
    full = programs.build("tinyllama-1.1b", "train_4k", mesh)
    assert full.in_specs[2]["tokens"].shape == (256, 4096)
    with pytest.raises(ValueError, match="takes batch <= 256"):
        programs.lm_inputs(full, "cpu", batch=257, seq_len=8)
    kimi = programs.build("kimi-k2-1t-a32b", "train_4k", mesh, smoke=True)
    params, state, _ = programs.lm_inputs(kimi, "cpu", batch=1, seq_len=8)
    assert params["embed"].dtype == torch.bfloat16 and set(state) == {"f", "step"}
