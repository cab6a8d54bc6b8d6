"""Predicate-sharded serving of ``repro_torch`` over a device mesh.

* The port's ``Engine.compile(ServeQ(), ExecConfig(mesh=...))`` against
  the JAX package's sharded plan, every ``ServeResult`` field exact with
  its dtype, on the stores and meshes of ``tests/sharded_driver.py``'s
  ``engine`` (7 predicates padded to 8 on a (2, 4) mesh, all six ops),
  ``engine_pruned`` (16 predicates, (2, 4), the index-pruned unbounded
  lanes) and ``sortedset_union`` ((1, 8), a plan without the unbounded
  block) cases, with lanes of
  predicate 0, P, P + 1, the last padded id, past it, and dead lanes; and
  ``make_sharded_unbounded_scan`` against the JAX one.  The JAX side runs
  once, in a subprocess that is this file's ``__main__`` with eight host
  devices (``--xla_force_host_platform_device_count=8``) and
  ``backend="jnp"``, and writes an ``.npz``.  The port's meshes repeat
  the ``cpu`` device.
* Against the unsharded port: other meshes and paddings, pattern plans.
* The broker over a (1, 1) and a (2, 4) mesh against its direct plan,
  ``serve_mesh_shape``, the refusals, padding, and a compaction swap.
"""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# case -> (generator keywords, mesh shape, cap, unbounded, ops drawn from [0, ops_hi))
CASES = {
    "engine": (dict(n_triples=2000, n_subjects=100, n_preds=7, n_objects=120, seed=3),
               (2, 4), 64, True, 6),
    "engine_pruned": (dict(n_triples=3000, n_subjects=90, n_preds=16, n_objects=110,
                           preds_per_subject=4, seed=6), (2, 4), 64, True, 6),
    "sortedset_union": (dict(n_triples=4000, n_subjects=80, n_preds=16, n_objects=90,
                             seed=9), (1, 8), 64, False, 3),
}
UNB_KEYS = 8  # keys of the unbounded sweep


def dataset(case, rdf):
    gen = dict(CASES[case][0])
    return rdf.generate(gen.pop("n_triples"), **gen)


def serve_batch(case, ids, n_preds):
    """38 lanes: 32 drawn from real triples, then predicates 0, P, P + 1,
    the last padded id and one past it, and one dead lane."""
    _, (_, mp), _, _, ops_hi = CASES[case]
    rng = np.random.default_rng(0)
    ops = rng.integers(0, ops_hi, 32).astype(np.int32)
    rows = ids[rng.integers(0, ids.shape[0], 32)]
    p = np.where(ops >= 3, 0, rows[:, 1]).astype(np.int32)
    padded = -(-n_preds // mp) * mp
    odd_p = np.array([0, n_preds, n_preds + 1, padded, padded + 1], np.int32)
    odd = ids[:5]
    op = np.concatenate([ops, np.array([1, 2, 0, 1, 2, -1], np.int32)])
    s = np.concatenate([rows[:, 0], odd[:, 0], [1]]).astype(np.int32)
    pp = np.concatenate([p, odd_p, [1]]).astype(np.int32)
    o = np.concatenate([rows[:, 2], odd[:, 2], [1]]).astype(np.int32)
    return op, s, pp, o


def sweep_keys(ids):
    keys = ids[:UNB_KEYS, 0].astype(np.int32)
    axes = (np.arange(UNB_KEYS) % 2).astype(np.int32)
    keys = np.where(axes == 1, ids[:UNB_KEYS, 2], keys).astype(np.int32)
    return keys, axes


FIELDS = ("hit", "ids", "valid", "count", "overflow",
          "u_preds", "u_ids", "u_valid", "u_count")


def jax_main(out_path):
    """The JAX side: every case's sharded plan and unbounded sweep."""
    import jax
    import jax.numpy as jnp

    from repro.core import engine as jeng, k2triples as jk2
    from repro.core.query import ExecConfig, ServeQ
    from repro.data import rdf as jrdf

    out = {}
    for case, (_, shape, cap, unbounded, _) in CASES.items():
        ds = dataset(case, jrdf)
        store = jk2.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                    n_objects=ds.n_objects, n_preds=ds.n_preds)
        mesh = jax.make_mesh(shape, ("data", "model"))
        plan = jeng.Engine(store).compile(
            ServeQ(unbounded=unbounded),
            ExecConfig(backend="jnp", interpret=True, cap=cap, mesh=mesh),
        )
        r = plan(jeng.ServeBatch(*(jnp.asarray(a) for a in serve_batch(case, ds.ids, ds.n_preds))))
        for name in FIELDS:
            out[f"{case}.{name}"] = np.asarray(getattr(r, name))
        f_sh = jeng.shard_forest(jeng.pad_preds(store.forest, shape[1]), mesh, "model")
        unb = jeng.make_sharded_unbounded_scan(
            store.meta, mesh, cap=64, backend=ExecConfig(backend="jnp", interpret=True))
        keys, axes = sweep_keys(ds.ids)
        for i, a in enumerate(unb(f_sh, jnp.asarray(keys), jnp.asarray(axes))):
            out[f"{case}.sweep{i}"] = np.asarray(a)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_sharded") / "out.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"), env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return dict(z)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

from repro_torch.core import compaction, delta, engine as eng, k2triples  # noqa: E402
from repro_torch.core.query import (  # noqa: E402
    BgpQ, ExecConfig, JoinQ, SelectQ, ServeQ, TriplePatternQ,
)
from repro_torch.data import rdf  # noqa: E402
from repro_torch.launch import mesh as meshlib, serve  # noqa: E402
from repro_torch.launch.broker import CoalescePolicy, ServeBroker  # noqa: E402

_engines = {}


def engine_of(case):
    if case not in _engines:
        ds = dataset(case, rdf)
        st = k2triples.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                       n_objects=ds.n_objects, n_preds=ds.n_preds, device="cpu")
        _engines[case] = (eng.Engine(st, device="cpu"), ds)
    return _engines[case]


def cpu_mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def host(r):
    return {n: getattr(r, n).numpy() for n in FIELDS}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_plan_matches_jax(jax_sharded, case):
    e, ds = engine_of(case)
    _, shape, cap, unbounded, _ = CASES[case]
    plan = e.compile(ServeQ(unbounded=unbounded),
                     ExecConfig(cap=cap, device="cpu", mesh=cpu_mesh(shape)))
    op, _, p, _ = batch = serve_batch(case, ds.ids, ds.n_preds)
    got = host(plan(eng.ServeBatch(*batch)))
    for name in FIELDS:
        want = jax_sharded[f"{case}.{name}"]
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        assert np.array_equal(got[name], want), name
    # predicate 0, a padded tree, ids past the padding and dead lanes
    # answer empty, as in the reference
    nobody = (op < 0) | ((op < 3) & ((p == 0) | (p > ds.n_preds)))
    assert nobody.sum() >= 3
    assert not got["hit"][nobody].any() and not got["count"][nobody].any()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_unbounded_scan_matches_jax(jax_sharded, case):
    e, ds = engine_of(case)
    shape = CASES[case][1]
    mesh = cpu_mesh(shape)
    shards = eng.shard_forest(eng.pad_preds(e.forest, shape[1]), mesh)
    fn = eng.make_sharded_unbounded_scan(e.meta, mesh, cap=64)
    for i, got in enumerate(fn(shards, *sweep_keys(ds.ids))):
        want = jax_sharded[f"{case}.sweep{i}"]
        assert got.numpy().dtype == want.dtype and np.array_equal(got.numpy(), want), i


@pytest.mark.parametrize("shape", [(1, 3), (2, 2), (4, 2), (1, 16), (1, 1)])
@pytest.mark.parametrize("layout", ["dac", "fixed"])
def test_sharded_plan_matches_unsharded(shape, layout):
    """Meshes the JAX side does not cover (16 trees over 3 shards pad to
    18): owned lanes equal the unsharded plan field by field."""
    e, ds = engine_of("engine_pruned")
    batch = eng.ServeBatch(*(np.resize(a[:32], 32 * shape[0]) for a in
                             serve_batch("engine_pruned", ds.ids, ds.n_preds)))
    cfg = ExecConfig(cap=64, device="cpu", pred_index_layout=layout)
    want = host(e.compile(ServeQ(), cfg)(batch))
    got = host(e.compile(ServeQ(), cfg.replace(mesh=cpu_mesh(shape)))(batch))
    for name in FIELDS:
        assert np.array_equal(got[name], want[name]), name


def test_sharded_plan_over_two_data_axes():
    """A (pod, data, model) mesh: every axis but ``model`` is a data axis,
    so the batch splits over their product, row-major."""
    e, ds = engine_of("engine_pruned")
    batch = eng.ServeBatch(*(np.resize(a[:32], 64) for a in
                             serve_batch("engine_pruned", ds.ids, ds.n_preds)))
    cfg = ExecConfig(cap=128, device="cpu")
    mesh = meshlib.make_mesh((2, 1, 4), ("pod", "data", "model"), ["cpu"] * 8)
    got = host(e.compile(ServeQ(), cfg.replace(mesh=mesh))(batch))
    want = host(e.compile(ServeQ(), cfg)(batch))
    for name in FIELDS:
        assert np.array_equal(got[name], want[name]), name


def test_pattern_plans_on_a_mesh_match_unsharded():
    """The six serve-lane shapes batched on a (2, 2) mesh (odd batch sizes
    pad to the data axis) equal the unsharded plans, which
    test_torch_patterns holds against the JAX package."""
    e, ds = engine_of("engine_pruned")
    cfg = ExecConfig(cap=64, device="cpu")
    mesh_cfg = cfg.replace(mesh=cpu_mesh((2, 2)))
    rows = ds.ids[np.random.default_rng(5).integers(0, ds.n_triples, 13)]
    for bound in ((1, 1, 1), (1, 1, 0), (0, 1, 1), (1, 0, 1), (1, 0, 0), (0, 0, 1)):
        q = TriplePatternQ(*(1 if b else f"?{k}" for k, b in zip("spo", bound)))
        batch = {k: rows[:, i] for i, k in enumerate("spo") if bound[i]}
        got, want = e.compile(q, mesh_cfg)(batch), e.compile(q, cfg)(batch)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert {k: v.tolist() for k, v in g.items()} == {k: v.tolist() for k, v in w.items()}
            else:
                assert np.array_equal(np.asarray(g), np.asarray(w))
    # join categories A-C ride the sharded side lists
    s, p, o = (int(v) for v in ds.ids[0])
    for q in (JoinQ("A", "s", "s", p1=p, c1=o, p2=p, c2=o), JoinQ("B", "s", "s", p1=p, c1=o, c2=o),
              JoinQ("C", "o", "o", c1=s, c2=s)):
        got, want = e.compile(q, mesh_cfg)(), e.compile(q, cfg)()
        if isinstance(want, dict):
            assert {k: v.tolist() for k, v in got.items()} == {k: v.tolist() for k, v in want.items()}
        else:
            assert got.tolist() == want.tolist()


def test_padding_is_inert():
    e, ds = engine_of("engine")
    f = eng.pad_preds(e.forest, 4)
    assert f.n_preds == 8 and eng.pad_preds(f, 4) is f
    for name in ("t_words", "t_rank", "l_words", "ones_before", "level_start", "nnz"):
        a = getattr(f, name)
        assert torch.equal(a[:7], getattr(e.forest, name)) and not a[7:].any()
    shards = eng.shard_forest(f, cpu_mesh((2, 4)))
    # a repeated device holds row views of the padded arena, no copies
    assert len(shards) == 8 and shards[0] is shards[4]
    assert shards[3].t_words.data_ptr() == f.t_words[6:].data_ptr()
    assert all(s.t_words.is_contiguous() and s.level_start.is_contiguous() for s in shards)
    # every lane on the padded tree answers nothing, in every op
    z = np.zeros(8, np.int32)
    batch = eng.ServeBatch(np.array([0, 1, 2, 0, 1, 2, 1, 2], np.int32),
                           ds.ids[:8, 0].astype(np.int32), z + 8, ds.ids[:8, 2].astype(np.int32))
    r = e.compile(ServeQ(unbounded=False),
                  ExecConfig(cap=256, device="cpu", mesh=cpu_mesh((2, 4))))(batch)
    assert not r.hit.any() and not r.valid.any() and not r.count.any()
    with pytest.raises(ValueError, match="pad_preds"):
        eng.shard_forest(e.forest, cpu_mesh((1, 4)))


def _mixed(ds, n, seed):
    rng = np.random.default_rng(seed)
    ops = rng.integers(0, 6, n)
    rows = ds.ids[rng.integers(0, ds.n_triples, n)]
    return [(int(op), int(s), 0 if op >= 3 else int(p), int(o))
            for op, (s, p, o) in zip(ops, rows)]


@pytest.mark.parametrize("shape", [(1, 1), (2, 4)])
def test_broker_matches_direct_plan_sharded(shape):
    e, ds = engine_of("engine_pruned")
    cfg = ExecConfig(cap=64, device="cpu", mesh=cpu_mesh(shape))
    queries = _mixed(ds, 12, seed=5)

    async def main():
        async with ServeBroker(e, cfg, coalesce=CoalescePolicy(max_batch=8, max_delay_s=0.002)) as b:
            assert b._pad_to % shape[0] == 0
            return await asyncio.gather(*(b.submit_nowait("t0", *q) for q in queries))

    got = asyncio.run(main())
    plan = e.compile(ServeQ(), ExecConfig(cap=64, device="cpu"))
    ref = plan(eng.ServeBatch(*(np.array(c, np.int32) for c in zip(*queries))))
    ref = eng.host_result(ref)
    for i, (g, q) in enumerate(zip(got, queries)):
        w = eng.decode_lane(q[0], ref, i)
        if isinstance(w, dict):
            assert {k: v.tolist() for k, v in g.items()} == {k: v.tolist() for k, v in w.items()}
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (5, (5, 1)), (6, (2, 3)), (8, (2, 4)),
                                      (12, (3, 4)), (16, (4, 4))])
def test_serve_mesh_shape(n, shape):
    assert meshlib.serve_mesh_shape(n) == shape


def test_serve_mesh_shape_uses_every_device():
    for n in range(1, 17):
        dp, mp = meshlib.serve_mesh_shape(n)
        assert dp * mp == n and 1 <= mp <= 4
    with pytest.raises(ValueError):
        meshlib.serve_mesh_shape(0)
    mesh = meshlib.make_mesh((2, 1, 4), ("pod", "data", "model"), ["cpu"] * 8)
    assert meshlib.dp_axes(mesh) == ("pod", "data")
    assert mesh.shape == {"pod": 2, "data": 1, "model": 4} and mesh.size(("pod", "data")) == 2
    # rows of data slices, shards along the model axis, row-major positions
    assert mesh.grid() == ((0, 1, 2, 3), (4, 5, 6, 7))
    # the model axis may lead: shards stride over it
    mesh = meshlib.make_mesh((4, 2), ("model", "data"), ["cpu"] * 8)
    assert meshlib.dp_axes(mesh) == ("data",)
    assert mesh.grid() == ((0, 2, 4, 6), (1, 3, 5, 7))


def test_sharded_bench_refuses_without_two_cards():
    with pytest.raises(ValueError, match="unsharded"):
        serve.run_bench(device="cpu", n_triples=200, n_queries=8, sharded=True, quiet=True)
    assert serve.parse_args(["--sharded"]).sharded


def test_mesh_refusals():
    e, ds = engine_of("engine_pruned")
    cfg = ExecConfig(cap=256, device="cpu", mesh=cpu_mesh((1, 1)))
    for q in (TriplePatternQ("?s", 1, "?o"), TriplePatternQ(),
              JoinQ("D", "s", "o", p1=1, c1=1, p2=1), JoinQ("E", "s", "o", p1=1, c1=1),
              JoinQ("F", "s", "o", c1=1), BgpQ((TriplePatternQ(1, "?p", "?o"),)),
              SelectQ(where=(TriplePatternQ(1, 2, "?o"),))):
        with pytest.raises(ValueError, match="mesh"):
            e.compile(q, cfg)
    with pytest.raises(ValueError, match="lead"):
        e.compile(ServeQ(), cfg.replace(mesh=meshlib.Mesh(("data", "model"), (1, 1),
                                                          (torch.device("meta"),))))
    with pytest.raises(ValueError, match="lack"):
        e.compile(ServeQ(), cfg.replace(mesh=meshlib.make_mesh((1, 1), ("data", "tp"), ["cpu"])))
    with pytest.raises(ValueError):
        meshlib.make_mesh((2, 4), ("data", "model"), ["cpu"] * 7)
    with pytest.raises(ValueError, match="CUDA"):
        meshlib.make_mesh((2, 1), ("data", "model"))
    # a batch that does not split over the data axis
    plan = e.compile(ServeQ(), cfg.replace(mesh=cpu_mesh((2, 4))))
    with pytest.raises(ValueError, match="split"):
        plan(eng.ServeBatch(*(np.ones(3, np.int32),) * 4))
    # without the index, unbounded lanes have no sharded program
    off = cfg.replace(use_pred_index=False, mesh=cpu_mesh((1, 2)))
    with pytest.raises(ValueError, match="index"):
        e.compile(TriplePatternQ(1, "?p", "?o"), off)()
    with pytest.raises(ValueError, match="index"):
        e.compile(ServeQ(), off)(eng.ServeBatch(*(np.ones(2, np.int32),) * 4))


def test_compaction_swap_under_a_mesh():
    """A swap drops the old epoch's shards: the first batch after it cuts
    new ones, and answers follow the compacted store."""
    e0, ds = engine_of("engine_pruned")
    dstore = delta.DynamicStore(e0.store)
    e = eng.Engine(dstore, device="cpu")
    mesh_cfg = ExecConfig(cap=256, device="cpu", mesh=cpu_mesh((2, 4)))
    plain = ExecConfig(cap=256, device="cpu")
    s, p, o = (int(v) for v in ds.ids[0])
    q = TriplePatternQ(s, p, "?o")
    before = e.compile(q, mesh_cfg)()
    old_shards = e._shards(e._static(), mesh_cfg)
    dstore.delete(s, p, o)
    dstore.insert(s, p, ds.n_objects)  # an object id inside the extents
    mid = e.compile(q, mesh_cfg)()
    assert mid.tolist() == e.compile(q, plain)().tolist() != before.tolist()
    compaction.compact(dstore)
    assert dstore.epoch == 1
    after = e.compile(q, mesh_cfg)()
    assert after.tolist() == mid.tolist() == e.compile(q, plain)().tolist()
    new_shards = e._shards(e._static(), mesh_cfg)
    assert new_shards is not old_shards
    assert new_shards[0].t_words.data_ptr() != old_shards[0].t_words.data_ptr()


if __name__ == "__main__":
    jax_main(sys.argv[1])
