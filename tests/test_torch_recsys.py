"""The recsys family of ``repro_torch`` (xDeepFM) against the JAX
package's ``repro.data.recsys``, ``repro.models.recsys.xdeepfm`` and
``repro.launch.programs.build_recsys``:

* ``ctr_batch`` / ``multi_hot_bags``: the same arrays for a seed;
* ``embedding_bag`` (sum, mean, weighted), ``forward``, ``loss_fn`` and its
  gradient a leaf, ``retrieval_score`` on the JAX parameters at the smoke
  config: f32 throughout, so within 1e-5 relative (measured ≤ 4e-7; the
  products sum in another order);
* the chunked CIN against the one-chunk CIN with a chunk of a few rows:
  values within 1e-6, gradients within 1e-4 relative (a product's sum
  blocked another way; measured ≤ 6.6e-5);
* the four smoke programs on (1, 1) against the JAX programs' ``fn`` on a
  (1, 1) mesh (train: loss, ``grad_norm``, AdamW's state and the new
  parameters), ``in_specs`` and model flops against the JAX builder's,
  smoke and full; the same programs on a (2, 4) ``cpu`` mesh against the
  port's (1, 1) (the lookups' ``psum`` has one nonzero term: forward and
  retrieval exactly equal, the step within 1e-6), the tables and the
  optimizer state laid out by the JAX builder's ``in_shardings``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.data import recsys as jR
from repro.launch import programs as jprograms
from repro.models.recsys import xdeepfm as jxd
from repro_torch.configs import ARCHS
from repro_torch.data import recsys as R
from repro_torch.dist.sharding import Sharded
from repro_torch.launch import mesh as meshlib, programs
from repro_torch.models.recsys import xdeepfm as xd
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-6)
EXACT_TOL = dict(rtol=1e-6, atol=1e-7)  # the same sums in another chunking
SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
CFG = ARCHS["xdeepfm"].smoke_cfg


def cpu_mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def f32(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = x.unshard()
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def jparams():
    """The JAX ``init`` at the smoke config, scaled up so the CIN's terms
    are not vanishing (init's 0.01 makes a layer's output ~1e-6)."""
    p = jax.jit(lambda k: jxd.init(CFG, k))(jax.random.PRNGKey(0))
    return jax.tree.map(lambda a: a * 30.0 if a.ndim >= 2 else a + 0.1, p)


@pytest.fixture(scope="module")
def params(jparams):
    return xd.params_from_arrays(CFG, jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_data_like_jax(seed):
    for args in ((64, 8, 1000), (5, 39, 1_000_000)):
        got, want = R.ctr_batch(*args, seed=seed), jR.ctr_batch(*args, seed=seed)
        for k in ("ids", "labels"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    for a, b in zip(R.multi_hot_bags(16, 1000, seed=seed), jR.multi_hot_bags(16, 1000, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_like_jax(mode, weighted):
    ids, bag_ids, counts = R.multi_hot_bags(16, 1000, seed=2)
    rng = np.random.default_rng(3)
    tbl = rng.standard_normal((1000, 6)).astype(np.float32)
    w = rng.standard_normal(len(ids)).astype(np.float32) if weighted else None
    n_bags = 18  # two empty bags: mean divides by max(count, 1)
    want = jxd.embedding_bag(jnp.asarray(tbl), jnp.asarray(ids), jnp.asarray(bag_ids), n_bags,
                             None if w is None else jnp.asarray(w), mode=mode)
    got = xd.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(ids), torch.from_numpy(bag_ids),
                           n_bags, None if w is None else torch.from_numpy(w), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[16:].any()


def test_model_like_jax(jparams, params):
    """``field_embed``, ``forward``, ``loss_fn`` with its gradient a leaf and
    ``retrieval_score`` against the JAX module on the same parameters."""
    b = R.ctr_batch(64, CFG.n_fields, CFG.rows_per_field, seed=1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(xd.field_embed(params, tb["ids"]).numpy(),
                               np.asarray(jxd.field_embed(jparams, jb["ids"])), **TOL)
    want = jax.jit(lambda p, i: jxd.forward(CFG, p, i))(jparams, jb["ids"])
    got = xd.forward(CFG, params, tb["ids"])
    assert got.shape == (64,) and float(np.std(np.asarray(want))) > 1e-2  # not vanishing
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jxd.loss_fn(CFG, p, b)))(jparams, jb)
    loss, g = value_and_grad(lambda p, b: xd.loss_fn(CFG, p, b), params, tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    got_g, want_g = list(leaves(g)), jax.tree_util.tree_leaves_with_path(jg)
    assert len(got_g) == len(want_g)
    for (path, a), (jpath, w) in zip(got_g, want_g):
        assert jax.tree_util.keystr(jpath) == "".join(f"[{k!r}]" for k in path)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * float(np.abs(np.asarray(w)).max()),
                                   err_msg=str(path))
    user = np.random.default_rng(5).integers(0, CFG.rows_per_field, CFG.n_fields).astype(np.int32)
    cands = np.arange(500, dtype=np.int32)
    want = jxd.retrieval_score(CFG, jparams, jnp.asarray(user), jnp.asarray(cands))
    got = xd.retrieval_score(CFG, params, torch.from_numpy(user), torch.from_numpy(cands))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_chunked_cin_equals_one_chunk(params):
    """``cin_pooled`` in chunks of 5 rows (a ragged last chunk) against one
    chunk, values and gradients; the rows a chunk takes from its byte
    budget; under autograd a chunk's ``z`` is not kept."""
    rng = np.random.default_rng(2)
    x0 = torch.from_numpy(rng.standard_normal((23, CFG.n_fields, CFG.embed_dim))
                          .astype(np.float32))
    ws = [w.clone() for w in params["cin"]]
    row = max(w.shape[1] for w in ws) * CFG.n_fields * CFG.embed_dim * 4
    assert xd.cin_chunk_rows(ws, x0, 5 * row) == 5 and xd.cin_chunk_rows(ws, x0, row - 1) == 1
    with torch.no_grad():
        whole = xd.cin_pooled(ws, x0, chunk_bytes=1 << 40)
        parts = xd.cin_pooled(ws, x0, chunk_bytes=5 * row)
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), **EXACT_TOL)
    # the reference's einsum form
    xk, pooled = x0, []
    for w in ws:
        xk = torch.einsum("bhmd,nhm->bnd", torch.einsum("bhd,bmd->bhmd", xk, x0), w)
        pooled.append(xk.sum(-1))
    np.testing.assert_allclose(whole.numpy(), torch.cat(pooled, -1).numpy(), **TOL)
    grads = []
    for chunk in (1 << 40, 5 * row):
        xs = x0.clone().requires_grad_()
        wg = [w.clone().requires_grad_() for w in ws]
        sizes = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: sizes.append(t.numel()) or t,
                                                      lambda t: t):
            out = xd.cin_pooled(wg, xs, chunk_bytes=chunk)
        (out * torch.arange(out.shape[1])).sum().backward()
        grads.append([xs.grad] + [w.grad for w in wg])
        assert max(sizes) < min(5, 23) * row // 4 + 1 or chunk == 1 << 40
    for a, b in zip(*grads):  # the products' sums blocked another way: f32 ulps of their terms
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mshape", [(1, 1), (2, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_in_specs_shardings_and_flops_like_jax(mshape, shape, smoke):
    prog = programs.build("xdeepfm", shape, cpu_mesh(mshape), smoke=smoke)
    jprog = jprograms.build("xdeepfm", shape, AbstractMesh(mshape, ("data", "model")), smoke=smoke)
    assert prog.name == jprog.name and prog.model_flops == jprog.model_flops
    assert len(prog.in_specs) == len(jprog.in_specs)
    for got, want in zip(prog.in_specs, jprog.in_specs):
        got = list(leaves(got)) if isinstance(got, dict) else [((), got)]
        want = jax.tree_util.tree_leaves_with_path(want)
        assert len(got) == len(want)
        for (path, g), (jpath, w) in zip(got, want):
            assert g.device.type == "meta"  # nothing allocated
            assert tuple(g.shape) == tuple(w.shape) and str(g.dtype)[6:] == str(w.dtype), path
    if mshape == (1, 1):
        assert prog.mesh is None
        return
    shardings = jax.tree.leaves(jprog.in_shardings, is_leaf=lambda x: hasattr(x, "spec"))
    specs = [s for a in prog.in_shardings for s in (
        [leaf for _, leaf in leaves(a)] if isinstance(a, dict) else [a])]
    assert len(specs) == len(shardings)
    for got, want in zip(specs, shardings):
        want = tuple(want.spec) + (None,) * (len(got) - len(want.spec))
        assert tuple(got) == tuple(e if not isinstance(e, tuple) or len(e) > 1 else e[0]
                                   for e in want)


def _jax_mesh11():
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


@pytest.mark.parametrize("shape", SHAPES)
def test_smoke_programs_like_jax(jparams, params, shape):
    """The (1, 1) smoke program on the JAX parameters and inputs against
    the JAX program's ``fn``; the train step's loss, ``grad_norm``,
    AdamW's moments and new parameters (AdamW's first update is ±lr
    wherever |g| ≫ eps: at most 1% of a leaf's elements off, each within
    2.02·lr)."""
    jprog = jprograms.build("xdeepfm", shape, _jax_mesh11(), smoke=True)
    prog = programs.build("xdeepfm", shape, cpu_mesh((1, 1)), smoke=True)
    b = R.ctr_batch(64, CFG.n_fields, CFG.rows_per_field, seed=4)
    p = tree_map(torch.clone, params)
    if shape == "retrieval_cand":
        user = b["ids"][0]
        cands = np.random.default_rng(4).integers(0, CFG.rows_per_field, 4096).astype(np.int32)
        want = jax.jit(jprog.fn)(jparams, jnp.asarray(user), jnp.asarray(cands))
        got = prog.fn(p, torch.from_numpy(user), torch.from_numpy(cands))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    elif shape != "train_batch":
        want = jax.jit(jprog.fn)(jparams, jnp.asarray(b["ids"]))
        np.testing.assert_allclose(prog.fn(p, torch.from_numpy(b["ids"])).numpy(),
                                   np.asarray(want), **TOL)
    else:
        jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jprog.in_specs[1])
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jnew, jst, jm = jax.jit(jprog.fn)(jparams, jstate, jb)
        state = prog.opt.init(p)
        new, st, m = prog.fn(p, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert new is p and st is state
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        for (path, a), w in zip(leaves(st), jax.tree.leaves(jst)):
            w = np.asarray(w)
            np.testing.assert_allclose(f32(a), w, rtol=1e-4, atol=1e-6 * max(np.abs(w).max(), 1),
                                       err_msg=str(path))
        for (path, a), w in zip(leaves(new), jax.tree.leaves(jnew)):
            off = np.abs(f32(a) - np.asarray(w))
            assert off.max() <= 2.02 * 3e-4, path
            assert np.mean(off > 1e-6 + 1e-6 * np.abs(np.asarray(w))) <= 1e-2, path


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_programs_against_one_device(shape):
    """Each smoke program on a (2, 4) ``cpu`` mesh against the (1, 1) one on
    the same ``recsys_inputs`` (seed 6): forward and retrieval equal, the
    train step within 1e-6, its parameters and state ``Sharded`` as the
    program's ``in_shardings`` and on a repeated device views of the
    inputs' tensors."""
    single = programs.build("xdeepfm", shape, cpu_mesh((1, 1)), smoke=True)
    prog = programs.build("xdeepfm", shape, cpu_mesh((2, 4)), smoke=True)
    a1 = programs.recsys_inputs(single, "cpu", seed=6)
    a2 = programs.recsys_inputs(prog, "cpu", seed=6)
    assert a2[0]["tables"].spec == prog.in_shardings[0]["tables"] == (None, "model", None)
    assert a2[0]["tables"].parts[1].shape == (CFG.n_fields, CFG.rows_per_field // 4,
                                              CFG.embed_dim)
    want, got = single.fn(*a1), prog.fn(*a2)
    if shape != "train_batch":
        assert got.device.type == "cpu" and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        return
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]), **EXACT_TOL)
    osh = prog.in_shardings[1]
    for (path, a), (_, b), (_, sp) in zip(leaves(got[1]), leaves(want[1]), leaves(osh)):
        assert isinstance(a, Sharded) and a.spec == tuple(sp), path
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-9, err_msg=str(path))
    for (path, a), (_, b) in zip(leaves(got[0]), leaves(want[0])):
        np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-7, err_msg=str(path))


def test_recsys_inputs_and_refusals():
    mesh = cpu_mesh((1, 1))
    prog = programs.build("xdeepfm", "serve_p99", mesh, smoke=True)
    params, ids = programs.recsys_inputs(prog, "cpu", seed=3, batch=10)
    want = R.ctr_batch(10, CFG.n_fields, CFG.rows_per_field, seed=3)["ids"]
    assert ids.dtype == torch.int32 and np.array_equal(ids.numpy(), want)
    assert params["tables"].shape == (CFG.n_fields, CFG.rows_per_field, CFG.embed_dim)
    assert not params["bias"].any() and float(params["tables"].std()) == pytest.approx(0.01, 0.1)
    ret = programs.build("xdeepfm", "retrieval_cand", mesh, smoke=True)
    _, user, cands = programs.recsys_inputs(ret, "cpu", seed=3)
    assert user.shape == (CFG.n_fields,) and cands.shape == (4096,)
    with pytest.raises(ValueError, match="at most 64 rows"):
        programs.recsys_inputs(prog, "cpu", batch=65)
    with pytest.raises(ValueError, match="not a recsys program"):
        programs.recsys_inputs(programs.build("tinyllama-1.1b", "prefill_32k", mesh, smoke=True),
                               "cpu")
    with pytest.raises(ValueError, match="not an LM program"):
        programs.lm_inputs(prog, "cpu")
    with pytest.raises(ValueError, match="do not split over 3 data"):
        programs.build("xdeepfm", "serve_p99", cpu_mesh((3, 1)), smoke=True)
    full = programs.build("xdeepfm", "serve_bulk", cpu_mesh((2, 4)))
    assert full.in_specs[1].shape == (262_144, 39) and full.in_specs[0]["tables"].is_meta
    assert ARCHS["xdeepfm"].cfg.n_params == JARCHS["xdeepfm"].cfg.n_params == 432_742_002
