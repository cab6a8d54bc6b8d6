"""The GNN family of ``repro_torch`` against the JAX package's
``repro.data.graphs`` and ``repro.models.gnn``:

* data: ``random_graph``, ``to_batch``, ``NeighborSampler.sample`` (two
  samples in a row from one sampler) and ``molecule_batch`` give the same
  arrays for a seed, bit for bit;
* SO(3): ``cg_real`` and ``wigner_dy_real_poly`` equal exactly;
  ``real_sph_harm``, ``rz_real`` / ``ry_real``, ``align_blocks`` and
  ``align_to_z`` within 1e-6 below degree 3, at higher degrees within
  the bounds of ``test_so3_device_functions_like_jax`` (XLA's FMAs) and no
  farther from a float64 evaluation than the reference (the padding
  edge's zero vector included);
* common: the segment ops, ``scatter_edges``, ``mlp_apply``, the losses
  and ``bessel_rbf`` within f32 rounding;
* the four models on the configs of ``tests/test_models_gnn.py`` (EGNN and
  GraphCast on a cora-like graph, MACE and EquiformerV2 on molecules), on
  the JAX parameters: EGNN, MACE and EquiformerV2 forward within 1e-5 and
  each gradient leaf within 1e-4 relative L2 (measured ≤ 7e-7 and ≤ 1e-6),
  where a leaf whose gradient is zero but for rounding (EquiformerV2's last
  attention bias shifts every logit of a softmax alike: |g| ~ 1e-10) is
  held by 1e-6 of the whole gradient's norm; GraphCast (bf16 states) a
  layer at a time on identical inputs within 1e-2 relative L2 and whole by
  ``GRAPHCAST_TOL`` (measured);
* EquiformerV2's chunked online-softmax path (a ``torch.autograd.Function``)
  against the JAX ``custom_vjp`` and against the port's one-chunk path;
* rotation invariance (EGNN, MACE, EquiformerV2) and remat changing
  nothing.

The JAX side runs under ``jax.jit`` with the config static, one compile a
model (forward and ``value_and_grad`` together).
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import graphs as JG
from repro.models.gnn import common as JC
from repro.models.gnn import egnn as jegnn, equiformer_v2 as jeq, graphcast as jgc, mace as jmace
from repro.models.gnn import so3 as jso3
from repro_torch.data import graphs as G
from repro_torch.models.gnn import common as C, egnn, equiformer_v2 as eq, graphcast, mace, so3
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import leaves

ROT = np.array(
    [[np.cos(0.3), -np.sin(0.3), 0], [np.sin(0.3), np.cos(0.3), 0], [0, 0, 1]],
    np.float32,
)
FWD_TOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6  # of the whole gradient's L2 norm: a leaf zero but for rounding
# GraphCast: bf16 node/edge states; one processor layer on identical inputs, and the
# whole 2-layer model (measured: forward 9.0e-3, gradient leaves ≤ 1.2e-2)
LAYER_TOL = 1e-2
CHUNKS = 3  # EquiformerV2's chunked path: 64 edges in 3 chunks (padded to 66)
GRAPHCAST_TOL = dict(forward=2.5e-2, grad=4e-2)

MODELS = {
    # (reference module, port module, config fields, batch): tests/test_models_gnn.py's
    "egnn": (jegnn, egnn, dict(n_layers=2, d_hidden=32, in_dim=16, out_dim=7), "cora"),
    "graphcast": (jgc, graphcast, dict(n_layers=2, d_hidden=32, in_dim=16, edge_dim=4,
                                       out_dim=7), "cora"),
    "mace": (jmace, mace, dict(n_layers=2, d_hidden=16, l_max=2, correlation=3, n_rbf=4),
             "molecules"),
    "equiformer-v2": (jeq, eq, dict(n_layers=2, d_hidden=8, l_max=3, m_max=2, n_heads=2,
                                    n_rbf=4), "molecules"),
}
CFG_CLASS = {"egnn": "EGNNCfg", "graphcast": "GraphCastCfg", "mace": "MACECfg",
             "equiformer-v2": "EquiformerV2Cfg"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jnp(batch):
    return jax.tree.map(lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, batch)


def _same(got, want):
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for f, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f


@pytest.fixture(scope="module")
def batches():
    """The numpy batches of ``tests/test_models_gnn.py`` from both packages."""
    out = {}
    for name, make in (("cora", lambda g: g.to_batch(g.random_graph(100, 400, 16, n_classes=7,
                                                                    seed=1), 7)),
                       ("molecules", lambda g: g.molecule_batch(4, 8, 16, seed=2))):
        got, want = make(G), make(JG)
        _same(got, want)
        out[name] = (got.to("cpu"), _jnp(want))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def _grads_close(got, want, tol: float):
    """Every leaf of the port's gradient tree against the JAX one (paths in
    the same order): within ``tol`` relative L2, or ``GRAD_FLOOR`` of the
    whole gradient's norm; -> the largest relative L2."""
    want_l = jax.tree_util.tree_leaves_with_path(want)
    got_l = list(leaves(got))
    assert len(got_l) == len(want_l)
    total = float(np.sqrt(sum(float(jnp.sum(jnp.square(w))) for _, w in want_l)))
    worst = 0.0
    for (path, a), (jpath, w) in zip(got_l, want_l):
        assert jax.tree_util.keystr(jpath) == "".join(f"[{k!r}]" for k in path)
        a, w = _np(a), np.asarray(w)
        err = float(np.linalg.norm(a.astype(np.float64) - w))
        assert err <= tol * np.linalg.norm(w) or err <= GRAD_FLOOR * total, (path, err)
        if err > GRAD_FLOOR * total:
            worst = max(worst, _rel(a, w))
    return worst


def _jax_chunked(j) -> tuple:
    """The JAX EquiformerV2 loss and gradient with ``CHUNKS`` edge chunks
    (its custom VJP) on the parameters and batch of ``_jax_model``'s."""
    jcfg = dataclasses.replace(j["jcfg"], edge_chunks=CHUNKS)
    return jax.jit(jax.value_and_grad(lambda p, g: jeq.loss_fn(jcfg, p, g)))(j["jparams"],
                                                                            j["jb"])


def _jax_model(arch, batches):
    """The JAX side of one arch: its config, parameters, batch, and the
    forward and ``value_and_grad`` of its loss (one compile)."""
    jmod, _, fields, which = MODELS[arch]
    jcfg = getattr(jmod, CFG_CLASS[arch])(**fields)
    jp = jax.jit(lambda k: jmod.init(jcfg, k))(jax.random.PRNGKey(0))
    jb = batches[which][1]
    jout, (jl, jg) = jax.jit(lambda p, g: (
        jmod.forward(jcfg, p, g), jax.value_and_grad(lambda q: jmod.loss_fn(jcfg, q, g))(p)))(
        jp, jb)
    out = dict(jcfg=jcfg, jparams=jp, jb=jb, jout=np.asarray(jout.astype(jnp.float32)),
               jloss=float(jl), jgrad=jg)
    if arch == "equiformer-v2":
        out["chunked"] = _jax_chunked(out)
    return out


@pytest.fixture(scope="module")
def models(batches):
    """Per arch: the port's config, parameters (the JAX ones) and batch
    beside the JAX side (``_jax_model``, and EquiformerV2's chunked
    gradient; the compiles in threads)."""
    with ThreadPoolExecutor(len(MODELS)) as pool:
        jax_side = dict(zip(MODELS, pool.map(lambda a: _jax_model(a, batches), MODELS)))
    out = {}
    for arch, (_, mod, fields, which) in MODELS.items():
        cfg = getattr(mod, CFG_CLASS[arch])(**fields)
        j = jax_side[arch]
        out[arch] = dict(j, cfg=cfg, tb=batches[which][0],
                         params=mod.params_from_arrays(cfg, jax.tree.map(np.asarray, j["jparams"]),
                                                       "cpu"))
    return out


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(100, 400, 16, 7, 1), (3000, 50_000, 5, 41, 0), (7, 0, 3, 2, 4),
                                  (70_000, 300, 2, 3, 9)])
def test_random_graph_and_to_batch_like_jax(args):
    n, e, d, k, seed = args
    got, want = G.random_graph(n, e, d, n_classes=k, seed=seed), JG.random_graph(
        n, e, d, n_classes=k, seed=seed)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    assert got.n_nodes == n and got.n_edges == e
    _same(G.to_batch(got, k), JG.to_batch(want, k))


def test_neighbor_sampler_like_jax():
    g, jg = G.random_graph(5000, 40_000, 32, n_classes=7, seed=3), JG.random_graph(
        5000, 40_000, 32, n_classes=7, seed=3)
    samp, jsamp = G.NeighborSampler(g, (15, 10), seed=5), JG.NeighborSampler(jg, (15, 10), seed=5)
    for seeds in (np.arange(64), np.random.default_rng(2).choice(5000, 16, replace=False)):
        got, want = samp.sample(seeds), jsamp.sample(seeds)
        _same(got, want)
        assert got.node_feat.shape[0] == len(seeds) * 16 * 11
    # a block smaller than its padding: isolated seeds and a sparse graph
    sparse, jsparse = G.random_graph(400, 100, 4, seed=1), JG.random_graph(400, 100, 4, seed=1)
    _same(G.NeighborSampler(sparse, (5, 3)).sample(np.arange(0, 400, 7)),
          JG.NeighborSampler(jsparse, (5, 3)).sample(np.arange(0, 400, 7)))


@pytest.mark.parametrize("args", [(4, 8, 16, 2), (128, 30, 64, 0), (3, 5, 4, 7)])
def test_molecule_batch_like_jax(args):
    b, n, e, seed = args
    got = G.molecule_batch(b, n, e, seed=seed)
    _same(got, JG.molecule_batch(b, n, e, seed=seed))
    assert got.n_graphs == b
    moved = got.to("cpu")
    assert moved.species.dtype == torch.int32 and moved.edge_mask.dtype == torch.bool
    assert np.array_equal(moved.positions.numpy(), got.positions)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def test_so3_tables_exact():
    for l1 in range(4):
        for l2 in range(4):
            for l3 in range(5):
                assert np.array_equal(so3.cg_real(l1, l2, l3), jso3.cg_real(l1, l2, l3))
    for l in range(7):
        assert np.array_equal(so3.wigner_dy_real_poly(l), jso3.wigner_dy_real_poly(l))
        assert np.array_equal(so3._sh_norms(l), jso3._sh_norms(l))
    assert so3.irrep_slices(3) == jso3.irrep_slices(3) and so3.irrep_dim(6) == 49


def _like_jax_f32(got, want, exact, tol: float) -> None:
    """``got`` (the port, f32) within ``tol`` of ``want`` (JAX, f32), and no
    farther from ``exact`` (the port in float64 on the same inputs) than
    ``want`` is, give or take 1e-6."""
    got, exact = got.double(), exact.double()
    want = torch.from_numpy(np.asarray(want, np.float64))
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= tol
    assert float((got - exact).abs().max()) <= float((want - exact).abs().max()) + 1e-6


def test_so3_device_functions_like_jax():
    """XLA fuses the multiply-adds of the Legendre recursion and of the
    Wigner polynomials (FMA), so the two packages' f32 values part by
    rounding that grows with the degree: Y within 5e-6 (measured 2.5e-6 at
    l = 6, each package ~2.2e-6 from float64), the rotation blocks within
    3e-5 (measured 1.1e-5 at l = 6; each ~1.9e-4 from float64, the f32
    arccos near the poles).  Below degree 3 they agree within 1e-6 (Y) and
    5e-6 (blocks)."""
    rng = np.random.default_rng(4)
    v = rng.standard_normal((40, 3)).astype(np.float32)
    v[0] = 0.0  # a padding edge: atan2(0, 0), arccos(0)
    v[1] = [0.0, 0.0, 2.0]  # on the pole
    tv, jv = torch.from_numpy(v), jnp.asarray(v)
    phi = rng.uniform(-3, 3, 9).astype(np.float32)
    tp, jp = torch.from_numpy(phi), jnp.asarray(phi)
    want = jax.jit(lambda x, p: {f"l{L}": (jso3.real_sph_harm(x, L), jso3.align_blocks(x, L),
                                           jso3.align_to_z(x, L)) for L in (2, 6)}
                   | {"rz": jso3.rz_real(3, p), "ry": jso3.ry_real(3, p)})(jv, jp)
    for L, y_tol, r_tol in ((2, 1e-6, 5e-6), (6, 5e-6, 3e-5)):
        jY, jblocks, (jR, jRinv) = want[f"l{L}"]
        _like_jax_f32(so3.real_sph_harm(tv, L), jY, so3.real_sph_harm(tv.double(), L), y_tol)
        for a, b, x in zip(so3.align_blocks(tv, L), jblocks, so3.align_blocks(tv.double(), L)):
            _like_jax_f32(a, b, x, r_tol)
        (R, Rinv), (xR, _) = so3.align_to_z(tv, L), so3.align_to_z(tv.double(), L)
        _like_jax_f32(R, jR, xR, r_tol)
        _like_jax_f32(Rinv, jRinv, xR.transpose(-1, -2), r_tol)
        # R maps Y(v̂) to Y(ẑ) and is orthogonal
        Yz = so3.real_sph_harm(torch.tensor([[0.0, 0.0, 1.0]]), L)
        Yr = torch.einsum("eab,eb->ea", R[2:], so3.real_sph_harm(tv[2:], L))
        assert float((Yr - Yz).abs().max()) < 1e-3
        eye = R @ Rinv
        assert float((eye - torch.eye(so3.irrep_dim(L))).abs().max()) < 1e-4
    _like_jax_f32(so3.rz_real(3, tp), want["rz"], so3.rz_real(3, tp.double()), 1e-6)
    _like_jax_f32(so3.ry_real(3, tp), want["ry"], so3.ry_real(3, tp.double()), 5e-6)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def _jax_common(h, dst, mask, n, mlp, logits, labels, nmask, out, mb, r):
    """The reference's ``common`` helpers on one set of inputs (one jit)."""
    res = dict(sum=jax.ops.segment_sum(h, dst, n), max=jax.ops.segment_max(h[:, 0], dst, n),
               mean=JC.segment_mean(h, dst, n), mean_m=JC.segment_mean(h, dst, n, mask),
               scatter=JC.scatter_edges(h, dst, n), scatter_m=JC.scatter_edges(h, dst, n, mask),
               mlp=JC.mlp_apply(mlp, h), mlp_fa=JC.mlp_apply(mlp, h, final_act=True),
               node_loss=JC.node_class_loss(logits, labels, nmask),
               graph_loss=JC.graph_regression_loss(out, mb), rbf=JC.bessel_rbf(r, 8, 6.0))
    return res


def test_common_helpers_like_jax():
    rng = np.random.default_rng(6)
    n, e = 30, 120
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n - 3, e).astype(np.int32)  # 3 empty segments
    h = rng.standard_normal((e, 8)).astype(np.float32)
    mask = rng.random(e) < 0.8
    logits = rng.standard_normal((n, 7)).astype(np.float32)
    labels = rng.integers(-1, 7, n).astype(np.int32)
    nmask = rng.random(n) < 0.9
    out = rng.standard_normal((32, 1)).astype(np.float32)
    r = np.concatenate([[0.0, 1e-6, 6.0, 9.0], rng.uniform(0, 7, 60)]).astype(np.float32)
    mb = G.molecule_batch(4, 8, 16, seed=2)
    jmlp = jax.jit(lambda k: JC.mlp_params(k, [8, 16, 5]))(jax.random.PRNGKey(1))
    want = jax.jit(partial(_jax_common, n=n))(
        jnp.asarray(h), jnp.asarray(dst), jnp.asarray(mask), mlp=jmlp, logits=jnp.asarray(logits),
        labels=jnp.asarray(labels), nmask=jnp.asarray(nmask), out=jnp.asarray(out),
        mb=_jnp(JG.molecule_batch(4, 8, 16, seed=2)), r=jnp.asarray(r))
    want = {k: np.asarray(v) for k, v in want.items()}
    th, tdst, tmask = torch.from_numpy(h), torch.from_numpy(dst), torch.from_numpy(mask)
    tmlp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jmlp)
    got = dict(sum=C.segment_sum(th, tdst, n), max=C.segment_max(th[:, 0], tdst, n),
               mean=C.segment_mean(th, tdst, n), mean_m=C.segment_mean(th, tdst, n, tmask),
               scatter=C.scatter_edges(th, tdst, n), scatter_m=C.scatter_edges(th, tdst, n, tmask),
               mlp=C.mlp_apply(tmlp, th), mlp_fa=C.mlp_apply(tmlp, th, final_act=True),
               node_loss=C.node_class_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                           torch.from_numpy(nmask)),
               graph_loss=C.graph_regression_loss(torch.from_numpy(out), mb.to("cpu")),
               rbf=C.bessel_rbf(torch.from_numpy(r), 8, 6.0))
    assert set(got) == set(want)
    assert np.array_equal(_np(got["max"]), want["max"])  # -inf for the empty segments too
    assert np.isneginf(want["max"][-3:]).all()
    for k, v in got.items():
        np.testing.assert_allclose(_np(v), want[k], rtol=1e-5, atol=1e-6, err_msg=k)
    # a bf16 sum accumulates in f32 and rounds once (the reference rounds every add)
    hb = th.bfloat16()
    exact = torch.zeros(n, 8, dtype=torch.float64).index_add_(0, tdst.long(), hb.double())
    assert torch.equal(C.segment_sum(hb, tdst, n), exact.float().bfloat16())
    # segment message passing == dense adjacency product
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    A = torch.zeros(n, n).index_put_((tdst.long(), torch.from_numpy(src).long()), torch.ones(e),
                                     accumulate=True)
    torch.testing.assert_close(C.scatter_edges(x[src], tdst, n), A @ x, rtol=1e-5, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    p = C.mlp_params(gen, [8, 16, 5], scale=2.0)
    assert [tuple(w.shape) for w in p["w"]] == [(8, 16), (16, 5)] and not p["b"][1].any()
    assert float(p["w"][0].std()) == pytest.approx(2.0 / np.sqrt(8), rel=0.25)


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["egnn", "mace", "equiformer-v2"])
def test_f32_model_like_jax(models, arch):
    m = models[arch]
    mod = MODELS[arch][1]
    out = mod.forward(m["cfg"], m["params"], m["tb"])
    assert float(np.std(m["jout"])) > 1e-3  # not vanishing
    assert _rel(_np(out), m["jout"]) <= FWD_TOL
    loss, grads = value_and_grad(lambda p, b: mod.loss_fn(m["cfg"], p, b), m["params"], m["tb"])
    np.testing.assert_allclose(float(loss), m["jloss"], rtol=FWD_TOL)
    _grads_close(grads, m["jgrad"], GRAD_TOL)


def _jax_graphcast_layer(lp, g, h, e):
    """One processor block of the JAX ``graphcast.forward`` (its closure),
    from the reference's ``common`` functions."""
    hs = jnp.take(h, g.edge_src, axis=0)
    hd = jnp.take(h, g.edge_dst, axis=0)
    e = e + JC.mlp_apply(lp["edge_mlp"], jnp.concatenate([e, hs, hd], axis=-1))
    agg = JC.scatter_edges(e, g.edge_dst, h.shape[0], g.edge_mask)
    h = h + JC.mlp_apply(lp["node_mlp"], jnp.concatenate([h, agg], axis=-1))
    return h, e


def test_graphcast_layer_by_layer_and_whole(models):
    """The encoder exactly as the reference rounds it, each processor layer
    on the reference's own inputs within ``LAYER_TOL``, the decoder's
    output and the whole model's gradient by ``GRAPHCAST_TOL``."""
    m = models["graphcast"]
    cfg, jp, jb, tb = m["cfg"], m["jparams"], m["jb"], m["tb"]
    h = JC.mlp_apply(jp["node_enc"], jb.node_feat).astype(jnp.bfloat16)
    e = JC.mlp_apply(jp["edge_enc"], jb.edge_feat).astype(jnp.bfloat16)
    th, te = graphcast.encode(cfg, m["params"], tb)
    assert th.dtype == te.dtype == torch.bfloat16
    assert _rel(_np(th), np.asarray(h.astype(jnp.float32))) <= 1e-2
    layer = jax.jit(_jax_graphcast_layer)
    for i, lp in enumerate(jp["layers"]):
        th = torch.from_numpy(np.asarray(h.astype(jnp.float32))).bfloat16()
        te = torch.from_numpy(np.asarray(e.astype(jnp.float32))).bfloat16()
        h, e = layer(lp, jb, h, e)
        gh, ge = graphcast.layer(m["params"]["layers"][i], tb, th, te)
        assert _rel(_np(ge), np.asarray(e.astype(jnp.float32))) <= LAYER_TOL, i
        assert _rel(_np(gh), np.asarray(h.astype(jnp.float32))) <= LAYER_TOL, i
    out = graphcast.forward(cfg, m["params"], tb)
    assert out.dtype == torch.float32
    assert _rel(_np(out), m["jout"]) <= GRAPHCAST_TOL["forward"]
    loss, grads = value_and_grad(lambda p, b: graphcast.loss_fn(cfg, p, b), m["params"], tb)
    np.testing.assert_allclose(float(loss), m["jloss"], rtol=GRAPHCAST_TOL["forward"])
    _grads_close(grads, m["jgrad"], GRAPHCAST_TOL["grad"])


def test_equiformer_chunked_like_jax_and_one_chunk(models):
    """``edge_chunks=3`` (64 edges padded to 66): the port's autograd
    function against the JAX custom VJP, and against the port's one-chunk
    path; under autograd the chunked forward saves no edge-sized tensor."""
    m = models["equiformer-v2"]
    cfg = dataclasses.replace(m["cfg"], edge_chunks=CHUNKS)
    jl, jg = m["chunked"]
    sizes = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: sizes.append(t.shape) or t,
                                                  lambda t: t):
        loss, grads = value_and_grad(lambda p, b: eq.loss_fn(cfg, p, b), m["params"], m["tb"])
    E = m["tb"].edge_src.shape[0]
    assert sizes and all(s[0] != E for s in sizes if len(s) == 3)  # [E, C, dim] never saved
    np.testing.assert_allclose(float(loss), float(jl), rtol=FWD_TOL)
    _grads_close(grads, jg, GRAD_TOL)
    one_loss, one = value_and_grad(lambda p, b: eq.loss_fn(m["cfg"], p, b), m["params"], m["tb"])
    np.testing.assert_allclose(float(loss), float(one_loss), rtol=FWD_TOL)
    for (path, a), (_, b) in zip(leaves(grads), leaves(one)):
        err = float((a - b).norm())
        assert err <= GRAD_TOL * float(b.norm()) or err <= 1e-8, path


@pytest.mark.parametrize("arch", ["egnn", "mace", "equiformer-v2"])
def test_rotation_invariance(models, arch):
    m = models[arch]
    mod = MODELS[arch][1]
    g = m["tb"]
    with torch.no_grad():
        a = mod.forward(m["cfg"], m["params"], g)
        b = mod.forward(m["cfg"], m["params"],
                        g._replace(positions=g.positions @ torch.from_numpy(ROT).T))
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", list(MODELS))
def test_remat_changes_nothing(models, arch):
    """A layer recomputed in the backward gives the same loss and
    gradients as one whose activations are kept."""
    m = models[arch]
    mod = MODELS[arch][1]
    runs = [value_and_grad(lambda p, b, r=r: mod.loss_fn(dataclasses.replace(m["cfg"], remat=r),
                                                         p, b), m["params"], m["tb"])
            for r in (True, False)]
    assert float(runs[0][0]) == float(runs[1][0])
    for (path, a), (_, b) in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        assert torch.equal(a, b), path
