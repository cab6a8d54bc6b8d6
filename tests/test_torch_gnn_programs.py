"""The GNN programs of ``repro_torch`` against the JAX package's
``repro.launch.programs.build_gnn``, and the train driver's GNN branch:

* ``build_gnn`` for all 16 cells (4 archs x 4 shapes), full and smoke:
  the name, the cfg (``out_dim``, ``in_dim``, ``edge_chunks=128`` at >= 10
  M edges, remat off for ``ogb_products``), ``model_flops`` and the
  meta-device ``in_specs`` (parameters, AdamW state, the ``GraphBatch``)
  leaf for leaf against the JAX builder's on a (1, 1) ``AbstractMesh``;
* one smoke step of each arch (the four shapes covered once) on the JAX
  parameters and the port's ``gnn_batch`` against the JAX program's ``fn``
  (jitted, on an ``AxisType.Auto`` (1, 1) mesh): the forward, the loss,
  ``grad_norm``, AdamW's first moments (0.1 x the gradient, so the
  gradient a leaf) and the new parameters (each within 2.02·lr of the
  reference's; AdamW's first update is ±lr wherever |g| ≫ eps, and there
  every sign equal, GraphCast's where |g| is past a tenth of its leaf's
  RMS); f32 archs within 1e-5 / 1e-4,
  GraphCast (bf16 states) within its measured whole-model bounds;
* ``gnn_inputs`` / ``gnn_graph`` / ``gnn_batch``: seeded, the molecule
  batch padded with masked edges at node 0, cut graphs, and the refusals
  (a mesh's axes; the mesh programs are ``tests/test_torch_gnn_mesh.py``'s);
* ``python -m repro_torch.launch.train --arch <gnn arch> --smoke --device
  cpu`` trains each of the four archs.
"""

import dataclasses
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.launch import programs as jprograms
from repro_torch.configs import ARCHS
from repro_torch.launch import mesh as meshlib, programs, train as train_driver
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
GNN_ARCHS = ("mace", "graphcast", "egnn", "equiformer-v2")
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# one smoke step an arch, the four shapes covered once
STEP_CELLS = (("egnn", "minibatch_lg"), ("graphcast", "full_graph_sm"), ("mace", "molecule"),
              ("equiformer-v2", "ogb_products"))
TOL = dict(forward=1e-5, loss=1e-5, grad=1e-4, share=0.0, sign_floor=0.0)
# GraphCast's bf16 states (tests/test_torch_gnn.py), measured on this cell: forward 7.2e-3,
# loss 4.6e-4, grad_norm 3.7e-4, first moments ≤ 1.5e-2 a leaf; an update's sign flips where
# |g| is within that error (XLA's threaded bf16 products are not the same from run to run)
GRAPHCAST_TOL = dict(forward=2.5e-2, loss=5e-3, grad=4e-2, share=0.0, sign_floor=0.1)
LR = 3e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _jax_mesh11():
    auto = (jax.sharding.AxisType.Auto,) * 2  # the builder's sharding constraints need Auto axes
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=auto)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_build_gnn_like_jax(arch, shape, smoke):
    prog = programs.build(arch, shape, _mesh((1, 1)), smoke=smoke)
    jprog = jprograms.build(arch, shape, AbstractMesh((1, 1), ("data", "model")), smoke=smoke)
    assert prog.name == jprog.name and prog.model_flops == jprog.model_flops
    pspecs, ospecs, gb = prog.in_specs
    jp, jo, jgb = jprog.in_specs
    for got, want in ((pspecs, jp), (ospecs, jo)):
        got, want = list(leaves(got)), jax.tree_util.tree_leaves_with_path(want)
        assert len(got) == len(want)
        for (path, g), (jpath, w) in zip(got, want):
            assert g.device.type == "meta"  # nothing allocated
            assert tuple(g.shape) == tuple(w.shape) and str(g.dtype)[6:] == str(w.dtype), path
    assert gb._fields == jgb._fields
    for f, g, w in zip(gb._fields, gb, jgb):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape), f
        assert str(g.dtype)[6:] == str(w.dtype), f
    # the cfg: the JAX builder's rules (from the JAX specs' sizes) on the arch's cfg
    base = (ARCHS[arch].smoke_cfg if smoke else ARCHS[arch].cfg)
    want = dict(out_dim=JARCHS[arch].shape(shape).dims.get("n_classes", 0) or 1)
    if hasattr(base, "in_dim"):
        want["in_dim"] = jgb.node_feat.shape[1]
    if hasattr(base, "edge_chunks"):
        want["edge_chunks"] = 128 if (not smoke and jgb.edge_src.shape[0] >= 10_000_000) else 1
    want["remat"] = smoke or shape != "ogb_products"
    assert prog.cfg == dataclasses.replace(base, **want)
    assert prog.opt is not None and prog.cfg.name == base.name


def _jax_step(arch, shape, batch):
    """The JAX smoke program's parameters (the arch's ``init``, key 1), its
    forward and one step from zero state on ``batch`` (one jitted call)."""
    jprog = jprograms.build(arch, shape, _jax_mesh11(), smoke=True)
    jmod = jprograms.GNN_MODULES[arch]
    cfg = programs.build(arch, shape, _mesh((1, 1)), smoke=True).cfg
    jcfg = getattr(jmod, type(cfg).__name__)(**dataclasses.asdict(cfg))
    jp = jax.jit(lambda k: jmod.init(jcfg, k))(jax.random.PRNGKey(1))
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jprog.in_specs[1])
    jb = jax.tree.map(jnp.asarray, batch)
    out, (new, st, m) = jax.jit(lambda p, s, b: (jmod.forward(jcfg, p, b), jprog.fn(p, s, b)))(
        jp, state, jb)
    return dict(params_np=jax.tree.map(np.asarray, jp), out=np.asarray(out.astype(jnp.float32)),
                new=new, state=st, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))


@pytest.fixture(scope="module")
def steps():
    """Per STEP_CELLS cell: the port program, the port's batch (seed 3)
    and the JAX side (``_jax_step``; the four compiles in threads)."""
    cells = {}
    for arch, shape in STEP_CELLS:
        prog = programs.build(arch, shape, _mesh((1, 1)), smoke=True)
        cells[arch] = dict(prog=prog, shape=shape,
                           batch=programs.gnn_batch(prog, programs.gnn_graph(prog, seed=3),
                                                    seed=3))
    with ThreadPoolExecutor(len(cells)) as pool:
        jax_side = dict(zip(cells, pool.map(
            lambda a: _jax_step(a, cells[a]["shape"], cells[a]["batch"]), cells)))
    for arch, c in cells.items():
        c["jax"] = jax_side[arch]
        c["params_np"] = c["jax"]["params_np"]
    return cells


@pytest.mark.parametrize("arch, shape", STEP_CELLS)
def test_smoke_step_like_jax(steps, arch, shape):
    c = steps[arch]
    prog, j = c["prog"], c["jax"]
    tol = GRAPHCAST_TOL if arch == "graphcast" else TOL
    mod = programs.GNN_MODULES[arch]
    params = mod.params_from_arrays(prog.cfg, c["params_np"], "cpu")
    batch = c["batch"].to("cpu")
    with torch.no_grad():
        out = mod.forward(prog.cfg, params, batch)
    assert float(np.std(j["out"])) > 1e-3 and _rel(out.float().numpy(), j["out"]) <= tol["forward"]
    state = prog.opt.init(params)
    new, st, m = prog.fn(params, state, batch)
    assert new is params and st is state  # updated in place
    np.testing.assert_allclose(float(m["loss"]), j["loss"], rtol=tol["loss"])
    np.testing.assert_allclose(float(m["grad_norm"]), j["grad_norm"], rtol=tol["loss"] * 10)
    total = np.sqrt(sum(float(np.sum(np.square(np.asarray(w)))) for w in
                        jax.tree.leaves(j["state"]["mu"])))
    for (path, a), w in zip(leaves(st["mu"]), jax.tree.leaves(j["state"]["mu"])):
        w = np.asarray(w)
        err = float(np.linalg.norm(a.numpy().astype(np.float64) - w))
        # a leaf zero but for rounding (EquiformerV2's last attention bias) by the whole norm
        assert err <= tol["grad"] * np.linalg.norm(w) or err <= 1e-6 * total, (path, err)
    assert int(st["step"]) == int(j["state"]["step"]) == 1
    for (path, a), w, mu in zip(leaves(new), jax.tree.leaves(j["new"]),
                                jax.tree.leaves(j["state"]["mu"])):
        off = np.abs(a.numpy() - np.asarray(w))
        assert off.max() <= 2.02 * LR, path
        # where |g| ≫ eps (|mu| = 0.1 |g| > 1e-7) the first update is ±lr: the same sign
        # (GraphCast: where |g| is past its bf16 error, ``sign_floor`` of the leaf's RMS)
        mu = np.abs(np.asarray(mu))
        big = mu > max(1e-7, tol["sign_floor"] * float(np.sqrt(np.mean(mu**2))))
        share = np.mean(off[big] > 1e-6 + 1e-6 * np.abs(np.asarray(w)[big])) if big.any() else 0.0
        assert share <= tol["share"], path


def test_gnn_inputs_and_refusals():
    mesh = _mesh((1, 1))
    mol = programs.build("egnn", "molecule", mesh, smoke=True)
    params, state, b = programs.gnn_inputs(mol, "cpu", seed=2)
    assert b.node_feat.shape == (8 * 30, 8) and b.edge_src.shape == (8 * 64,)
    real = 8 * 30 * 2  # k = 64 // 30 = 2 nearest neighbours a node
    assert b.edge_mask[:real].all() and not b.edge_mask[real:].any()
    assert not b.edge_src[real:].any() and not b.edge_dst[real:].any()
    assert b.n_graphs == 8 and b.species.dtype == torch.int32
    assert set(state) == {"mu", "nu", "step"} and not params["layers"][0]["phi_e"]["b"][0].any()
    again = programs.gnn_inputs(mol, "cpu", seed=2)
    for (path, x), (_, y) in zip(leaves(params), leaves(again[0])):
        assert torch.equal(x, y), path
    assert all(torch.equal(x, y) for x, y in zip(b, again[2]))
    full_mol = programs.build("mace", "molecule", mesh)
    fb = programs.gnn_batch(full_mol, None, seed=0)
    assert fb.edge_src.shape == (8192,) and int(fb.edge_mask.sum()) == 7680
    mace_p = programs.gnn_inputs(programs.build("mace", "molecule", mesh, smoke=True), "cpu")[0]
    assert mace_p["layers"][0]["readout"]["b"][0].any()  # MACE draws its biases too
    # a fanout sample from the smoke host graph: the program's padded sizes, labels on the seeds
    mb = programs.build("graphcast", "minibatch_lg", mesh, smoke=True)
    g = programs.gnn_graph(mb, seed=1)
    assert (g.n_nodes, g.n_edges, g.feat.shape[1]) == (256, 1024, 602)
    sb = programs.gnn_batch(mb, g, seed=1)
    assert sb.node_feat.shape == (16 * 16 * 11, 602) and sb.edge_src.shape == (16 * 15 + 16 * 150,)
    assert int((sb.labels >= 0).sum()) == 16
    # a cut graph under a full shape's program
    ogb = programs.build("egnn", "ogb_products", mesh)
    assert ogb.in_specs[2].edge_src.shape == (61_859_140,) and ogb.cfg.remat is False
    cut = programs.gnn_inputs(ogb, "cpu", n_nodes=400, n_edges=10_000, seed=5)[2]
    assert cut.node_feat.shape == (400, 100) and cut.edge_src.shape == (10_000,)
    assert int(cut.labels.max()) < 47
    with pytest.raises(ValueError, match="at most 2449029 nodes"):
        programs.gnn_graph(ogb, n_nodes=2_449_030)
    with pytest.raises(ValueError, match="not cut"):
        programs.gnn_inputs(mol, "cpu", n_nodes=30)
    with pytest.raises(ValueError, match="not a GNN program"):
        programs.gnn_inputs(programs.build("xdeepfm", "serve_p99", mesh, smoke=True), "cpu")
    with pytest.raises(ValueError, match="not an LM program"):
        programs.lm_inputs(mol, "cpu")
    with pytest.raises(ValueError, match="not a recsys program"):
        programs.recsys_inputs(mol, "cpu")
    for arch in GNN_ARCHS:
        assert programs.build(arch, "full_graph_sm", _mesh((2, 1)), smoke=True).mesh is not None
        with pytest.raises(ValueError, match="has a 'model' axis"):
            programs.build(arch, "full_graph_sm", meshlib.make_mesh(
                (2, 1), ("data", "expert"), ["cpu"] * 2), smoke=True)
    assert programs.build("equiformer-v2", "minibatch_lg", mesh).cfg.edge_chunks == 1
    assert programs.build("equiformer-v2", "ogb_products", mesh).cfg.edge_chunks == 128


def test_train_driver_gnn_on_cpu(tmp_path, capsys):
    """The driver's GNN branch trains each arch two steps on the 512-node
    graph; ``python -m`` runs it as a user would."""
    for arch in GNN_ARCHS:
        argv = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--log-every", "1",
                "--ckpt-dir", str(tmp_path / arch)]
        hist = train_driver.main(argv)
        assert [h["step"] for h in hist] == [1, 2] and all(np.isfinite(h["loss"]) for h in hist)
        assert ckpt.published_steps(str(tmp_path / arch)) == [2]
    assert "done: 2 steps" in capsys.readouterr().out
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "egnn", "--smoke", "--device",
         "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path / "cli")],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "done: 2 steps" in run.stdout
