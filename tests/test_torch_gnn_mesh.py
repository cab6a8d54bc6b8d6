"""The GNN programs of ``repro_torch`` on a mesh of several devices
(``launch/programs.py::build_gnn``, ``models/gnn/common.py::OnMesh``,
``dist/collectives.py``'s halo gather and summed scatter):

* four archs at two smoke shapes each, one AdamW step on ``cpu`` meshes
  (1, 2), (2, 1), (1, 4), (2, 2) and (2, 4) against the port's own (1, 1)
  step from the same parameters and graph: the loss within 1e-6 relative,
  each leaf's gradient (AdamW's first moment, 0.1 x the gradient) within
  1e-5 relative L2 or 1e-6 of the whole gradient's norm (a leaf zero but
  for rounding); GraphCast, whose node and edge states are bf16, within the
  (1, 1) bounds of ``tests/test_torch_gnn_programs.py``;
* the same on (2, 4) with a distinct tensor at every position (what
  distinct cards hold): the holders' gradients sum to the true gradient;
* the port's (2, 4) step against the JAX (2, 4) program at each arch's
  first cell (run once, in a subprocess that is this file's ``__main__``
  with eight host devices and ``AxisType.Auto`` axes) within the bounds
  ``test_torch_gnn_programs.py`` uses for (1, 1);
* EquiformerV2's chunked online softmax on meshes against one device;
* ``in_specs`` (padded) and ``in_shardings`` against the JAX package's on
  a (2, 4) ``AbstractMesh``; the wire-byte counter of the two graph
  collectives.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = (2, 4)
CELLS = (("egnn", "minibatch_lg"), ("egnn", "molecule"),
         ("graphcast", "full_graph_sm"), ("graphcast", "molecule"),
         ("mace", "molecule"), ("mace", "full_graph_sm"),
         ("equiformer-v2", "ogb_products"), ("equiformer-v2", "molecule"))
JAX_CELLS = CELLS[::2]  # held against the JAX (2, 4) program: each arch's first cell
SEED = 3


def port_batch(arch, shape, mshape):
    """The port's smoke batch of the cell (seed ``SEED``), padded as the
    program on ``mshape`` pads it, as numpy arrays."""
    from repro_torch.launch import mesh as meshlib, programs

    prog = programs.build(arch, shape, meshlib.make_mesh((1, 1), ("data", "model"), ["cpu"]),
                          smoke=True)
    b = programs.gnn_batch(prog, programs.gnn_graph(prog, seed=SEED), seed=SEED)
    n, e = programs._gnn_padded(meshlib.make_mesh(mshape, ("data", "model"),
                                                  ["cpu"] * int(np.prod(mshape))),
                                b.node_feat.shape[0], b.edge_src.shape[0])
    return type(b)(*(np.asarray(x) for x in programs.gnn_pad(b, n, e)))


def jax_main(out_path):
    """One step of each cell's JAX smoke program on an ``Auto`` (2, 4)
    mesh from the arch's ``init`` (key 1), zero state and the port's padded
    batch."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    from repro.launch import programs as jprograms
    from repro.models.gnn import common as jcommon

    auto = (jax.sharding.AxisType.Auto,) * 2
    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=auto)

    def one(cell):
        arch, shape = cell
        jprog = jprograms.build(arch, shape, mesh, smoke=True)
        jmod = jprograms.GNN_MODULES[arch]
        from repro_torch.launch import programs

        cfg = programs.build(arch, shape, _mesh11(), smoke=True).cfg
        jcfg = getattr(jmod, type(cfg).__name__)(**dataclasses.asdict(cfg))
        jp = jax.jit(lambda k: jmod.init(jcfg, k))(jax.random.PRNGKey(1))
        state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jprog.in_specs[1])
        batch = jcommon.GraphBatch(*(jnp.asarray(x) for x in port_batch(arch, shape, MESH)))
        with mesh:
            _, st, m = jax.jit(jprog.fn, in_shardings=jprog.in_shardings)(jp, state, batch)
        out = {"loss": np.asarray(m["loss"]), "grad_norm": np.asarray(m["grad_norm"])}
        for i, (path, a) in enumerate(jax.tree_util.tree_leaves_with_path(jp)):
            out[f"p/{i}"] = np.asarray(a)
        for i, a in enumerate(jax.tree.leaves(st["mu"])):
            out[f"mu/{i}"] = np.asarray(a)
        return {f"{arch}/{shape}/{k}": v for k, v in out.items()}

    res = {}
    with ThreadPoolExecutor(4) as pool:
        for r in pool.map(one, JAX_CELLS):
            res.update(r)
    np.savez(out_path, **res)


def _mesh11():
    from repro_torch.launch import mesh as meshlib

    return meshlib.make_mesh((1, 1), ("data", "model"), ["cpu"])


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    jax_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.launch import programs as jprograms  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.dist.sharding import Sharded  # noqa: E402
from repro_torch.launch import mesh as meshlib, programs  # noqa: E402
from repro_torch.models.gnn import common as C, equiformer_v2  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

MESHES = ((1, 2), (2, 1), (1, 4), (2, 2), (2, 4))
SELF_TOL = dict(loss=1e-6, grad=1e-5)
# GraphCast's bf16 states: the bounds test_torch_gnn_programs.py holds (1, 1) to
GRAPHCAST_TOL = dict(loss=5e-3, grad=4e-2)
# against the JAX program: test_torch_gnn_programs.py's TOL / GRAPHCAST_TOL
JAX_TOL = dict(loss=1e-5, grad=1e-4)
FLOOR = 1e-6  # a leaf zero but for rounding, by the whole gradient's norm


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_gnn_mesh") / "out.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return dict(z)


def cpu_mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _np(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = x.unshard()
    return x.detach().double().numpy()


def _apart(s):
    """``s`` with a distinct copy of its block at every position."""
    return Sharded(tuple(t.clone() for t in s.parts), s.mesh, s.spec)


@pytest.fixture(scope="module")
def params():
    """Per cell, the smoke parameters (seed ``SEED``) on the CPU."""
    out = {}
    for arch, shape in CELLS:
        prog = programs.build(arch, shape, _mesh11(), smoke=True)
        out[arch, shape] = programs.GNN_MODULES[arch].init(
            prog.cfg, torch.Generator().manual_seed(SEED), device="cpu")
    return out


def step(arch, shape, mshape, p, *, apart=False, batch=None) -> dict:
    """One step of the smoke program on a ``cpu`` mesh of ``mshape`` from a
    copy of ``p`` and the cell's batch: loss, grad_norm, first moments."""
    prog = programs.build(arch, shape, cpu_mesh(mshape), smoke=True)
    b = port_batch(arch, shape, mshape) if batch is None else batch
    b = C.GraphBatch(*(torch.from_numpy(np.array(x)) for x in b))
    p = tree_map(torch.clone, p)
    args = (p, prog.opt.init(p), b)
    if prog.mesh is not None:
        args = programs.gnn_place_on(prog.mesh, prog.in_shardings, args)
        if apart:
            args = (tree_map(_apart, args[0]), tree_map(_apart, args[1]),
                    C.GraphBatch(*(_apart(x) for x in args[2])))
    _, st, m = prog.fn(*args)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                mu=[_np(v) for _, v in leaves(st["mu"])])


def check(got, want, tol, what):
    assert abs(got["loss"] - want["loss"]) <= tol["loss"] * abs(want["loss"]), what
    assert abs(got["grad_norm"] - want["grad_norm"]) <= 10 * tol["loss"] * want["grad_norm"], what
    total = np.sqrt(sum(np.sum(w**2) for w in want["mu"]))
    for i, (a, w) in enumerate(zip(got["mu"], want["mu"])):
        err = np.linalg.norm(a - w)
        assert err <= tol["grad"] * np.linalg.norm(w) or err <= FLOOR * total, (what, i, err)


@pytest.fixture(scope="module")
def singles(params):
    return {(a, s): step(a, s, (1, 1), params[a, s]) for a, s in CELLS}


@pytest.mark.parametrize("arch, shape", CELLS)
def test_mesh_step_against_one_device(arch, shape, params, singles):
    tol = GRAPHCAST_TOL if arch == "graphcast" else SELF_TOL
    for mshape in MESHES:
        check(step(arch, shape, mshape, params[arch, shape]), singles[arch, shape], tol, mshape)


@pytest.mark.parametrize("arch", sorted(dict(CELLS)))
def test_mesh_step_with_distinct_holders(arch, params, singles):
    """Every position holds its own copy of the parameters, state and batch
    (distinct cards): replicas compute their slice's node work each, and the
    trainer's sum of the holders' gradients is still the one-device
    gradient."""
    shape = dict(CELLS)[arch]
    tol = GRAPHCAST_TOL if arch == "graphcast" else SELF_TOL
    check(step(arch, shape, MESH, params[arch, shape], apart=True), singles[arch, shape], tol,
          arch)


@pytest.mark.parametrize("arch, shape", JAX_CELLS)
def test_mesh_step_like_jax(arch, shape, jax_side):
    tag = f"{arch}/{shape}"
    prog = programs.build(arch, shape, cpu_mesh(MESH), smoke=True)
    mod = programs.GNN_MODULES[arch]
    n_p = len(list(leaves(mod.param_specs(prog.cfg))))
    arrays = [jax_side[f"{tag}/p/{i}"] for i in range(n_p)]
    tree = jax.tree.unflatten(jax.tree.structure(jax.tree.map(
        lambda t: 0, mod.param_specs(prog.cfg), is_leaf=lambda x: isinstance(x, torch.Tensor))),
        arrays)
    p = mod.params_from_arrays(prog.cfg, tree, "cpu")
    want = dict(loss=float(jax_side[f"{tag}/loss"]), grad_norm=float(jax_side[f"{tag}/grad_norm"]),
                mu=[jax_side[f"{tag}/mu/{i}"].astype(np.float64) for i in range(n_p)])
    tol = GRAPHCAST_TOL if arch == "graphcast" else JAX_TOL
    check(step(arch, shape, MESH, p), want, tol, tag)


@pytest.mark.parametrize("mshape", [(1, 2), (2, 2), (2, 4)])
def test_chunked_attention_on_a_mesh(mshape, params):
    """EquiformerV2 in 16 edge chunks (a position's share in 16 / positions):
    each position's running statistics combined over the mesh equal one
    device's chunked attention (the forward and every gradient)."""
    prog = programs.build("equiformer-v2", "molecule", _mesh11(), smoke=True)
    cfg = dataclasses.replace(prog.cfg, edge_chunks=16)
    b1 = port_batch("equiformer-v2", "molecule", (1, 1))
    bm = port_batch("equiformer-v2", "molecule", mshape)

    def grads(mshape, b):
        p = tree_map(lambda t: t.clone().requires_grad_(), params["equiformer-v2", "molecule"])
        g = C.GraphBatch(*(torch.from_numpy(np.array(x)) for x in b))
        if mshape != (1, 1):
            mesh = cpu_mesh(mshape)
            pp = tree_map(lambda t: Sharded((t,) * len(mesh.devices), mesh, (None,) * t.dim()), p)
            g = programs.gnn_place_on(mesh, programs._gnn_layout((p, {}, g), mesh), (p, {}, g))[2]
        else:
            pp = p
        loss = equiformer_v2.loss_fn(cfg, pp, g)
        loss.backward()
        return float(loss), [(t.grad if t.grad is not None else torch.zeros_like(t))
                             .double().numpy() for _, t in leaves(p)]

    l1, g1 = grads((1, 1), b1)
    lm, gm = grads(mshape, bm)
    assert abs(lm - l1) <= 1e-6 * abs(l1)
    total = np.sqrt(sum(np.sum(g**2) for g in g1))
    for a, w in zip(gm, g1):
        err = np.linalg.norm(a - w)
        assert err <= 1e-5 * np.linalg.norm(w) or err <= FLOOR * total


@pytest.mark.parametrize("arch", sorted(dict(CELLS)))
def test_mesh_layout_like_jax(arch):
    """``in_specs`` padded as the JAX package pads (nodes to the data
    slices, edges to data x model) and ``in_shardings`` its partition
    specs, for every shape of the arch."""
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"):
        prog = programs.build(arch, shape, cpu_mesh(MESH), smoke=True)
        jprog = jprograms.build(arch, shape, AbstractMesh(MESH, ("data", "model")), smoke=True)
        assert prog.mesh is not None and prog.model_flops == jprog.model_flops
        for f, g, w in zip(prog.in_specs[2]._fields, prog.in_specs[2], jprog.in_specs[2]):
            assert tuple(g.shape) == tuple(w.shape), (shape, f)
        psh, osh, gsh = prog.in_shardings
        jpsh, josh, jgsh = jprog.in_shardings
        for got, want in ((psh, jpsh), (osh, josh)):
            got = [s for _, s in leaves(got)]
            want = jax.tree.leaves(want, is_leaf=lambda x: hasattr(x, "spec"))
            assert len(got) == len(want)
            assert all(all(e is None for e in s) and tuple(w.spec) == () for s, w in zip(got, want))
        for f, s, w in zip(gsh._fields, gsh, jgsh):
            assert tuple(s[:len(w.spec)]) == tuple(w.spec) and all(
                e is None for e in s[len(w.spec):]), (shape, f)


def test_graph_collectives_count_their_wire_bytes():
    """The halo gather and the summed scatter on a (2, 2) mesh: the values
    of an all-gather and a reduce-scatter, and the ring bytes of each
    direction (full tensor x (g - 1) / g x g positions)."""
    mesh = cpu_mesh((2, 2))
    blocks = [torch.arange(6.0).reshape(3, 2) + 10 * i for i in range(2)]
    parts = tuple(blocks[p // 2].clone().requires_grad_() for p in range(4))
    col.reset_wire()
    full = col.halo_gather(parts, mesh, ("data",))
    assert all(torch.equal(f, torch.cat(blocks)) for f in full)
    nb = 6 * 2 * 4  # the gathered [6, 2] f32
    assert col.wire_bytes()["all-gather"] == 2 * nb * (1 / 2) * 2  # two groups of g = 2
    partials = tuple(torch.ones(6, 2) * (p + 1) for p in range(4))
    partials = tuple(t.requires_grad_() for t in partials)
    got = col.summed_scatter(partials, mesh, ("data", "model"), ("data",))
    assert all(torch.equal(g, torch.full((3, 2), 10.0)) for g in got)
    assert col.wire_bytes()["reduce-scatter"] == nb * (3 / 4) * 4
    (sum(f.sum() for f in full) + sum((g * (i + 1)).sum() for i, g in enumerate(got))).backward()
    # every position's block read by its group's gather: the two copies' gradients
    assert all(torch.equal(p.grad, torch.full((3, 2), 2.0)) for p in parts)
    # the scatter's backward: the blocks' gradients gathered to every partial
    want = torch.cat([torch.full((3, 2), 1.0 + 2.0), torch.full((3, 2), 3.0 + 4.0)])
    assert all(torch.equal(p.grad, want) for p in partials)
    w = col.wire_bytes()
    assert w["reduce-scatter"] == nb * (3 / 4) * 4 + 2 * nb * (1 / 2) * 2
    assert w["all-gather"] == 2 * nb * (1 / 2) * 2 + nb * (3 / 4) * 4
    assert col.GRAPH_WIRE == {"halo": 2 * 2 * nb * (1 / 2) * 2, "scatter": 2 * nb * (3 / 4) * 4}


def test_scatter_sum_is_the_summed_scatter_of_segment_sums():
    """``scatter_sum`` of each position's edge values equals
    ``summed_scatter`` of each position's whole-graph segment sum: the
    values up to the order of the f32 adds (bf16 summed in f32 and rounded
    once: within one bf16 step), the gradients exactly."""
    mesh = cpu_mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    for dt in (torch.float32, torch.bfloat16):
        vals = [torch.randn((5, 3), generator=g).to(dt).requires_grad_() for _ in range(4)]
        dst = [torch.randint(0, 6, (5,), generator=g) for _ in range(4)]
        a = col.scatter_sum(vals, dst, 6, mesh, ("data", "model"), ("data",))
        parts = [torch.zeros((6, 3)).index_add(0, d, v.float()) for v, d in zip(vals, dst)]
        b = col.summed_scatter(parts, mesh, ("data", "model"), ("data",), dtype=dt)
        tol = dict(rtol=1e-6, atol=1e-6) if dt == torch.float32 else dict(rtol=2**-7, atol=1e-6)
        for x, y in zip(a, b):
            assert x.shape == (3, 3) and x.dtype == dt
            torch.testing.assert_close(x.float(), y.float(), **tol)
        w = torch.randn((4, 3, 3), generator=g)
        ga = torch.autograd.grad(sum((x.float() * w[i]).sum() for i, x in enumerate(a)), vals)
        gb = torch.autograd.grad(sum((y.float() * w[i]).sum() for i, y in enumerate(b)), vals)
        assert all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_gnn_inputs_on_a_mesh():
    """``gnn_inputs`` pads the batch as the JAX package pads and places it on
    the program's mesh; a batch whose counts do not divide is refused."""
    prog = programs.build("egnn", "full_graph_sm", cpu_mesh((2, 4)), smoke=True)
    params, state, b = programs.gnn_inputs(prog, "cpu", seed=1, n_nodes=101, n_edges=301)
    assert isinstance(b.node_feat, Sharded) and b.node_feat.shape == (102, 1433)
    assert b.edge_src.shape == (304,) and not b.edge_mask.unshard()[301:].any()
    assert (b.labels.unshard()[101:] == -1).all() and b.graph_y.spec == (None,)
    assert all(isinstance(t, Sharded) and t.spec == (None,) * len(t.shape)
               for _, t in leaves(params))
    new, st, m = prog.fn(params, state, b)
    assert np.isfinite(float(m["loss"])) and int(st["step"].parts[0]) == 1
    one = programs.build("egnn", "full_graph_sm", _mesh11(), smoke=True)
    raw = programs.gnn_inputs(one, "cpu", seed=1, n_nodes=101, n_edges=301)
    with pytest.raises(ValueError, match="does not split"):
        prog.fn(*raw)
    # the one-device program's inputs, made for the mesh program: the same arrays
    placed = programs.gnn_inputs(one, "cpu", seed=1, n_nodes=101, n_edges=301, mesh=prog.mesh)
    for x, y in zip(placed[2], b):
        assert x.spec == y.spec and torch.equal(x.unshard(), y.unshard())
    assert np.isclose(float(prog.fn(*placed)[2]["loss"]), float(m["loss"]), rtol=0)
