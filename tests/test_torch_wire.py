"""The dry run's wire count of a training step on a mesh
(``dist/collectives.py``'s ``WIRE``, ``launch/dryrun.py``'s
``coll_detail``) against analytic counts, kind by kind, in bytes a device
(the ring factors: all-reduce ``2(g-1)/g``, all-gather and reduce-scatter
``(g-1)/g`` of the full tensor, over a group of ``g`` positions):

* a hand-built function of two products (a replicated input scaled by a
  replicated weight, a product split over ``model`` by columns, one split
  by rows and summed) through the trainer's ``value_and_grad`` on (2, 1),
  (1, 4) and (2, 4) ``meta`` meshes, with the input whole (a forward and a
  backward all-reduce a product pair) and split over S (an all-gather and
  a reduce-scatter each way), plus the parameters' gradient all-reduce
  over the positions holding each block and the loss's sum over the data
  slices;
* the smoke ``tinyllama-1.1b:train_4k`` on (2, 1): the parameters'
  gradient all-reduce, 419,072 B, and the loss's two scalars; on (1, 4)
  and (2, 4) under ``seq_sp`` and with the residual whole: each kind the
  formula of the config and the mesh;
* each count's own case: the sum of a replicated value's gradient
  (``replicated``), a split's assembled gradient (``split``), the backward
  of a gather or a reduce-scatter whose groups share one call (counted a
  group), the GNN halo's sum over the model axis, ``grad_norm``'s scalars;
* the counting changes no value: a whole step's loss, gradients and
  parameters equal with the counting hooks removed.
"""

import math

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.launch import dryrun, mesh as meshlib, programs
from repro_torch.models.gnn import common as gnn_common
from repro_torch.train import trainer
from repro_torch.tree import leaves

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
WHOLE = {"seq_sp": None}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ar(g):
    return 2 * (g - 1) / g


def ag(g):
    return (g - 1) / g


def per_device(wire, mesh) -> dict:
    return {k: wire[k] / len(mesh.devices) for k in KINDS}


def _meta(*shape):
    return torch.empty(shape, device="meta")


# ---------------------------------------------------------------------------
# a hand-built function of two products
# ---------------------------------------------------------------------------

B, S, D, F = 4, 16, 8, 32  # the global batch, the sequence, the width, the inner width


def two_products(params, batch, *, mesh, seq_split: bool):
    """``sum(((x · s) @ w1 |> relu) @ w2) ** 2)`` a data slice, summed over
    them: ``x`` [B, S, D] split over ``data`` (and over S by ``model`` with
    ``seq_split``), ``s`` [D] replicated, ``w1`` [D, F] split by columns
    and ``w2`` [F, D] by rows over ``model``."""
    pp = col.per_position
    model = ("model",)
    h = pp(lambda x, s: x * s, mesh, batch.parts, params["s"].parts)
    if seq_split:
        h = col.all_gather(h, mesh, model, 1)
    else:
        h = col.replicated(h, mesh, model)
    y = pp(lambda h, w1, w2: torch.relu(h @ w1) @ w2, mesh, h, params["w1"].parts,
           params["w2"].parts)
    y = col.reduce_scatter(y, mesh, model, 1) if seq_split else col.psum(y, mesh, model)
    part = pp(lambda y: (y * y).sum(), mesh, y)
    if seq_split:  # each position holds its S block's share of the slice's loss
        part = col.psum(part, mesh, model)
    total = col.sum_in_order([part[row[0]].to(mesh.lead) for row in mesh.grid()])
    col.count_over("all-reduce", 4, mesh, meshlib.dp_axes(mesh))
    return total


def two_products_want(ms, seq_split: bool) -> dict:
    """The function's bytes a device, by kind."""
    d, m = ms
    P = d * m
    act = (B // d) * S * D * 4  # one data slice's [B_p, S, D] f32
    want = dict.fromkeys(KINDS, 0.0)
    if seq_split:  # forward: a gather before the products and a reduce-scatter after them
        want["all-gather"] += 2 * ag(m) * act  # and the reduce-scatter's backward
        want["reduce-scatter"] += 2 * ag(m) * act  # and the gather's backward
        want["all-reduce"] += ar(m) * 4  # the loss's share of each S block
    else:  # the sum after w2, then the replicated input's gradient summed over model
        want["all-reduce"] += 2 * ar(m) * act
    # each block's gradient over the positions that hold it, Σ block bytes · 2(g-1)/g · g
    blocks = [(D * 4, P)] + [(D * F // m * 4, d)] * m * 2  # s; the m blocks of w1 and of w2
    want["all-reduce"] += sum(b * ar(g) * g for b, g in blocks) / P
    want["all-reduce"] += ar(d) * 4  # the loss summed over the data slices
    return want


@pytest.mark.parametrize("seq_split", [False, True], ids=["whole", "s_split"])
@pytest.mark.parametrize("ms", [(2, 1), (1, 4), (2, 4)], ids=lambda ms: f"{ms[0]}x{ms[1]}")
def test_two_products_through_the_trainer(ms, seq_split):
    mesh = dryrun.meta_mesh(ms)
    params = {"s": shd.shard(_meta(D), mesh, (None,)),
              "w1": shd.shard(_meta(D, F), mesh, (None, "model")),
              "w2": shd.shard(_meta(F, D), mesh, ("model", None))}
    params = {k: shd.map_distinct(torch.clone, v) for k, v in params.items()}
    batch = shd.shard(_meta(B, S, D), mesh, ("data", "model" if seq_split else None, None))
    col.reset_wire()
    trainer.value_and_grad(lambda p, b: two_products(p, b, mesh=mesh, seq_split=seq_split),
                           params, batch)
    got = per_device(col.wire_bytes(), mesh)
    assert got == pytest.approx(two_products_want(ms, seq_split), rel=1e-12), got


# ---------------------------------------------------------------------------
# the smoke tinyllama-1.1b train_4k
# ---------------------------------------------------------------------------

ARCH = "tinyllama-1.1b"
LOSS_SCALARS = 4 + 8  # the f32 loss sum and the int64 label count, summed over the data slices


@pytest.fixture(scope="module")
def lm_cell(tmp_path_factory):
    """The dry-run record of the smoke cell on a mesh under rules (each
    cell run once, then read back from its file)."""
    out = str(tmp_path_factory.mktemp("wire"))

    def get(ms, rules):
        rec = dryrun.run_cell(ARCH, "train_4k", ms, out, smoke=True, verbose=False, rules=rules)
        assert rec["ok"], rec.get("traceback")
        return rec

    return get


def lm_want(ms, rules) -> dict:
    """The smoke ``train_4k``'s bytes a device, by kind, from the config
    (dense, a sequential residual, remat), its smoke batch and the mesh:

    * the embedding's masked take summed over the vocab blocks (its rows in
      the table's dtype); under ``seq_sp`` its backward assembles the rows'
      gradient from the S blocks (an all-gather of the bf16 rows);
    * a layer: the two sums after wo and w2 (a reduce-scatter each under
      ``seq_sp``, an all-reduce whole), run again when the layer is
      recomputed; under ``seq_sp`` the two S gathers before the products
      (and again), with the backward's reduce-scatter a gather and
      all-gather a reduce-scatter; whole, the backward's all-reduce of the
      normed input of the attention and of the FFN;
    * the final norm's rows read by the vocab blocks: gathered over S and
      reduce-scattered back, or their gradient all-reduced whole;
    * the loss: the max, the sum of exponentials and the label logit over
      the vocab blocks ([B_p, S] f32 each), its two scalars over the data
      slices;
    * the optimizer step: each parameter block's gradient over the positions
      that hold it, and ``grad_norm``'s f32 scalar a split leaf.
    """
    cfg = ARCHS[ARCH].smoke_cfg
    d, m = ms
    P = d * m
    prog = programs.build(ARCH, "train_4k", dryrun.meta_mesh(ms), smoke=True, rules=rules)
    params = dryrun.program_args(prog, prog.mesh)[0]
    Bg, Sg = prog.in_specs[2]["tokens"].shape
    Bp, L = Bg // d, cfg.n_layers
    assert not (cfg.moe or cfg.parallel_residual or cfg.tie_embeddings) and cfg.remat
    assert all(n % m == 0 for n in (cfg.n_heads, cfg.d_ff, cfg.vocab))
    seq = rules is None and Sg % m == 0
    pbytes = params["embed"].dtype.itemsize
    act = Bp * Sg * cfg.d_model * 2  # a data slice's residual [B_p, S, D] in bf16
    want = dict.fromkeys(KINDS, 0.0)
    want["all-reduce"] += ar(m) * Bp * Sg * cfg.d_model * pbytes  # the embedding's sum
    passes = 2 * 2 + 2  # two sums a layer, forward and recomputed; their backward
    if seq:
        want["all-gather"] += ag(m) * act * (1 + L * passes + 1)  # rows, layers, final norm
        want["reduce-scatter"] += ag(m) * act * (L * passes + 1)
    else:
        want["all-reduce"] += ar(m) * act * (L * passes + 1)
    want["all-reduce"] += 3 * ar(m) * Bp * Sg * 4 + ar(d) * LOSS_SCALARS
    split = 0
    for _, p in leaves(params):
        blocks = math.prod(p.mesh.size(shd.axes_of(e)) for e in p.spec)
        g = P // blocks  # the positions holding a block
        nbytes = math.prod(p.shape) * p.dtype.itemsize
        want["all-reduce"] += blocks * (nbytes / blocks) * ar(g) * g / P
        split += blocks > 1
    want["all-reduce"] += split * 4 * ar(m)
    return want


def test_tinyllama_data_parallel_step_all_reduces_its_gradients(lm_cell):
    """(2, 1): every leaf replicated, held by both data positions: an
    all-reduce of each gradient, 1x its bytes a device (419,072 B, the
    smoke parameters in f32), and the loss's scalars; nothing else."""
    rec = lm_cell((2, 1), None)
    assert rec["coll_detail"] == {"all-reduce": 419_072 + LOSS_SCALARS, "all-gather": 0.0,
                                  "reduce-scatter": 0.0}
    assert lm_want((2, 1), None) == rec["coll_detail"]


@pytest.mark.parametrize("rules", [None, WHOLE], ids=["seq_sp", "whole"])
@pytest.mark.parametrize("ms", [(1, 4), (2, 4)], ids=lambda ms: f"{ms[0]}x{ms[1]}")
def test_tinyllama_on_a_model_axis_like_the_formula(lm_cell, ms, rules):
    rec = lm_cell(ms, rules)
    assert rec["coll_detail"] == pytest.approx(lm_want(ms, rules), rel=1e-12)


def test_tinyllama_layouts_move_the_same_bytes_but_the_embedding_gather(lm_cell):
    """The two layouts' totals differ by the ``seq_sp`` embedding's
    backward all-gather alone (an all-reduce moves what a reduce-scatter
    and an all-gather move)."""
    ms = (2, 4)
    sp, whole = (sum(lm_cell(ms, r)["coll_detail"].values()) for r in (None, WHOLE))
    cfg = ARCHS[ARCH].smoke_cfg
    act = (2 // ms[0]) * 64 * cfg.d_model * 2
    assert sp - whole == pytest.approx(ag(ms[1]) * act, rel=1e-12)


# ---------------------------------------------------------------------------
# each count's own case
# ---------------------------------------------------------------------------


def _shared_over_data(mesh, shape):
    """One tensor a model block, shared by every data position (the groups
    over ``model`` share their entries)."""
    blocks = [torch.empty(shape, device="meta", requires_grad=True)
              for _ in range(mesh.shape["model"])]
    return tuple(blocks[shd.coords(mesh, p)["model"]] for p in range(len(mesh.devices)))


def _backward(parts):
    outs = list({id(t): t for t in parts}.values())
    torch.autograd.backward([o.sum() for o in outs])


def test_replicated_counts_an_all_reduce_a_group_when_its_gradient_arrives():
    mesh = dryrun.meta_mesh((2, 4))
    x = tuple(t.clone() for t in _shared_over_data(mesh, (3, 5)))  # one tensor a position
    col.reset_wire()
    y = col.replicated(x, mesh, ("model",))
    assert all(a is b for a, b in zip(x, y))
    assert col.wire_bytes()["all-reduce"] == 0  # nothing forward
    _backward(col.per_position(lambda t: t * 2, mesh, y))
    # two groups over model (one a data index), each its lead's gradient [3, 5] f32 over 4
    assert col.wire_bytes() == {"all-reduce": 2 * 60 * ar(4) * 4, "all-gather": 0.0,
                                "reduce-scatter": 0.0}
    col.reset_wire()
    with torch.no_grad():  # no gradient: no hook, no count
        col.replicated(tuple(t.detach() for t in x), mesh, ("model",))
    assert col.replicated(x, mesh, ("data", "model")) == x
    assert col.replicated(x, mesh, ()) == x and sum(col.wire_bytes().values()) == 0


def test_split_counts_the_gradients_all_gather():
    mesh = dryrun.meta_mesh((2, 4))
    whole = tuple(t.clone() for t in _shared_over_data(mesh, (2, 8, 3)))
    col.reset_wire()
    blocks = col.split(whole, mesh, ("model",), 1)
    assert [b.shape for b in blocks] == [(2, 2, 3)] * 8
    assert len({b.untyped_storage()._cdata for b in blocks}) == 8  # a storage of its own
    _backward(blocks)
    assert col.wire_bytes()["all-gather"] == 2 * 48 * 4 * ag(4) * 4  # two groups, [2, 8, 3]


def test_shared_groups_count_their_backward_once_a_group():
    """Groups over ``model`` whose entries are the same tensors share one
    gather and one reduce-scatter; each group counts its backward."""
    mesh = dryrun.meta_mesh((2, 4))
    x = _shared_over_data(mesh, (2, 3))
    col.reset_wire()
    _backward(col.all_gather(x, mesh, ("model",), 0))
    full = 8 * 3 * 4  # the gathered [8, 3] f32
    assert col.wire_bytes() == {"all-reduce": 0.0, "all-gather": 2 * full * ag(4) * 4,
                                "reduce-scatter": 2 * full * ag(4) * 4}
    x = _shared_over_data(mesh, (8, 3))
    col.reset_wire()
    _backward(col.reduce_scatter(x, mesh, ("model",), 0))
    assert col.wire_bytes() == {"all-reduce": 0.0, "all-gather": 2 * full * ag(4) * 4,
                                "reduce-scatter": 2 * full * ag(4) * 4}


def test_gnn_halo_sums_a_node_blocks_gradient_over_model():
    """A (2, 4) mesh: each data slice's node block [6, 4] f32 (one tensor, its
    four model positions'), gathered over ``data`` for every model group
    (forward an all-gather, backward a reduce-scatter of the whole [12, 4],
    a group each), read by each position's share of the edges, so the
    block's gradient is also summed over ``model``: an all-reduce of the
    block a data slice."""
    mesh = dryrun.meta_mesh((2, 4))
    n, e = 12, 16
    spec = (("data",), None)

    def sharded(*shape, dtype=torch.float32):
        return shd.shard(torch.zeros(shape, dtype=dtype, device="meta"), mesh, spec[:len(shape)])

    g = gnn_common.GraphBatch(
        node_feat=sharded(n, 4), positions=sharded(n, 3), species=sharded(n, dtype=torch.int32),
        edge_src=sharded(e, dtype=torch.int32), edge_dst=sharded(e, dtype=torch.int32),
        edge_feat=sharded(e, 1), node_mask=sharded(n, dtype=torch.bool),
        edge_mask=sharded(e, dtype=torch.bool), labels=sharded(n, dtype=torch.int32),
        graph_ids=sharded(n, dtype=torch.int32),
        graph_y=shd.shard(torch.zeros(2, device="meta"), mesh, (None,)))
    G = gnn_common.OnMesh(g)
    blocks = {}
    h = tuple(blocks.setdefault(shd.coords(mesh, p)["data"],
                                torch.empty(6, 4, device="meta", requires_grad=True))
              for p in range(len(mesh.devices)))
    col.reset_wire()
    out = G.map(lambda hf, src: hf.index_select(0, src.long()).sum(), G.halo(h), G.edge("edge_src"))
    _backward(out)
    full, block = n * 4 * 4, 6 * 4 * 4
    assert col.wire_bytes() == {"all-reduce": 2 * block * ar(4) * 4,
                                "all-gather": 4 * full * ag(2) * 2,
                                "reduce-scatter": 4 * full * ag(2) * 2}


def test_grad_norm_counts_a_scalar_a_split_leaf():
    mesh = dryrun.meta_mesh((2, 4))
    grads = {"split": shd.shard(_meta(8, 4), mesh, ("model", None)),
             "both": shd.shard(_meta(8, 4), mesh, ("model", "data")),
             "replicated": shd.shard(_meta(4), mesh, (None,))}
    col.reset_wire()
    for _, g in leaves(grads):
        trainer._squares(g, mesh.lead)
    # over model in two groups; over both axes in one group of eight
    assert col.wire_bytes()["all-reduce"] == 2 * 4 * ar(4) * 4 + 4 * ar(8) * 8


# ---------------------------------------------------------------------------
# no value changes
# ---------------------------------------------------------------------------


def test_counting_changes_no_value(monkeypatch):
    """A (2, 4) ``cpu`` mesh step of the smoke tinyllama under ``seq_sp``
    and whole: loss, ``grad_norm`` and every new parameter bit for bit
    equal with the counting helpers made plain pass-throughs."""
    mesh = meshlib.make_mesh((2, 4), ("data", "model"), ["cpu"] * 8)
    for rules in (None, WHOLE):
        got = []
        for plain in (False, True):
            with monkeypatch.context() as mp:
                if plain:
                    mp.setattr(col, "_marked", lambda *a, **k: None)
                    mp.setattr(col, "count_wire", lambda *a, **k: None)
                prog = programs.build(ARCH, "train_4k", mesh, smoke=True, rules=rules)
                params, opt_state, batch = programs.lm_inputs(prog, "cpu", seed=3)
                params, _, m = prog.fn(params, opt_state, batch)
                got.append((m, [t.unshard() for _, t in leaves(params)]))
        (m0, p0), (m1, p1) = got
        assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"],
                                                                   m1["grad_norm"])
        assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_concurrent_counts_lose_no_bytes():
    """The backward's hooks count from each device's autograd thread: many
    threads adding at once, switching often, lose no update."""
    import sys
    import threading

    n_threads, n_adds = 16, 2_000
    col.reset_wire()
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [col.count_wire("all-gather", 3.0, 2)
                                                    for _ in range(n_adds)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert col.wire_bytes()["all-gather"] == n_threads * n_adds * 3.0
