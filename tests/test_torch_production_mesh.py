"""The dry run on the H100 production meshes (``launch/mesh.py``
``make_production_mesh``, ``launch/dryrun.py`` and its shortcut,
``launch/lanes.py``, the collective term by link in
``launch/roofline.py``):

* the shortcut (each class of positions that differ only in their
  data-parallel coordinates run once, counted for every member) gives the
  record the full emulation gives, key for key but the times, for smoke
  cells of every family on meshes of two or more data-parallel positions a
  model coordinate, (pod, data, model) meshes among them;
* in a training step's backward the full emulation runs the lanes one
  after the other and the shortcut cannot see that order: there every key
  but the memory keys it names is equal, and each of those lies within a
  stated share of the full emulation's;
* the production meshes' shapes, axes and nodes, and no CPU fallback;
* a collective whose group lies in one node counts NVLink bytes and one
  whose group spans nodes network bytes, each its ring formula, and the
  collective term is the sum of the two links' times;
* the full ``tinyllama-1.1b`` ``decode_32k`` on (32, 8): ok, its argument
  bytes a device the parameters' and the cache's over the shard counts of
  their specs.
"""

import json
import math

import pytest
import torch

from repro_torch.core.query import meta_devices
from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.launch import dryrun, mesh as meshlib, programs, roofline

TIMES = ("t_build_s", "t_run_s")

# (arch, shape, mesh): smoke cells whose shortcut record equals the full emulation's
EXACT = [
    ("k2triples", "serve_64k", (4, 2)),
    ("k2triples", "serve_64k", (2, 2, 2)),
    ("k2triples", "unbounded_4k", (4, 2)),
    ("k2triples", "unbounded_4k", (2, 2, 2)),
    ("tinyllama-1.1b", "train_4k", (2, 2)),
    ("tinyllama-1.1b", "train_4k", (2, 1, 2)),
    ("tinyllama-1.1b", "prefill_32k", (2, 2)),
    ("tinyllama-1.1b", "long_500k", (2, 2)),
    ("gemma2-27b", "long_500k", (2, 2, 2)),
    ("tinyllama-1.1b", "decode_32k", (4, 2)),
    ("tinyllama-1.1b", "decode_32k", (2, 2, 2)),
    ("xdeepfm", "serve_bulk", (4, 2)),
    ("xdeepfm", "retrieval_cand", (2, 2, 2)),
]
# smoke training cells whose backward the shortcut counts with a lane's copies live together
# (the whole mesh's peak) or without the full emulation's order of the lanes (MACE's
# positions): the memory keys that differ, each held within its share below of the full
# emulation's; every other key equal (ROADMAP Queue 3)
WHOLE = ("mesh_peak_mem_bytes",)
POSITION = ("peak_mem_bytes", "temp_bytes")
APPROX = [
    ("egnn", "minibatch_lg", (4, 2), WHOLE),
    ("egnn", "minibatch_lg", (2, 2, 2), WHOLE),
    ("graphcast", "molecule", (2, 2, 2), WHOLE),
    ("xdeepfm", "train_batch", (4, 2), WHOLE),
    ("mace", "molecule", (2, 2), WHOLE + POSITION),
    ("command-r-plus-104b", "train_4k", (2, 1, 2), WHOLE),
]
# the largest share by which those keys may differ: a whole-mesh peak counts every lane's
# copy of a backward's storage at once (xDeepFM's dense gradients: +40 % on its smoke cell);
# a position's peak moves by a few per cent (MACE: -2.2 % to -5.3 % on its smoke cells)
GAP = {"mesh_peak_mem_bytes": 0.5, "peak_mem_bytes": 0.06, "temp_bytes": 0.08}

_warm: set = set()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ``meta`` ops: one intra-op thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _records(arch, shape, ms, tmp_path) -> tuple[dict, dict]:
    """The full emulation's and the shortcut's smoke records of a cell,
    after one run of its program in this process (tables made once a
    process count in the first run only; the shortcut's run, the
    cheaper)."""
    run = dict(smoke=True, verbose=False, force=True)
    if (arch, shape) not in _warm:
        dryrun.run_cell(arch, shape, ms, str(tmp_path / "warm"), shortcut=True, **run)
        _warm.add((arch, shape))
    short = dryrun.run_cell(arch, shape, ms, str(tmp_path / "short"), shortcut=True, **run)
    full = dryrun.run_cell(arch, shape, ms, str(tmp_path / "full"), shortcut=False, **run)
    for rec in (full, short):
        assert rec["ok"], (arch, shape, ms, rec.get("traceback"))
    return full, short


def _id(cell) -> str:
    arch, shape, ms = cell[:3]
    return f"{arch}-{shape}-{dryrun.mesh_name(ms)}"


@pytest.mark.parametrize("cell", EXACT, ids=_id)
def test_shortcut_record_equals_the_full_emulation(cell, tmp_path):
    full, short = _records(*cell, tmp_path)
    keys = set(full) | set(short)
    assert {k: short.get(k) for k in keys - set(TIMES)} == {k: full.get(k)
                                                            for k in keys - set(TIMES)}


@pytest.mark.parametrize("cell", APPROX, ids=_id)
def test_shortcut_memory_bounds_the_full_emulation(cell, tmp_path):
    *cell, apart = cell
    full, short = _records(*cell, tmp_path)
    other = (set(full) | set(short)) - set(TIMES) - set(apart)
    assert {k: short.get(k) for k in other} == {k: full.get(k) for k in other}
    for k in apart:
        assert abs(short[k] - full[k]) <= GAP[k] * full[k], (k, short[k], full[k])


def _meta_production(multi_pod: bool) -> meshlib.Mesh:
    with meta_devices():
        return meshlib.make_production_mesh(multi_pod=multi_pod, devices=["meta"] * 256)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi_pod"])
def test_production_mesh_shapes_axes_and_nodes(multi_pod):
    mesh = _meta_production(multi_pod)
    if multi_pod:
        assert mesh.axis_names == ("pod", "data", "model") and mesh.sizes == (2, 16, 8)
    else:
        assert mesh.axis_names == ("data", "model") and mesh.sizes == (32, 8)
    assert len(mesh.devices) == 256 and roofline.NODE_CARDS == 8
    assert meshlib.dp_axes(mesh) == mesh.axis_names[:-1]
    assert mesh.size(meshlib.dp_axes(mesh)) == 32  # the JAX package's 32 data slices
    # model within a node: each row of the grid is one node's eight cards
    for row in mesh.grid():
        assert [p // roofline.NODE_CARDS for p in row] == [row[0] // 8] * 8
        assert col.link(row) == "nvlink"
    for axes in [(a,) for a in meshlib.dp_axes(mesh)] + [meshlib.dp_axes(mesh)]:
        assert {col.link(g) for g in col.groups(mesh, axes)} == {"network"}
    assert dryrun.mesh_name(mesh.sizes) == ("2x16x8" if multi_pod else "32x8")


def test_production_mesh_asks_for_cards():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA cards: the default mesh would take them")
    for multi_pod in (False, True):
        with pytest.raises(ValueError, match="256 CUDA cards"):
            meshlib.make_production_mesh(multi_pod=multi_pod)


def test_mesh_parsing_and_meta_meshes():
    assert dryrun.parse_mesh("2x16x8") == (2, 16, 8) and dryrun.parse_mesh("32X8") == (32, 8)
    with pytest.raises(ValueError):
        dryrun.parse_mesh("2x2x2x2")
    m = dryrun.meta_mesh((2, 16, 8))
    assert m.axis_names == ("pod", "data", "model") and len(m.devices) == 256
    assert m.devices[0].type == "meta"
    assert dryrun.mesh_name((2, 16, 8)) == "2x16x8"


@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi_pod"])
def test_collectives_count_their_link(multi_pod):
    """psum and all_gather over ``model`` (a node) and over the
    data-parallel axes (across nodes) on a production ``meta`` mesh: the
    ring bytes of each group on its link, the collective term their sum."""
    mesh = _meta_production(multi_pod)
    part = torch.empty(3, 5, device="meta")
    parts = tuple(part for _ in mesh.devices)
    nb = part.numel() * part.element_size()
    dp = meshlib.dp_axes(mesh)
    cases = [(col.psum, ("model",), "all-reduce", 8, 32),
             (col.psum, dp, "all-reduce", 32, 8),
             (lambda p, m, a: col.all_gather(p, m, a, 0), ("model",), "all-gather", 8, 32),
             (lambda p, m, a: col.all_gather(p, m, a, 0), dp, "all-gather", 32, 8)]
    for fn, axes, kind, g, n_groups in cases:
        col.reset_wire()
        fn(parts, mesh, axes)
        # each of a group's g positions sends 2(g-1)/g of an all-reduce's nb, (g-1)/g of an
        # all-gather's g·nb
        want = n_groups * (2 * nb * (g - 1) if kind == "all-reduce" else g * nb * (g - 1))
        link = "nvlink" if axes == ("model",) else "network"
        assert col.link_bytes() == {"nvlink": 0.0, "network": 0.0, link: want}, (kind, axes)
        assert col.wire_bytes()[kind] == want
    # the collective term: each link's bytes a device at its rate, summed
    cost = type("Cost", (), dict(flops=0.0, bytes_naive=0.0, flops_bf16=0.0, flops_f32=0.0))()
    links = {"nvlink": 7.2e9, "network": 3.1e9}
    r = roofline.analyze("x:y", "32x8", 256, cost, {"all-reduce": sum(links.values())}, 0.0,
                         links=links)
    assert r.to_dict()["link_detail"] == {k: v / 256 for k, v in links.items()}
    assert r.t_collective == pytest.approx(7.2e9 / 256 / roofline.NVLINK_BW
                                           + 3.1e9 / 256 / roofline.NETWORK_BW, rel=1e-12)
    assert roofline.NETWORK_BW == 100e9 and roofline.NVLINK_BW == 900e9


def test_one_node_counts_nvlink_only():
    """On a mesh of at most one node every group is NVLink's, so the
    record's collective term is the whole count at NVLink's rate."""
    mesh = dryrun.meta_mesh((2, 4))
    part = torch.empty(4, device="meta")
    col.reset_wire()
    col.psum(tuple(part for _ in mesh.devices), mesh, ("data",))
    assert col.link_bytes()["network"] == 0.0 and col.link_bytes()["nvlink"] > 0
    cost = type("Cost", (), dict(flops=0.0, bytes_naive=0.0, flops_bf16=0.0, flops_f32=0.0))()
    r = roofline.analyze("x:y", "2x4", 8, cost, col.wire_bytes(), 0.0, links=col.link_bytes())
    assert r.t_collective == sum(col.wire_bytes().values()) / 8 / roofline.NVLINK_BW


def test_full_decode_on_the_production_mesh(tmp_path):
    """The full ``tinyllama-1.1b`` ``decode_32k`` on (32, 8), with the
    shortcut a mesh of several nodes takes by default: ok, under the card's
    80 GB, and its argument bytes a device are each placed leaf's global
    bytes over the shard count of its spec."""
    ms = (32, 8)
    rec = dryrun.run_cell("tinyllama-1.1b", "decode_32k", ms, str(tmp_path), verbose=False)
    assert rec["ok"], rec.get("traceback")
    mesh = dryrun.meta_mesh(ms)
    prog = programs.build("tinyllama-1.1b", "decode_32k", mesh)
    want = 0
    for leaf in _leaves(programs.place(prog, prog.in_specs)):
        assert isinstance(leaf, shd.Sharded)
        count = math.prod(mesh.size(shd.axes_of(e)) for e in leaf.spec)
        want += math.prod(leaf.shape) * leaf.dtype.itemsize // count
    assert rec["arg_bytes"] == want
    assert rec["arg_bytes"] < rec["peak_mem_bytes"] < 80e9
    assert rec["link_detail"]["network"] == 0.0  # decode's collectives are all over model


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def test_report_diffs_and_tabulates_records(tmp_path):
    """``launch/dryrun_report.py``: ``diff`` names the keys but the times in
    which two records differ, and a new ``link_detail`` only where it holds
    network bytes; ``table`` gives each production cell its terms, link
    bytes, fit and seconds against its 2x4 run."""
    from repro_torch.launch import dryrun_report as rep

    old = {"arch": "a", "shape": "s", "mesh": "2x4", "peak_mem_bytes": 5, "t_build_s": 1.0,
           "t_run_s": 2.0}
    new = dict(old, t_run_s=9.0, link_detail={"nvlink": 4.0, "network": 0.0})
    cell = ("a", "s", "2x4")
    assert rep.diff({cell: new}, {cell: old}) == {}
    new.update(peak_mem_bytes=6, link_detail={"nvlink": 4.0, "network": 1.0})
    assert rep.diff({cell: new}, {cell: old}) == {cell: ["peak_mem_bytes", "link_detail"]}
    assert rep.diff({("b", "s", "2x4"): new}, {cell: old}) == {("b", "s", "2x4"): ["missing"]}
    prod = dict(old, mesh="32x8", ok=True, t_compute=0.002, t_memory=1.5, t_collective=0.0,
                bottleneck="memory", peak_mem_bytes=81e9, t_run_s=5.0,
                link_detail={"nvlink": 3e9, "network": 2e9})
    (tmp_path / "p.json").write_text(json.dumps(prod))
    (tmp_path / "n").mkdir()
    (tmp_path / "n" / "n.json").write_text(json.dumps(old))
    rows = rep.table(rep.load(str(tmp_path)), rep.load(str(tmp_path / "n")), {})
    assert rows == ["| a | `s` 2 / 1.5 s / 0; 3 / 2 GB; 81 GB over (memory); 6.00 s (2.0× 2x4) |"]
