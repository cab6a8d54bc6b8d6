"""The flop count, the roofline and the dry run of ``repro_torch``
(``launch/flopcount.py``, ``roofline.py``, ``dryrun.py``) against the JAX
package's ``repro.launch`` modules of the same names:

* the counter against analytic counts and against the JAX
  ``flopcount.count`` of ``jnp`` twins (a matmul, a bmm, an einsum, an MLP
  forward and backward, an elementwise chain, a checkpointed block): the
  flops exactly equal, and the bytes too where both walk the same ops;
* ``run_cell`` ok for every smoke cell of ``programs.all_cells()`` on
  (1, 1) and (2, 4) ``meta`` meshes, each program's flops within 0.5x-2x
  of the JAX program's count on the same mesh (run once, in a subprocess
  a mesh that is this file's ``__main__`` with eight host devices; the
  engine's Pallas kernels are opaque there as the port's are here);
* the roofline terms of a hand-built count;
* a record's keys against the JAX record's (less the XLA-only ones);
* the wire count of a data-parallel training step on (2, 1) against the
  JAX program's compiled HLO (``roofline.hlo_traffic``, compiled in the
  (2, 4) subprocess on two of its devices): xDeepFM's all-reduce bytes
  equal; tinyllama's differ by its stacked layers' gradients, which
  ``hlo_traffic`` does not reach (their all-reduce sits in the backward
  loop's body, whose header ``parse_hlo`` does not read);
* the memory keys per device, as the JAX record's: a hand-built mesh
  function's bytes a position against the analytic ones; on (1, 1) every
  smoke cell's per-device peak equal to the whole mesh's, on (2, 4) at
  most it; and the LM programs' sequence-parallel residual stream
  (``seq_sp``) below the whole residual's per-device peak, a training
  forward's by the analytic bytes of the rematerialised layers' saved
  residual blocks.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 1), (2, 4))
# the train cells whose compiled HLO's collectives the (2, 4) subprocess reads on a (2, 1) mesh
DATA_PARALLEL = ((2, 1), (("xdeepfm", "train_batch"), ("tinyllama-1.1b", "train_4k")))


def jax_main(out_path, ms):
    """The JAX flop count of every smoke cell on an ``Auto`` mesh of shape
    ``ms``; on (2, 4) also the wire bytes by kind of :data:`DATA_PARALLEL`'s
    cells, compiled on its mesh of the first devices."""
    import jax

    from repro.launch import flopcount as jfc, programs as jprograms, roofline as jroof

    auto = (jax.sharding.AxisType.Auto,) * 2
    out = {"flops": {}, "traffic": {}}
    mesh = jax.make_mesh(ms, ("data", "model"), axis_types=auto)
    for arch, shape in jprograms.all_cells():
        prog = jprograms.build(arch, shape, mesh, smoke=True)
        with mesh:
            out["flops"][f"{arch}:{shape}:{ms[0]}x{ms[1]}"] = jfc.count(prog.fn,
                                                                        *prog.in_specs).flops
    dp, cells = DATA_PARALLEL
    if ms == (2, 4):
        mesh = jax.make_mesh(dp, ("data", "model"), axis_types=auto,
                             devices=jax.devices()[:dp[0] * dp[1]])
        for arch, shape in cells:
            prog = jprograms.build(arch, shape, mesh, smoke=True)
            with mesh:
                hlo = jax.jit(prog.fn, in_shardings=prog.in_shardings).lower(
                    *prog.in_specs).compile().as_text()
            out["traffic"][f"{arch}:{shape}:{dp[0]}x{dp[1]}"] = jroof.hlo_traffic(hlo)
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    jax_main(sys.argv[1], tuple(int(x) for x in sys.argv[2].split("x")))
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.launch import flopcount as jfc, roofline as jroofline  # noqa: E402
from repro_torch.configs import base as cb  # noqa: E402
from repro_torch.dist import collectives as col, sharding as shd  # noqa: E402
from repro_torch.launch import dryrun, flopcount, programs, roofline  # noqa: E402
from repro_torch.models import transformer_mesh as tmesh  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_dryrun")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    procs = {ms: subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                   str(tmp / f"{ms[0]}x{ms[1]}.json"), f"{ms[0]}x{ms[1]}"],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
             for ms in MESHES}  # one process a mesh, both started now

    def get(what="flops"):
        """``"flops"``: every cell's flop count; ``"traffic"``: the
        data-parallel cells' wire bytes by kind."""
        counts = {}
        for ms, proc in procs.items():
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, f"JAX side failed:\n{out[-3000:]}\n{err[-3000:]}"
            with open(tmp / f"{ms[0]}x{ms[1]}.json") as f:
                counts.update(json.load(f)[what])
        return counts

    return get


def _jax(f, *shapes):
    return jfc.count(f, *(jnp.ones(s, jnp.float32) for s in shapes))


def _port(f, *shapes, grad=False):
    return flopcount.count(f, *(torch.ones(s, device="meta", requires_grad=grad)
                                for s in shapes))


def _mlp_jax(x, w1, w2):
    h = x @ w1
    y = (h * h) @ w2
    return jnp.sum(y * y)


def _mlp_port(x, w1, w2):
    h = x @ w1
    y = (h * h) @ w2
    (y * y).sum().backward()


def _block_jax(x, w1, w2):
    y = jax.checkpoint(lambda x: ((x @ w1) * (x @ w1)) @ w2)(x)
    return jnp.sum(y * y)


def _block_port(x, w1, w2):
    y = checkpoint(lambda x: ((x @ w1) * (x @ w1)) @ w2, x, use_reentrant=False)
    (y * y).sum().backward()


MLP = ((8, 16), (16, 32), (32, 4))
TWINS = {
    # name: (jax fn, port fn, shapes, grad, analytic flops, bytes compared)
    "matmul": (lambda a, b: a @ b, lambda a, b: a @ b, ((8, 16), (16, 5)), False,
               2 * 8 * 16 * 5, True),
    "bmm": (lambda a, b: jnp.matmul(a, b), torch.bmm, ((4, 8, 16), (4, 16, 5)), False,
            2 * 4 * 8 * 16 * 5, True),
    "einsum": (lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
               lambda a, b: torch.einsum("bij,bjk->bik", a, b), ((4, 8, 16), (4, 16, 5)), False,
               2 * 4 * 8 * 16 * 5, True),
    # forward: 2 products, h*h, y*y, the sum; backward: y*y's two muls and their add,
    # two products, h*h's two muls and their add, two products: each product 3 times,
    # each elementwise op of the forward 4 times, the sum once
    "mlp": (jax.value_and_grad(_mlp_jax, argnums=(0, 1, 2)), _mlp_port, MLP, True,
            3 * (2 * 8 * 16 * 32 + 2 * 8 * 32 * 4) + 4 * 8 * 32 + 4 * 8 * 4 + 1, True),
    "elementwise": (lambda x: jnp.exp(x) * 2.0 + jnp.sin(x) - x / 3.0,
                    lambda x: torch.exp(x) * 2.0 + torch.sin(x) - x / 3.0, ((64, 32),), False,
                    6 * 64 * 32, False),
    # the block's forward once, then again in the backward
    "checkpointed": (jax.value_and_grad(_block_jax, argnums=(0, 1, 2)), _block_port, MLP, True,
                     None, False),
}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_counter_like_jax(name):
    jf, pf, shapes, grad, analytic, same_bytes = TWINS[name]
    want = _jax(jf, *shapes)
    got = _port(pf, *shapes, grad=grad)
    assert got.flops == want.flops, (got, want)
    if analytic is not None:
        assert got.flops == analytic
    if same_bytes:
        assert got.bytes_naive == want.bytes_naive
    assert got.flops == got.flops_bf16 + got.flops_f32 + got.flops_other


def test_counter_splits_flops_by_dtype():
    """bf16 products, f32 products and the rest go to their own totals."""
    a = torch.ones((8, 16), device="meta", dtype=torch.bfloat16)
    b = torch.ones((16, 4), device="meta", dtype=torch.bfloat16)
    with flopcount.counting() as c:
        y = a @ b
        z = y.float() @ torch.ones((4, 2), device="meta")
        torch.relu(z)
    assert (c.flops_bf16, c.flops_f32, c.flops_other) == (2 * 8 * 16 * 4, 2 * 8 * 4 * 2, 16)
    assert c.bytes_naive == (8 * 16 + 16 * 4 + 8 * 4) * 2 + (8 * 4 + 4 * 2 + 8 * 2) * 4 + 2 * 16 * 4


def test_roofline_terms_of_a_hand_built_count():
    cost = flopcount.Cost(flops=3e12, bytes_naive=6.7e11, flops_bf16=1.978e12, flops_f32=0.5e12,
                          flops_other=0.522e12)
    wire = {"all-reduce": 3.6e10, "all-gather": 0.0, "reduce-scatter": 0.0}
    r = roofline.analyze("x:y", "2x1", 2, cost, wire, model_flops=1.5e12, peak_mem_bytes=1e9)
    # a device's bf16 products, then its f32 products and the rest
    assert r.t_compute == pytest.approx(0.989e12 / 989e12 + 0.511e12 / 67e12)
    assert r.t_memory == pytest.approx(3.35e11 / 3.35e12)
    assert r.t_collective == pytest.approx(1.8e10 / 900e9)
    assert r.bottleneck == "memory"
    assert r.useful_flops_frac == pytest.approx(0.5)
    assert r.roofline_frac == pytest.approx(0.75e12 / 0.1 / 989e12)
    assert r.to_dict()["flops_bf16_per_dev"] == pytest.approx(0.989e12)
    assert roofline.bound_ms(3.35e9, 67e9) == pytest.approx((1.0, "bytes"))
    assert roofline.bound_ms(3.35e9, 134e9)[1] == "operations"


def test_record_keys_like_jax(tmp_path):
    """A port record holds the JAX record's keys (``Roofline.to_dict`` and
    ``run_cell``'s), less the XLA-only ones (cost and memory analyses, the
    CPU bf16 upcast, lowering and compile times)."""
    jr = jroofline.Roofline(name="a", mesh="m", chips=1, flops_per_dev=1.0, bytes_per_dev=1.0,
                            wire_bytes_per_dev=0.0, model_flops=1.0, coll_detail={})
    xla_only = {"cost_analysis_flops", "cost_analysis_bytes", "memory_analysis",
                "cpu_bf16_upcast_artifact_bytes", "t_lower_s", "t_compile_s"}
    # the keys the JAX run_cell adds to Roofline.to_dict (src/repro/launch/dryrun.py)
    run_cell_keys = {"arch", "shape", "mesh", "ok", "t_lower_s", "t_compile_s",
                     "memory_analysis", "arg_bytes", "temp_bytes", "out_bytes",
                     "cpu_bf16_upcast_artifact_bytes"}
    rec = dryrun.run_cell("egnn", "molecule", (1, 1), str(tmp_path), smoke=True, verbose=False)
    assert rec["ok"], rec.get("traceback")
    assert (set(jr.to_dict()) | run_cell_keys) - xla_only <= set(rec)
    again = dryrun.run_cell("egnn", "molecule", (1, 1), str(tmp_path), smoke=True, verbose=False)
    assert again == json.loads(json.dumps(rec))  # resumed from its file


def test_dry_run_of_every_smoke_cell(tmp_path, jax_counts):
    """Every smoke cell runs on (1, 1) and (2, 4) meshes of ``meta``
    devices, its flops within 0.5x-2x of the JAX count, its peak memory
    holding at least its arguments."""
    got = {}
    for ms in MESHES:
        for arch, shape in programs.all_cells():
            rec = dryrun.run_cell(arch, shape, ms, str(tmp_path), smoke=True, verbose=False)
            assert rec["ok"], (arch, shape, ms, rec.get("error"), rec.get("traceback"))
            assert rec["peak_mem_bytes"] >= rec["arg_bytes"] > 0
            assert rec["mesh"] == f"{ms[0]}x{ms[1]}" and rec["chips"] == ms[0] * ms[1]
            if ms == (1, 1):  # one device: the per-device record is the whole mesh's
                assert rec["peak_mem_bytes"] == rec["mesh_peak_mem_bytes"], (arch, shape)
            else:
                assert rec["peak_mem_bytes"] <= rec["mesh_peak_mem_bytes"], (arch, shape)
            got[f"{arch}:{shape}:{ms[0]}x{ms[1]}"] = rec["flops"]
    want = jax_counts()
    assert set(got) == set(want)
    ratios = {k: got[k] / want[k] for k in got}
    bad = {k: r for k, r in ratios.items() if not 0.5 <= r <= 2.0}
    assert not bad, bad
    assert np.isfinite(list(ratios.values())).all()


def test_dry_run_command_line(tmp_path):
    rc = dryrun.main(["--arch", "xdeepfm", "--shape", "serve_p99", "--smoke", "--mesh", "2x4",
                      "--out", str(tmp_path)])
    assert rc == 0 and (tmp_path / "xdeepfm__serve_p99__2x4__smoke.json").exists()
    assert dryrun.main(["--arch", "xdeepfm", "--shape", "no_such_shape", "--smoke", "--mesh",
                        "1x1", "--out", str(tmp_path)]) == 1


def test_per_position_bytes_of_a_hand_built_mesh_function():
    """A (2, 4) ``meta`` mesh: a value split over ``model`` (four 1 KiB
    blocks, each held by its two data positions) and a replicated one (2
    KiB, held by all eight), each distinct part a storage of its own.  The
    function doubles the split one (a call a block, serving its two
    positions), adds one to the replicated one (one call serving all) and
    makes 512 B outside any position (the lead's).  A position holds 3 KiB
    of arguments and 3 KiB of outputs, the lead 512 B more; the whole mesh
    6 KiB of arguments and 6.5 KiB of outputs."""
    mesh = dryrun.meta_mesh((2, 4))
    split = shd.map_distinct(torch.clone, shd.shard(torch.empty(4, 256, device="meta"), mesh,
                                                    ("model", None)))
    rep = shd.map_distinct(torch.clone, shd.shard(torch.empty(512, device="meta"), mesh, (None,)))

    def fn(split, rep):
        a = col.per_position(lambda t: t * 2, mesh, split.parts)
        r = col.per_position(lambda t: t + 1, mesh, rep.parts)
        return a, r, torch.ones(128, device="meta")

    got = dryrun.measure(fn, (split, rep), mesh)
    assert got["arg_at"] == [3072] * 8
    assert got["out_at"] == [3584] + [3072] * 7
    assert got["peak_at"] == [6656] + [6144] * 7
    assert (got["peak"], got["arg_bytes"], got["out_bytes"]) == (6656, 3072, 3584)
    assert got["mesh_peak"] == 4 * 1024 + 2048 + 4 * 1024 + 2048 + 512
    one = dryrun.measure(fn, (split, rep))  # no mesh: every storage on one position
    assert one["peak"] == one["mesh_peak"] == got["mesh_peak"]


@contextlib.contextmanager
def _layers(arch, n):
    """While active, ``arch``'s smoke config has ``n`` layers."""
    spec = cb.ARCHS[arch]
    cb.ARCHS[arch] = dataclasses.replace(spec, smoke_cfg=dataclasses.replace(spec.smoke_cfg,
                                                                             n_layers=n))
    try:
        yield cb.ARCHS[arch].smoke_cfg
    finally:
        cb.ARCHS[arch] = spec


WHOLE = {"seq_sp": None}


def test_seq_sp_lowers_the_per_device_peak(tmp_path):
    """tinyllama ``train_4k`` smoke on (2, 4): the per-device peak under
    ``seq_sp`` below the whole residual's (the same arguments, the whole
    mesh's peak no higher).  The training forward (the loss with the
    parameters requiring gradients: every rematerialised layer's input kept)
    at 2 and at 6 layers: the per-device peak grows a layer by one saved
    residual, [B_p, S, D] bf16 whole or a [B_p, S/4, D] block, so the
    layouts' difference grows by 4 · (1 - 1/4) · B_p · S · D · 2 bytes
    (within 25%)."""
    arch, ms = "tinyllama-1.1b", (2, 4)
    recs = {name: dryrun.run_cell(arch, "train_4k", ms, str(tmp_path), smoke=True,
                                  verbose=False, rules=rules)
            for name, rules in (("seq_sp", None), ("whole", WHOLE))}
    sp, whole = recs["seq_sp"], recs["whole"]
    assert sp["ok"] and whole["ok"] and whole["rules"] == WHOLE
    assert sp["peak_mem_bytes"] < whole["peak_mem_bytes"]
    assert sp["arg_bytes"] == whole["arg_bytes"]
    assert sp["mesh_peak_mem_bytes"] <= 1.01 * whole["mesh_peak_mem_bytes"]

    def forward_peak(n_layers, rules):
        with _layers(arch, n_layers) as cfg:
            mesh = dryrun.meta_mesh(ms)
            prog = programs.build(arch, "train_4k", mesh, smoke=True, rules=rules)
            p, _, b = dryrun.program_args(prog, mesh)
            p = tree_map(lambda s: shd.map_distinct(lambda t: t.requires_grad_(), s), p)
            got = dryrun.measure(lambda p, b: tmesh.loss_fn(cfg, p, b, mesh=mesh, rules=rules),
                                 (p, b), mesh)
        return got["peak"], cfg

    gap = {}
    for n in (2, 6):
        (a, cfg), (b, _) = forward_peak(n, None), forward_peak(n, WHOLE)
        gap[n] = b - a
    B, S = 2, 64  # the smoke programs' batch
    want = 4 * (1 - 1 / ms[1]) * (B // ms[0]) * S * cfg.d_model * 2
    assert 0.75 * want <= gap[6] - gap[2] <= 1.25 * want, (gap, want)


def test_data_parallel_step_wire_like_the_jax_hlo(tmp_path, jax_counts):
    """(2, 1): every parameter replicated over the two data positions.  The
    smoke xDeepFM step all-reduces its gradients (247,048 B, 1x a device)
    and its loss (4 B): within 16 B of the JAX HLO's all-reduce, the only
    kind either reads.  The smoke tinyllama step reads its gradients'
    419,072 B and the loss's f32 sum and int64 label count; the JAX
    ``hlo_traffic`` reads the same but for the stacked ``layers``' 353,280
    B (and an int32 count): it leaves out the backward layer loop, whose
    body's tuple parameter ``roofline._COMP_HDR_RE`` does not match."""
    ms, _ = DATA_PARALLEL
    want = jax_counts("traffic")
    got = {}
    for arch, shape in DATA_PARALLEL[1]:
        rec = dryrun.run_cell(arch, shape, ms, str(tmp_path), smoke=True, verbose=False)
        assert rec["ok"], rec.get("traceback")
        got[arch] = rec["coll_detail"], want[f"{arch}:{shape}:{ms[0]}x{ms[1]}"]
    port, jax_side = got["xdeepfm"]
    assert abs(port["all-reduce"] - jax_side["all-reduce"]) <= 16, (port, jax_side)
    assert port["all-gather"] == port["reduce-scatter"] == 0
    assert all(jax_side[k] == 0 for k in jax_side if k not in ("mem", "all-reduce"))
    port, jax_side = got["tinyllama-1.1b"]
    assert port["all-reduce"] - jax_side["all-reduce"] == 353_280 + 4, (port, jax_side)
