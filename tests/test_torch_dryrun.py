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
* a record's keys against the JAX record's (less the XLA-only ones).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((1, 1), (2, 4))


def jax_main(out_path, ms):
    """The JAX flop count of every smoke cell on an ``Auto`` mesh of shape
    ``ms``."""
    import jax

    from repro.launch import flopcount as jfc, programs as jprograms

    auto = (jax.sharding.AxisType.Auto,) * 2
    out = {}
    mesh = jax.make_mesh(ms, ("data", "model"), axis_types=auto)
    for arch, shape in jprograms.all_cells():
        prog = jprograms.build(arch, shape, mesh, smoke=True)
        with mesh:
            out[f"{arch}:{shape}:{ms[0]}x{ms[1]}"] = jfc.count(prog.fn, *prog.in_specs).flops
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
from repro_torch.launch import dryrun, flopcount, programs, roofline  # noqa: E402


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

    def get():
        counts = {}
        for ms, proc in procs.items():
            out, err = proc.communicate(timeout=400)
            assert proc.returncode == 0, f"JAX side failed:\n{out[-3000:]}\n{err[-3000:]}"
            with open(tmp / f"{ms[0]}x{ms[1]}.json") as f:
                counts.update(json.load(f))
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
