"""``repro_torch.dist`` against the JAX package's ``repro.dist``:

* ``spec_for`` against JAX's, entry for entry, for every parameter (smoke
  and full), cache and batch axis tuple of the five LM archs under each of
  their four shapes' ``rules_override``, on (1, 1), (2, 4) and (1, 8)
  ``("data", "model")`` meshes and a (2, 2, 2) ``("pod", "data",
  "model")`` mesh (JAX's reads only the mesh's axis sizes: an
  ``AbstractMesh`` needs no devices); ``DEFAULT_RULES`` equal;
* ``compress_decompress_psum`` against JAX's under ``shard_map`` on an
  (8,) mesh: the int8 ``q`` (the JAX function's own steps 1–3) and the
  residual exact, over 20 calls of error feedback (the residual is one
  fused multiply-subtract, as XLA contracts the reference's); the mean
  within ``MEAN_TOL`` (f32 sums of eight terms; measured 0 apart, the same
  order); the time-averaged mean's drift below 0.3× one call's error,
  as ``tests/sharded_driver.py::case_compress`` holds it.  The JAX side runs in
  a subprocess that is this file's ``__main__`` with eight host devices;
* ``shard`` / ``unshard`` / ``empty``, the collectives and
  ``per_position`` on meshes of the ``cpu`` device (repeated: views, one
  computation a distinct input) and of ``cpu`` and ``meta`` (distinct
  devices: each part on its own).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CALLS = 20
G_SHAPE = (8, 256)  # one 256-element gradient a position of the (8,) mesh


def grads():
    return np.random.default_rng(0).standard_normal(G_SHAPE).astype(np.float32)


def jax_main(out_path):
    """The JAX side: ``N_CALLS`` error-feedback calls on the same gradients."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.dist import compress

    mesh = jax.make_mesh((8,), ("data",))

    def step(g, e):
        mean, err = compress.compress_decompress_psum(g, e, "data")
        x = g + e  # steps 1-3 of the reference, for q
        scale = jnp.maximum(jax.lax.pmax(jnp.max(jnp.abs(x)), "data"),
                            jnp.finfo(jnp.float32).tiny) / 127.0
        q = jnp.clip(jnp.round(x / scale), -127, 127).astype(jnp.int8)
        return mean, err, q

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data"), P("data"))))
    g = jnp.asarray(grads().reshape(-1))
    err = jnp.zeros_like(g)
    out = {}
    for t in range(N_CALLS):
        mean, err, q = fn(g, err)
        out[f"mean{t}"], out[f"err{t}"], out[f"q{t}"] = (np.asarray(a).reshape(G_SHAPE)
                                                        for a in (mean, err, q))
    np.savez(out_path, **out)


if __name__ == "__main__":
    jax_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

import torch  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.dist import sharding as jshd  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.dist import collectives as col, compress, sharding as shd  # noqa: E402
from repro_torch.dist.sharding import Sharded  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.transformer_mesh import KV_AXES  # noqa: E402

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = {"1x1": ((1, 1), ("data", "model")), "2x4": ((2, 4), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
MEAN_TOL = dict(rtol=1e-6, atol=1e-6)


def cpu_mesh(sizes, axes=("data", "model")):
    return meshlib.make_mesh(sizes, axes, ["cpu"] * int(np.prod(sizes)))


def test_default_rules_like_jax():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert list(shd.DEFAULT_RULES) == list(jshd.DEFAULT_RULES)


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("shape_id", SHAPES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_spec_for_like_jax(arch, shape_id, mesh_id):
    sizes, axes = MESHES[mesh_id]
    mesh, jmesh = cpu_mesh(sizes, axes), AbstractMesh(sizes, axes)
    shape = ARCHS[arch].shape(shape_id)
    rules = dict(shape.rules_override)
    assert rules == dict(JARCHS[arch].shape(shape_id).rules_override)
    cases = []
    for cfg in (ARCHS[arch].smoke_cfg, ARCHS[arch].cfg):
        for (path, names), (_, t) in zip(tfm._leaves(tfm.logical_axes(cfg)),
                                         tfm._leaves(tfm.param_specs(cfg))):
            cases.append((names, tuple(t.shape)))
        B, S = shape.dims["global_batch"], shape.dims["seq_len"]
        cases += [(KV_AXES, (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)),
                  (("batch",), (B,)), (("batch", None), (B, S)), (("batch", None), (3, S)),
                  (("batch", "seq_sp", None), (B, S, cfg.d_model)),
                  (("batch", None, "vocab"), (B, S, cfg.vocab))]
    assert tfm.logical_axes(ARCHS[arch].cfg) == jtf.logical_axes(JARCHS[arch].cfg)
    for names, dims in cases:
        for sh, rl in ((dims, rules), (None, rules), (dims, None)):
            got = shd.spec_for(mesh, names, sh, rl)
            want = tuple(jshd.spec_for(jmesh, names, sh, rl))
            assert got == want, (names, sh, rl, got, want)


def test_spec_for_rules():
    mesh = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    # first dimension wins an axis; absent axes are dropped; no divide -> replicated
    assert shd.spec_for(mesh, ("heads", "kv_heads"), (8, 8)) == ("model", None)
    assert shd.spec_for(mesh, ("batch",), (8,), {"batch": ("pod", "x", "data")}) == (
        ("pod", "data"),)
    assert shd.spec_for(mesh, ("batch", "ffn"), (6, 4)) == (None, "model")
    assert shd.spec_for(mesh, ("kv_seq",), (16,), {"kv_seq": ("pod", "data", "model")}) == (
        ("pod", "data", "model"),)
    assert shd.spec_for(mesh, (None, "unknown"), (4, 4)) == (None, None)


@pytest.fixture(scope="module")
def jax_compress(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_compress") / "out.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(ROOT, "src"), env.get("PYTHONPATH", "")])
    r = subprocess.run([sys.executable, os.path.abspath(__file__), str(path)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, f"JAX side failed:\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}"
    with np.load(path) as z:
        return dict(z)


def test_compress_decompress_psum_like_jax(jax_compress):
    mesh = cpu_mesh((8,), ("data",))
    g = grads()
    gs = tuple(torch.from_numpy(g[i]) for i in range(8))
    errs = tuple(torch.zeros(G_SHAPE[1]) for _ in range(8))
    exact = g.mean(axis=0)
    acc = np.zeros(G_SHAPE[1])
    qs = []
    orig = compress.quantize

    def recorded(x, amax):
        q, scale = orig(x, amax)
        qs.append(q)
        return q, scale

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compress, "quantize", recorded)
        for t in range(N_CALLS):
            qs.clear()
            mean, errs = compress.compress_decompress_psum(gs, errs, mesh, "data")
            for i in range(8):
                assert mean[i].dtype == errs[i].dtype == torch.float32
                assert qs[i].dtype == torch.int8
                np.testing.assert_array_equal(qs[i].numpy(), jax_compress[f"q{t}"][i])
                np.testing.assert_array_equal(errs[i].numpy(), jax_compress[f"err{t}"][i])
                np.testing.assert_allclose(mean[i].numpy(), jax_compress[f"mean{t}"][i],
                                           **MEAN_TOL)
            assert all(m is mean[0] for m in mean)  # one sum on the repeated device
            if t == 0:
                e1 = np.abs(mean[0].numpy() - exact).max()
            acc += mean[0].numpy()
    e2 = np.abs(acc / N_CALLS - exact).max()
    assert e1 < 0.05 and e2 < 0.3 * e1, (e1, e2)


def test_compress_over_one_axis_of_a_grid():
    """On a (2, 4) mesh over "data": each model column's two positions
    averaged (int8 on their shared scale), the columns apart."""
    mesh = cpu_mesh((2, 4))
    g = np.random.default_rng(1).standard_normal((8, 16)).astype(np.float32)
    gs = tuple(torch.from_numpy(g[p]) for p in range(8))
    mean, err = compress.compress_decompress_psum(gs, tuple(torch.zeros(16) for _ in gs),
                                                  mesh, "data")
    for p in range(8):
        j = p % 4
        pair = g[[j, 4 + j]]
        scale = np.abs(pair).max() / np.float32(127.0)
        q = np.clip(np.round(pair / scale), -127, 127)
        np.testing.assert_allclose(mean[p].numpy(), (q * scale).mean(0), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(err[p].numpy(), g[p] - q[p // 4] * scale, atol=1e-6)


def test_shard_views_and_round_trip():
    mesh = cpu_mesh((2, 2, 2), ("pod", "data", "model"))
    t = torch.arange(8 * 6 * 4, dtype=torch.float32).reshape(8, 6, 4)
    for spec in [(None, None, None), ("model", None, None), (("pod", "data"), None, "model"),
                 ("data", ("model",), None), (("pod", "data", "model"), None, None)]:
        s = shd.shard(t, mesh, spec)
        assert isinstance(s, Sharded) and s.shape == tuple(t.shape) and s.spec == spec
        assert all(p.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
                   for p in s.parts)  # views, no copy
        assert torch.equal(shd.unshard(s), t) and torch.equal(s.unshard(), t)
        for pos, p in enumerate(s.parts):
            c = shd.coords(mesh, pos)
            want = t
            for d, e in enumerate(spec):
                axes = shd.axes_of(e)
                n = t.shape[d] // mesh.size(axes)
                b = shd.block_index(mesh, pos, axes)
                want = want.narrow(d, b * n, n)
            assert torch.equal(p, want), (spec, pos, c)
    with pytest.raises(ValueError, match="does not split"):
        shd.shard(t, mesh, (None, ("pod", "data"), None))
    with pytest.raises(ValueError, match="spec of 2"):
        shd.shard(t, mesh, (None, None))
    e = shd.empty((4, 6), torch.bfloat16, mesh, ("data", None))
    assert e.shape == (4, 6) and len({id(p) for p in e.parts}) == 2  # one a (device, block)


def test_shard_over_distinct_devices():
    """A mesh of ``cpu`` and ``meta``: each part on its position's device,
    one copy a (device, block); the cpu parts views."""
    mesh = meshlib.Mesh(("data", "model"), (2, 2), (torch.device("cpu"), torch.device("meta"),
                                                    torch.device("cpu"), torch.device("meta")))
    t = torch.randn(4, 6)
    s = shd.shard(t, mesh, ("model", None))
    assert [p.device for p in s.parts] == list(mesh.devices)
    assert s.parts[0] is s.parts[2] and s.parts[1] is s.parts[3]  # replicated over data
    assert s.parts[0].untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
    assert torch.equal(s.parts[2], t[:2])
    r = shd.shard(t, mesh, (None, None))
    assert r.parts[0] is t and r.parts[1].device.type == "meta"


def test_collectives():
    mesh = cpu_mesh((2, 4))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((8, 5)).astype(np.float32)
    parts = tuple(torch.from_numpy(x[p]) for p in range(8))
    grid = x.reshape(2, 4, 5)
    s = col.psum(parts, mesh, ("model",))
    m = col.pmax(parts, mesh, ("data",))
    g = col.all_gather(parts, mesh, ("data", "model"), 0)
    for p in range(8):
        i, j = divmod(p, 4)
        np.testing.assert_allclose(s[p].numpy(), grid[i].sum(0), rtol=1e-6)
        np.testing.assert_array_equal(m[p].numpy(), grid[:, j].max(0))
        np.testing.assert_array_equal(g[p].numpy(), x.reshape(-1))
    assert s[0] is s[3] and s[0] is not s[4] and g[0] is g[7]  # one result a group, shared
    assert col.psum(parts, mesh, ()) == parts
    assert [list(grp) for grp in col.groups(mesh, ("data",))] == [[j, 4 + j] for j in range(4)]
    # bf16 partials summed in f32 and rounded once
    b = tuple(torch.from_numpy(x[p]).bfloat16() for p in range(8))
    got = col.psum(b, mesh, ("model",))[0]
    want = sum(v.float() for v in b[:4]).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # per_position: one call a (device, inputs)
    calls = []
    out = col.per_position(lambda a, k: calls.append(k) or a * k, mesh, s, [2] * 8)
    assert len(calls) == 2 and out[0] is out[1] and out[4] is not out[0]
