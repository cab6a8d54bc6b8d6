"""The LM family's serving programs on a mesh of several devices, and the
expert-parallel MoE, against the JAX package's:

* ``transformer.moe_ffn_shmap`` against the JAX one on (2, 4) and (1, 4)
  meshes at capacity factor 8.0 (no drops) and 1.0 (drops): every model
  shard's slot indices and ``valid`` exact, its weights within 1e-6 (f32
  ulps of the gates' softmax), the output within ``BF16_TOL``;
* the five smoke archs' ``prefill_32k``, ``decode_32k`` and ``long_500k``
  programs on a (2, 4) mesh of ``cpu`` (the device repeated) against the
  JAX programs on a (2, 4) mesh of ``Auto`` axes, the same seeded weights
  through ``params_from_arrays`` + ``shard_params``, and one-layer
  variants of the prefill programs: logits and the written cache within
  the measured bounds below (``DECODE_TOL`` ... ``DEPTH_TOL``);
* the same programs against the port's (1, 1) programs; decode's MoE
  routing the global ``moe_ffn``'s; the shards on a repeated device views
  of their base tensors; ``lm_inputs`` placing its values on the mesh.

The JAX side runs once, in a subprocess that is this file's ``__main__``
with eight host devices (``--xla_force_host_platform_device_count=8``),
and writes its inputs and outputs to an ``.npz``.

Measured (this file's inputs): decode on (2, 4) equals the JAX (2, 4)
program within 4.8e-7 on the logits (relative L2 ≤ 1.1e-7) and exactly
on the cache: both sum each model shard's bf16 partial in f32 and round
once.  XLA lays a prefill out its own way (it may gather where the port
sums partials; command-r's JAX (2, 4) prefill equals its unsharded one),
so a prefill differs by one layer's bf16 roundings, relative L2 ≤
1.21e-2 on a one-layer config's logits, grown to ≤ 5.4e-2 on the logits
and ≤ 2.44e-2 on a layer's k / v after gemma2's four layers (the JAX
package moves those logits 5.6% between its own (1, 1) and (2, 4)
layouts).  Layer 0's k / v agree within 1.5e-8.  Against the port's
(1, 1): decode logits ≤ 1.6e-2, caches ≤ 4e-3, prefill as above.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
SHAPES = ("prefill_32k", "decode_32k", "long_500k")
MESH = (2, 4)
LENGTHS = (63, 40)  # decode: the new token's position in each of the two sequences
MOE_CASES = [((2, 4), 8.0), ((2, 4), 1.0), ((1, 4), 8.0), ((1, 4), 1.0)]
MOE_BSD = (4, 32, 32)  # 64 tokens a data slice of (2, 4): capacity 16 binds at 1.0


def moe_cfg(tf, cf):
    """``tests/sharded_driver.py::case_moe_shmap``'s config at capacity
    factor ``cf``."""
    return tf.TransformerCfg(name="m", n_layers=1, d_model=32, n_heads=4, n_kv_heads=4,
                             d_head=8, d_ff=32, vocab=64,
                             moe=tf.MoECfg(n_experts=8, top_k=2, d_ff_expert=32,
                                           capacity_factor=cf))


def moe_inputs():
    rng = np.random.default_rng(7)
    B, S, D = MOE_BSD
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    lp = {"router": rng.standard_normal((D, 8)).astype(np.float32) / np.sqrt(D),
          "we1": rng.standard_normal((8, D, 32)).astype(np.float32) / np.sqrt(D),
          "we3": rng.standard_normal((8, D, 32)).astype(np.float32) / np.sqrt(D),
          "we2": rng.standard_normal((8, 32, D)).astype(np.float32) / np.sqrt(32)}
    return x, lp


@contextlib.contextmanager
def one_layer_smoke(cb, arch, on: bool):
    """While active (and ``on``), the registry ``cb``'s ``arch`` has a
    one-layer smoke config: a layer's rounding alone, not its growth."""
    spec = cb.ARCHS[arch]
    if on:
        cb.ARCHS[arch] = dataclasses.replace(
            spec, smoke_cfg=dataclasses.replace(spec.smoke_cfg, n_layers=1))
    try:
        yield
    finally:
        cb.ARCHS[arch] = spec


def jax_main(out_path):
    """The JAX side: the MoE cases and every program on a (2, 4) mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.compat import shard_map
    from repro.configs import base as jcb
    from repro.launch import programs as jprograms
    from repro.models import transformer as jtf

    out = {}
    auto = jax.sharding.AxisType.Auto
    x, lp = moe_inputs()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    for ms, cf in MOE_CASES:
        cfg = moe_cfg(jtf, cf)
        mesh = jax.make_mesh(ms, ("data", "model"), axis_types=(auto, auto))
        with mesh:
            y = jtf.moe_ffn_shmap(cfg, jlp, xb, mesh=mesh, dp_axes=("data",))
        key = f"moe/{ms[0]}x{ms[1]}/{cf}"
        out[f"{key}/y"] = np.asarray(y.astype(jnp.float32))

        def routing(xl, router, cfg=cfg, mp=ms[1]):  # moe_ffn_shmap's inner, up to dispatch
            T = xl.shape[0] * xl.shape[1]
            x2 = xl.reshape(T, -1)
            gates = jax.nn.softmax((x2 @ router.astype(x2.dtype)).astype(jnp.float32), axis=-1)
            E_loc = cfg.moe.n_experts // mp
            e0 = jax.lax.axis_index("model") * E_loc
            r = jtf._moe_dispatch_indices(gates, cfg.moe.n_experts, cfg.moe.top_k,
                                          jtf.moe_capacity(cfg, T), e0=e0, e_count=E_loc)
            return tuple(a[None, None] for a in r)

        fn = shard_map(routing, mesh=mesh, in_specs=(P("data", None, None), P()),
                       out_specs=P("data", "model"))
        with mesh:
            for name, a in zip(("idx", "wslot", "valid"), jax.jit(fn)(xb, jlp["router"])):
                out[f"{key}/{name}"] = np.asarray(a)

    mesh = jax.make_mesh(MESH, ("data", "model"), axis_types=(auto, auto))
    cells = [(arch, shape, False) for arch in LM_ARCHS for shape in SHAPES]
    cells += [(arch, "prefill_32k", True) for arch in LM_ARCHS]
    for arch, shape, one_layer in cells:
        with one_layer_smoke(jcb, arch, one_layer):
            prog = jprograms.build(arch, shape, mesh, smoke=True)
        rng = np.random.default_rng(100 + LM_ARCHS.index(arch))
        key = f"{arch}/{shape}" + ("@1" if one_layer else "")

        def leaf(s):
            if s.dtype == jnp.int32:
                return jnp.asarray(rng.integers(0, 128, s.shape)).astype(s.dtype)
            if len(s.shape) <= 1:  # the norms: small, not zero
                return jnp.asarray(0.1 * rng.standard_normal(s.shape)).astype(s.dtype)
            scale = 1.0 if len(s.shape) == 5 else 1 / np.sqrt(s.shape[-2])
            return jnp.asarray(rng.standard_normal(s.shape) * scale).astype(s.dtype)

        args = list(jax.tree.map(leaf, prog.in_specs))
        if shape != "prefill_32k":
            args[3] = jnp.asarray(LENGTHS, jnp.int32)
        for path, a in jax.tree_util.tree_leaves_with_path(args[0]):
            out[f"{key}/params/" + "/".join(k.key for k in path)] = np.asarray(
                a.astype(jnp.float32))
        for i, a in enumerate(args[1:], 1):
            for name, v in (a.items() if isinstance(a, dict) else [("", a)]):
                out[f"{key}/in{i}{name}"] = np.asarray(
                    v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
        with mesh:
            logits, cache = jax.jit(prog.fn, in_shardings=prog.in_shardings)(*args)
        out[f"{key}/logits"] = np.asarray(logits)
        for k in ("k", "v"):
            out[f"{key}/cache_{k}"] = np.asarray(cache[k].astype(jnp.float32))
    np.savez(out_path, **out)


if __name__ == "__main__":
    jax_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

import torch  # noqa: E402

from repro_torch.configs import ARCHS, base as cb  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import mesh as meshlib, programs  # noqa: E402
from repro_torch.models import transformer as tfm, transformer_mesh as tmesh  # noqa: E402
from repro_torch.tree import build as tree_build, tree_map  # noqa: E402

# measured bounds (see the module docstring), relative L2 unless said
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)  # decode logits, elementwise: the same partial sums
LAYER0_TOL = 1e-6  # layer 0's k / v: the embedding and first projections
CACHE_TOL = 1e-3  # every layer of a decode cache (measured 0)
ONE_LAYER_TOL = 2e-2  # one-layer prefill logits: one layer's partial-sum roundings
DEPTH_TOL = dict(logits=0.1, cache=0.05)  # full smoke depth: that rounding grown a layer
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one MoE layer: two bf16 steps


@pytest.fixture(scope="module")
def jax_mesh(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_lm_mesh") / "out.npz"
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


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def case_inputs(z, key, arch, shape):
    """The JAX side's inputs of cell ``key`` as the port's tensors on the
    CPU (unplaced): parameters in the arch's dtype, the bf16 cache."""
    tree = tree_build((tuple(k[len(key) + 8:].split("/")), v) for k, v in z.items()
                      if k.startswith(key + "/params/"))
    params = tfm.params_from_arrays(ARCHS[arch].smoke_cfg, tree, device="cpu")
    if ARCHS[arch].param_dtype == "bfloat16":
        params = tree_map(lambda t: t.bfloat16(), params)
    if shape == "prefill_32k":
        return params, torch.from_numpy(z[key + "/in1"])
    cache = {k: torch.from_numpy(z[f"{key}/in1{k}"]).bfloat16() for k in ("k", "v")}
    return params, cache, torch.from_numpy(z[key + "/in2"]), torch.from_numpy(z[key + "/in3"])


def run(arch, shape, mshape, args):
    """The port's program on a mesh of ``cpu``; -> ((logits, k, v) as
    numpy, the cache it returned)."""
    mesh = cpu_mesh(mshape)
    prog = programs.build(arch, shape, mesh, smoke=True)
    args = list(args)
    if len(mesh.devices) > 1:
        args[0] = programs.shard_params(args[0], mesh, prog.rules)
    if len(args) > 2:  # decode writes its cache in place: a fresh copy a run
        args[1] = {k: v.clone() for k, v in args[1].items()}
    logits, cache = prog.fn(*args)
    kv = [cache[k].unshard() if isinstance(cache[k], shd.Sharded) else cache[k]
          for k in ("k", "v")]
    return (logits.numpy(), *(c.float().numpy() for c in kv)), cache


def check(got, want, shape, one_layer, what, same_sums: bool):
    """``got`` (logits, k, v) against ``want`` by the bounds above;
    ``same_sums``: a decode against one that sums the same partials."""
    logits, k, v = got
    wl, wk, wv = want
    tight = same_sums and shape != "prefill_32k"
    for i in range(k.shape[0]):
        err = max(rel_l2(k[i], wk[i]), rel_l2(v[i], wv[i]))
        tol = LAYER0_TOL if i == 0 else (CACHE_TOL if tight else DEPTH_TOL["cache"])
        assert err <= tol, (what, i, err, tol)
    if tight:
        np.testing.assert_allclose(logits, wl, **DECODE_TOL, err_msg=what)
    else:
        tol = ONE_LAYER_TOL if one_layer else DEPTH_TOL["logits"]
        assert rel_l2(logits, wl) <= tol, (what, rel_l2(logits, wl), tol)


CELLS = [(a, s, False) for a in LM_ARCHS for s in SHAPES] + [
    (a, "prefill_32k", True) for a in LM_ARCHS]


@pytest.mark.parametrize("arch,shape,one_layer", CELLS,
                         ids=lambda c: c if isinstance(c, str) else ("1layer" if c else "full"))
def test_mesh_program_like_jax(jax_mesh, arch, shape, one_layer):
    """The (2, 4) program against the JAX (2, 4) program, and against the
    port's (1, 1) program; an MoE prefill on (1, 4) in place of (2, 4)
    there, since its capacity is a data slice's."""
    key = f"{arch}/{shape}" + ("@1" if one_layer else "")
    with one_layer_smoke(cb, arch, one_layer):
        args = case_inputs(jax_mesh, key, arch, shape)
        got, cache = run(arch, shape, MESH, args)
        assert isinstance(cache["k"], shd.Sharded) and cache["k"].mesh.sizes == MESH
        check(got, [jax_mesh[f"{key}/{n}"] for n in ("logits", "cache_k", "cache_v")], shape,
              one_layer, "against JAX", True)
        single, _ = run(arch, shape, (1, 1), args)
        if ARCHS[arch].smoke_cfg.moe and shape == "prefill_32k":
            got, _ = run(arch, shape, (1, 4), args)
        check(got, single, shape, one_layer, "against (1, 1)", False)
    if shape != "prefill_32k":  # one new k / v a sequence, at its position
        changed = np.nonzero((got[1] != args[1]["k"].float().numpy()).any(axis=(0, 3, 4)))
        assert set(zip(*changed)) <= {(0, LENGTHS[0]), (1, LENGTHS[1])}


@pytest.mark.parametrize("mshape,cf", MOE_CASES, ids=lambda c: str(c))
def test_moe_ffn_shmap_like_jax(jax_mesh, mshape, cf):
    """Each model shard's slot indices and ``valid`` exactly the JAX
    shard's, drops included, its weights within f32 ulps; the output within
    two bf16 steps."""
    cfg = moe_cfg(tfm, cf)
    x, lp = moe_inputs()
    mesh = cpu_mesh(mshape)
    routes = []
    orig = tfm._moe_route

    def recorded(*a):
        out = orig(*a)
        routes.append(out[:3])
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfm, "_moe_route", recorded)
        y = tfm.moe_ffn_shmap(cfg, {k: torch.from_numpy(v) for k, v in lp.items()},
                              torch.from_numpy(x).bfloat16(), mesh=mesh, dp_axes=("data",))
    key = f"moe/{mshape[0]}x{mshape[1]}/{cf}"
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == MOE_BSD
    np.testing.assert_allclose(y.float().numpy(), jax_mesh[f"{key}/y"], **BF16_TOL)
    assert len(routes) == len(mesh.devices)  # one route a position, in position order
    for pos, got in enumerate(routes):
        i, j = divmod(pos, mshape[1])
        for name, a in zip(("idx", "wslot", "valid"), got):
            want = jax_mesh[f"{key}/{name}"][i, j]
            assert a.numpy().dtype == want.dtype, name
            if name == "wslot":  # the gates' f32 softmax: ulps apart (measured 6e-8)
                np.testing.assert_allclose(a.numpy(), want, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(a.numpy(), want, err_msg=f"{name} at {(i, j)}")
    pairs = MOE_BSD[0] * MOE_BSD[1] * 2  # tokens x top_k
    kept = sum(int(r[2].sum()) for r in routes)
    assert kept == pairs if cf == 8.0 else kept < pairs  # capacity 1.0 drops pairs


def _same_storage(s: shd.Sharded, base: torch.Tensor) -> bool:
    return all(p.untyped_storage().data_ptr() == base.untyped_storage().data_ptr()
               for p in s.parts)


def test_shards_on_a_repeated_device_are_views():
    """``shard_params`` and ``lm_inputs`` on a (2, 4) mesh of ``cpu``: every
    part a view of its base tensor, none a copy; ``lm_inputs``' values
    those of the (1, 1) program's, laid out by ``in_shardings``."""
    mesh = cpu_mesh(MESH)
    for arch in LM_ARCHS:
        prog = programs.build(arch, "decode_32k", mesh, smoke=True)
        single = programs.build(arch, "decode_32k", cpu_mesh((1, 1)), smoke=True)
        base = programs.lm_inputs(single, "cpu", seed=3, seq_len=16)
        placed = programs.shard_params(base[0], mesh, prog.rules)
        for (path, s), (_, t) in zip(tfm._leaves(placed), tfm._leaves(base[0])):
            assert _same_storage(s, t), path
        params, cache, toks, lengths = programs.lm_inputs(prog, "cpu", seed=3, seq_len=16)
        for (path, s), (_, t) in zip(tfm._leaves(params), tfm._leaves(base[0])):
            assert torch.equal(s.unshard(), t), path
            assert len({s.parts[0].untyped_storage().data_ptr()} | {
                p.untyped_storage().data_ptr() for p in s.parts}) == 1, path
        psh, csh, bsh, _ = prog.in_shardings
        assert params["layers"]["wq"].spec == psh["layers"]["wq"] == (None, None, "model", None)
        assert cache["k"].spec == csh["k"] == (None, "data", "model", None, None)
        assert toks.spec == lengths.spec == bsh == ("data",)
        assert torch.equal(cache["k"].unshard(), base[1]["k"])
        assert torch.equal(toks.unshard(), base[2]) and torch.equal(lengths.unshard(), base[3])
        # a decode step writes the shards in place: the base cache holds the new k / v
        logits, out = prog.fn(params, cache, toks, lengths)
        assert out["k"] is cache["k"] and logits.shape == (2, prog.cfg.vocab)
        assert torch.isfinite(logits).all()


def test_prefill_cache_blocks_and_long_context_layout():
    """The prefill's cache: one block a (device, block), kv heads over the
    model axis where they divide; ``forward`` on the mesh; ``long_500k``'s
    cache split over every axis, the batch whole."""
    mesh = cpu_mesh(MESH)
    prog = programs.build("gemma2-27b", "prefill_32k", mesh, smoke=True)
    params, toks = programs.lm_inputs(prog, "cpu", seed=4)
    logits, cache = prog.fn(params, toks)
    k = cache["k"]
    assert k.spec == (None, "data", None, "model", None) and k.shape == (4, 2, 64, 4, 8)
    assert len({id(p) for p in k.parts}) == 8 and logits.shape == (2, 128)
    # forward: the final hidden states, the batch split as the tokens' and S over the model
    # axis (the sequence-parallel residual stream), against the single device's
    h = tmesh.forward(prog.cfg, params, toks, mesh=mesh)
    want = tfm.forward(prog.cfg, tree_map(lambda t: t.unshard(), params), toks.unshard())
    assert h.spec == ("data", "model", None) and h.dtype == torch.bfloat16
    assert rel_l2(h.unshard().float().numpy(), want.float().numpy()) <= DEPTH_TOL["cache"]
    long = programs.build("tinyllama-1.1b", "long_500k", mesh, smoke=True)
    _, c, t, ln = programs.lm_inputs(long, "cpu", seed=4)
    assert c["k"].spec == (None, None, ("data", "model"), None, None) and t.spec == (None,)
    assert c["k"].parts[0].shape == (2, 2, 8, 2, 8)


def test_decode_moe_routes_globally():
    """A decode step's MoE on (2, 4): every model shard routes the whole
    batch (both data slices' tokens) at the global capacity, and its slots
    are the global ``moe_ffn`` routing's slots of its experts."""
    mesh = cpu_mesh(MESH)
    prog = programs.build("olmoe-1b-7b", "decode_32k", mesh, smoke=True)
    cfg = prog.cfg
    args = programs.lm_inputs(prog, "cpu", seed=6, seq_len=8)
    calls = []
    orig = tfm._moe_route

    def recorded(gates, E, K, C, e0=0, e_count=None):
        out = orig(gates, E, K, C, e0, e_count)
        calls.append((gates, C, e0, e_count, out[:3]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfm, "_moe_route", recorded)
        prog.fn(*args)
    m = cfg.moe
    E_loc = m.n_experts // MESH[1]
    assert len(calls) == cfg.n_layers * MESH[1]  # one a model shard and layer, not a position
    for gates, C, e0, e_count, local in calls:
        assert gates.shape[0] == 2 and C == tfm.moe_capacity(cfg, 2) and e_count == E_loc
        glob = orig(gates, m.n_experts, m.top_k, C)[:3]
        sl = slice(e0 * C, (e0 + E_loc) * C)
        for a, b in zip(local, glob):
            assert torch.equal(a, b[sl])


def test_mesh_program_refusals():
    mesh = cpu_mesh(MESH)
    train = programs.build("tinyllama-1.1b", "train_4k", mesh, smoke=True)  # built on a mesh now
    assert train.in_shardings[2] == {"tokens": ("data", None), "labels": ("data", None)}
    with pytest.raises(ValueError, match="does not split over 4 data"):
        programs.build("tinyllama-1.1b", "train_4k", cpu_mesh((4, 2)), smoke=True)
    with pytest.raises(ValueError, match="do not split over 3"):
        programs.build("olmoe-1b-7b", "prefill_32k", cpu_mesh((1, 3)), smoke=True)
    with pytest.raises(ValueError, match="does not split over 4 data"):
        programs.build("tinyllama-1.1b", "prefill_32k", cpu_mesh((4, 2)), smoke=True)
    odd = meshlib.make_mesh((2, 2), ("x", "model"), ["cpu"] * 4)
    with pytest.raises(ValueError, match="'pod' / 'data'"):
        programs.build("tinyllama-1.1b", "decode_32k", odd, smoke=True)
    prog = programs.build("tinyllama-1.1b", "prefill_32k", mesh, smoke=True)
    params, toks = programs.lm_inputs(prog, "cpu")
    with pytest.raises(ValueError, match="split as"):  # a Sharded in another layout
        prog.fn(params, shd.shard(toks.unshard(), mesh, (None, None)))
    bad = dict(params, embed=shd.shard(params["embed"].unshard(), mesh, (None, "model")))
    with pytest.raises(ValueError, match="split as"):
        prog.fn(bad, toks)
    # the full configs build without allocating (meta specs)
    full = programs.build("kimi-k2-1t-a32b", "long_500k", mesh)
    assert full.in_specs[1]["k"].device.type == "meta"
    assert full.in_shardings[1]["k"] == (None, None, ("data", "model"), None, None)
