"""The LM's ``train_4k`` programs on a mesh of several devices, and the
training modules under them, against the JAX package:

* smoke steps on a mesh of ``cpu`` (the device repeated) against the JAX
  programs on ``Auto``-axis meshes, the same numpy parameters
  (``params_from_arrays`` + ``lm_place``) and batch: the loss,
  ``grad_norm``, every optimizer-state leaf and the new parameters.
  Dense archs on (2, 4) against the JAX (2, 4) program; an MoE on (1, 4)
  against the JAX (1, 1) program (one data slice: the same routing), since
  the JAX (2, 4) program's router gradient is wrong
  (``test_jax_moe_shmap_router_gradient``).  One-layer variants are held
  within the one-device bounds of ``tests/test_torch_lm_grad.py``
  (``ONE_TOL``); at full smoke depth a layer's bf16 roundings grow through
  the next, so the bounds there are ``DEPTH_TOL`` (measured) or the drift
  the JAX package itself shows between its (1, 1) and (2, 4) programs on
  the same inputs in the same run, whichever is larger;
* the port's (2, 4) step against its (1, 1) step (MoE on (1, 4): its
  capacity is a data slice's) within ``DEPTH_TOL``, and with a distinct
  tensor a position against the shared parts within ``ONE_TOL``;
* the whole mesh loss's gradient with f32 activations (no bf16 rounding
  to grow) against the one-device gradient, leaf for leaf within 1e-2;
* the gradient combine rules alone, in f32: a replicated and a split
  leaf read at every position, through a ``psum`` and a detached
  ``pmax``, the gradient against the one-device autograd within 1e-6,
  with the parts shared on the repeated device and with one distinct
  tensor a position (what distinct devices give: no memoisation);
  ``grad_norm`` counts each block once;
* Adafactor on leaves split over the model axis (each dimension) against
  the JAX ``adafactor`` on the whole arrays, the same gradients, three
  steps: parameters, ``vr``, ``vc``, ``v`` within 1e-6;
* the optimizer state ``init`` lays out on a mesh equal to the JAX
  builder's ``spec_for`` of ``state_logical_axes``; a checkpoint written
  by the (2, 4) program restored onto the (1, 1) program and onto a mesh,
  and read by the JAX ``checkpoint.restore``.

The JAX programs run once, in a subprocess that is this file's
``__main__`` with eight host devices, and write to an ``.npz``.
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
MESH = (2, 4)
# The JAX side compiles one program a cell and mesh (~3-4 s each).  Dense archs: the (2, 4)
# program and, for tinyllama at full depth, the (1, 1) one (their drift; command-r's JAX
# (2, 4) program equals its (1, 1) one within 1e-5).  MoE archs: the JAX (2, 4)
# program's router gradient is wrong (``test_jax_moe_shmap_router_gradient``), so the port's
# expert-parallel step on (1, 4) (one data slice: the same routing) is held against the JAX
# (1, 1) program.
CELLS = {  # (arch, one layer): the JAX meshes
    ("tinyllama-1.1b", False): ((2, 4), (1, 1)),  # AdamW, f32
    ("command-r-plus-104b", False): ((2, 4),),  # Adafactor, f32
    ("olmoe-1b-7b", False): ((1, 1),),  # the expert-parallel MoE, AdamW
    ("tinyllama-1.1b", True): ((2, 4),),
    ("kimi-k2-1t-a32b", True): ((1, 1),),  # MoE, Adafactor on bf16 parameters
}
MOE_GRAD = (2, 64, 32)  # B, S, D of the MoE router-gradient case
B, S = 2, 64  # the smoke programs' batch


def np_params(specs, seed: int):
    """The reference's init rule, drawn by numpy: zeros for rank <= 1,
    else ``normal / sqrt(shape[-2])``; the leaves of ``specs`` (anything
    with ``shape``) in sorted-key order."""
    rng = np.random.default_rng(seed)

    def leaf(shape):
        if len(shape) <= 1:
            return np.zeros(shape, np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return leaf(tuple(t.shape))

    return walk(specs)


def np_batch(vocab: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[0, :5] = -1  # masked labels: the count is global
    return {"tokens": tokens, "labels": labels.astype(np.int32)}


@contextlib.contextmanager
def one_layer_smoke(cb, arch, on: bool):
    """While active (and ``on``), ``arch``'s smoke config has one layer."""
    spec = cb.ARCHS[arch]
    if on:
        cb.ARCHS[arch] = dataclasses.replace(
            spec, smoke_cfg=dataclasses.replace(spec.smoke_cfg, n_layers=1))
    try:
        yield
    finally:
        cb.ARCHS[arch] = spec


def _flat(tree, prefix=""):
    """{"a/b/c": leaf} in sorted-key order."""
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree[k]
    return out


def cell_key(arch, one_layer):
    return arch + ("@1" if one_layer else "")


def moe_grad_inputs():
    """A one-layer MoE config (no drops at capacity factor 8), its expert
    weights, tokens and the loss's weights."""
    rng = np.random.default_rng(11)
    B_, S_, D = MOE_GRAD
    lp = {"router": rng.standard_normal((D, 8)) / np.sqrt(D),
          "we1": rng.standard_normal((8, D, 32)) / np.sqrt(D),
          "we3": rng.standard_normal((8, D, 32)) / np.sqrt(D),
          "we2": rng.standard_normal((8, 32, D)) / np.sqrt(32)}
    x = rng.standard_normal((B_, S_, D))
    w = rng.standard_normal((B_, S_, D))
    return ({k: v.astype(np.float32) for k, v in lp.items()}, x.astype(np.float32),
            w.astype(np.float32))


def moe_grad_cfg(tf):
    return tf.TransformerCfg(name="m", n_layers=1, d_model=MOE_GRAD[2], n_heads=4, n_kv_heads=4,
                             d_head=8, d_ff=32, vocab=64,
                             moe=tf.MoECfg(n_experts=8, top_k=2, d_ff_expert=32,
                                           capacity_factor=8.0))


def jax_main(out_path):
    """One step of each cell's smoke ``train_4k`` program on its meshes,
    from the same parameters, zero state and batch; the MoE router
    gradient of ``moe_ffn`` and of ``moe_ffn_shmap`` on (1, 4)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base as jcb
    from repro.launch import programs as jprograms
    from repro.models import transformer as jtf

    out = {}
    auto = jax.sharding.AxisType.Auto
    meshes = {m: jax.make_mesh(m, ("data", "model"), axis_types=(auto, auto))
              for m in (MESH, (1, 1), (1, 4))}
    lp, x, w = moe_grad_inputs()
    cfg = moe_grad_cfg(jtf)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def single(lp):
        y = jtf.moe_ffn(cfg, lp, xb.reshape(-1, x.shape[-1])).reshape(x.shape)
        return jnp.sum(y.astype(jnp.float32) * w)

    def sharded(lp):
        y = jtf.moe_ffn_shmap(cfg, lp, xb, mesh=meshes[(1, 4)], dp_axes=("data",))
        return jnp.sum(y.astype(jnp.float32) * w)

    jlp = {k: jnp.asarray(v) for k, v in lp.items()}
    out["moe/single"] = np.asarray(jax.jit(jax.grad(single))(jlp)["router"])
    with meshes[(1, 4)]:
        out["moe/shmap"] = np.asarray(jax.jit(jax.grad(sharded))(jlp)["router"])
    for i, ((arch, one_layer), mshapes) in enumerate(CELLS.items()):
        key = cell_key(arch, one_layer)
        for mshape in mshapes:
            mesh = meshes[mshape]
            with one_layer_smoke(jcb, arch, one_layer):
                prog = jprograms.build(arch, "train_4k", mesh, smoke=True)
            pspecs, ospecs, _ = prog.in_specs
            params = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                                  np_params(pspecs, 100 + i), pspecs)
            state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), ospecs)
            vocab = jcb.ARCHS[arch].smoke_cfg.vocab
            batch = {k: jnp.asarray(v) for k, v in np_batch(vocab, 200 + i).items()}
            with mesh:
                new, new_state, m = jax.jit(prog.fn, in_shardings=prog.in_shardings)(
                    params, state, batch)
            tag = f"{key}/{mshape[0]}x{mshape[1]}"
            out[f"{tag}/loss"] = np.asarray(m["loss"])
            out[f"{tag}/grad_norm"] = np.asarray(m["grad_norm"])
            for name, tree in (("params", new), ("state", new_state)):
                wide = jax.tree.map(lambda a: np.asarray(
                    a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)
                for path, a in _flat(wide).items():
                    out[f"{tag}/{name}/{path}"] = a
    np.savez(out_path, **out)


if __name__ == "__main__":
    jax_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# the port's side
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.train import checkpoint as jckpt, optim as joptim  # noqa: E402
from repro_torch.configs import ARCHS, base as cb  # noqa: E402
from repro_torch.dist import collectives as col, sharding as shd  # noqa: E402
from repro_torch.dist.sharding import Sharded  # noqa: E402
from repro_torch.launch import mesh as meshlib, programs  # noqa: E402
from repro_torch.models import layers as L, transformer as tfm  # noqa: E402
from repro_torch.models import transformer_mesh as tmesh  # noqa: E402
from repro_torch.train import checkpoint as ckpt, optim, trainer  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

# One train step, the port against a reference (relative unless said).  One layer: the
# one-device bounds of tests/test_torch_lm_grad.py (loss 1e-4, grad_norm 5e-3, each optimizer
# state leaf's relative L2 6e-2; new parameters: AdamW each element within 2.02·lr and at most
# 3% of a leaf's elements off, f32 Adafactor the update's relative L2 5e-2, bf16 parameters
# within one bf16 step of the leaf's largest value and at most 10% of elements differing).
ONE_TOL = dict(loss=1e-4, grad_norm=5e-3, state=6e-2, share=3e-2, update=5e-2, bf16=1e-1)
# Full smoke depth on a mesh: each model shard's bf16 partial is rounded before the sum, and
# the second layer carries the first one's roundings (with random weights a 1e-6 relative
# nudge of the parameters moves the one-device gradients by 1.5-4% a leaf).  Measured, the
# port's mesh step against its (1, 1) step on 4 seeds an arch: loss <= 7.3e-4, grad_norm <=
# 9.1e-2, state <= 0.35 (gemma2 0.57), AdamW share <= 0.11, Adafactor update <= 0.36, bf16
# share <= 0.35; against the JAX programs within the same.  The same step with a distinct
# tensor a position against the shared parts stays within ``ONE_TOL`` (loss equal; grad_norm
# <= 2.6e-3, state <= 4.3e-2, shares <= 5.9e-2, update <= 4.1e-2): only sums' orders differ.
DEPTH_TOL = dict(loss=2e-3, grad_norm=0.15, state=0.5, share=0.15, update=0.6, bf16=0.6)
DEPTH_TOL_OF = {"gemma2-27b": dict(DEPTH_TOL, state=0.9)}
F32_TOL = 1e-2  # f32 activations: the mesh's gradient a leaf against one device's (<= 3.4e-3)
OPT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many small mesh ops: beside
    the other test workers a thread pool a process only spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_train_mesh") / "out.npz"
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


def f32(x) -> np.ndarray:
    if isinstance(x, Sharded):
        x = x.unshard()
    return x.detach().float().numpy().copy()


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else float(np.linalg.norm(got))


def step_inputs(arch, one_layer, i):
    """The cell's numpy parameters as the port's tensors (the arch's
    dtype) and its batch, on the CPU."""
    with one_layer_smoke(cb, arch, one_layer):
        cfg = ARCHS[arch].smoke_cfg
    params = tfm.params_from_arrays(cfg, np_params(tfm.param_specs(cfg), 100 + i), device="cpu")
    if ARCHS[arch].param_dtype == "bfloat16":
        params = tree_map(lambda t: t.bfloat16(), params)
    return params, {k: torch.from_numpy(v) for k, v in np_batch(cfg.vocab, 200 + i).items()}


def _apart(s: Sharded) -> Sharded:
    """``s`` with a distinct copy of its block at every position."""
    return Sharded(tuple(t.clone() for t in s.parts), s.mesh, s.spec)


def port_step(arch, one_layer, mshape, params, batch, unshared=False) -> dict:
    """One step of the port's smoke ``train_4k`` program on a ``cpu`` mesh
    of ``mshape`` from copies of ``params``; with ``unshared`` every
    position holds a distinct tensor (what distinct devices give)."""
    with one_layer_smoke(cb, arch, one_layer):
        prog = programs.build(arch, "train_4k", cpu_mesh(mshape), smoke=True)
    p = tree_map(torch.clone, params)
    p0 = {"/".join(k): f32(v) for k, v in leaves(p)}
    args = programs.lm_place(prog, (p, prog.opt.init(p), batch))
    if unshared:
        args = (*(tree_map(_apart, a) for a in args[:2]), args[2])
    new, state, m = prog.fn(*args)
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), p0=p0, state_tree=state,
                params={"/".join(k): f32(v) for k, v in leaves(new)},
                state={"/".join(k): f32(v) for k, v in leaves(state)})


def jax_step(z, arch, one_layer, mshape) -> dict:
    tag = f"{cell_key(arch, one_layer)}/{mshape[0]}x{mshape[1]}"
    return dict(loss=float(z[f"{tag}/loss"]), grad_norm=float(z[f"{tag}/grad_norm"]),
                params={k[len(tag) + 8:]: v for k, v in z.items()
                        if k.startswith(tag + "/params/")},
                state={k[len(tag) + 7:]: v for k, v in z.items() if k.startswith(tag + "/state/")})


def step_errors(arch, got, want, p0) -> dict:
    """``got``'s step against ``want``'s (both from parameters ``p0``): the
    relative loss and grad_norm, the largest relative L2 of a state leaf,
    the new parameters by the optimizer's rule (AdamW: share of elements
    off, each at most ``lr_steps`` of 2.02·lr; f32 Adafactor: the update's
    relative L2; bf16: share of elements off, the largest in bf16 steps of
    the leaf's largest value)."""
    spec = ARCHS[arch]
    lr = 1e-3 if spec.optimizer == "adafactor" else 3e-4
    e = dict(loss=abs(got["loss"] / want["loss"] - 1),
             grad_norm=abs(got["grad_norm"] / want["grad_norm"] - 1), state=0.0, params=0.0,
             steps=0.0)
    assert set(got["state"]) == set(want["state"]) and set(got["params"]) == set(want["params"])
    for k, b in want["state"].items():
        if k.endswith("step"):
            assert int(got["state"][k]) == int(b) == 1
        else:
            e["state"] = max(e["state"], rel_l2(got["state"][k], b))
    for k, b in want["params"].items():
        a, a0 = got["params"][k], p0[k]
        off = np.abs(a - b)
        if spec.optimizer == "adamw":
            e["params"] = max(e["params"], float(np.mean(off > 1e-6 + 1e-6 * np.abs(b))))
            e["steps"] = max(e["steps"], float(off.max() / (2.02 * lr)))
        elif spec.param_dtype == "float32":
            e["params"] = max(e["params"], rel_l2(a - a0, b - a0))
        else:
            e["params"] = max(e["params"], float(np.mean(off > 0)))
            e["steps"] = max(e["steps"], float(off.max() / (2.0 ** -7 * max(np.abs(b).max(),
                                                                           1e-30))))
    return e


def check_errors(arch, e, tol, what):
    """``e`` within ``tol``; AdamW's elements within 2.02·lr always, bf16
    parameters' within one bf16 step where ``tol`` is ``ONE_TOL`` (at
    depth an Adafactor update of a near-zero leaf may change sign)."""
    spec = ARCHS[arch]
    key = ("share" if spec.optimizer == "adamw" else
           "update" if spec.param_dtype == "float32" else "bf16")
    for name in ("loss", "grad_norm", "state"):
        assert e[name] <= tol[name], (what, name, e[name], tol[name])
    assert e["params"] <= tol[key], (what, key, e["params"], tol[key])
    if spec.optimizer == "adamw" or tol is ONE_TOL:
        assert e["steps"] <= 1.0, (what, "an element moved past the largest step", e)


def test_train_step_like_jax(jax_side):
    """Each cell's mesh step against the JAX program: one layer within the
    one-device bounds; full depth within ``DEPTH_TOL`` or the JAX
    package's own (1, 1)-to-(2, 4) drift, whichever is larger.  An MoE
    cell runs on (1, 4) against the JAX (1, 1) program (one data slice:
    the same routing)."""
    for i, ((arch, one_layer), mshapes) in enumerate(CELLS.items()):
        params, batch = step_inputs(arch, one_layer, i)
        moe = ARCHS[arch].smoke_cfg.moe is not None
        got = port_step(arch, one_layer, (1, 4) if moe else MESH, params, batch)
        want = jax_step(jax_side, arch, one_layer, mshapes[0])
        e = step_errors(arch, got, want, got["p0"])
        tol = ONE_TOL if one_layer else DEPTH_TOL_OF.get(arch, DEPTH_TOL)
        if len(mshapes) > 1:  # the JAX package's drift between its own layouts
            drift = step_errors(arch, jax_step(jax_side, arch, one_layer, (1, 1)), want,
                                got["p0"])
            tol = {k: max(v, drift.get(k, 0.0)) for k, v in tol.items()}
        check_errors(arch, e, tol, cell_key(arch, one_layer))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_mesh_step_against_single(arch):
    """The port's (2, 4) step (an MoE's on (1, 4): its capacity is a data
    slice's) against its (1, 1) step within ``DEPTH_TOL``, and with one
    distinct tensor a position (no memoisation: distinct devices' rule)
    against the shared parts within ``ONE_TOL``."""
    params, batch = step_inputs(arch, False, 7)
    mshape = (1, 4) if ARCHS[arch].smoke_cfg.moe else MESH
    single = port_step(arch, False, (1, 1), params, batch)
    got = port_step(arch, False, mshape, params, batch)
    check_errors(arch, step_errors(arch, got, single, got["p0"]),
                 DEPTH_TOL_OF.get(arch, DEPTH_TOL), "(1, 1)")
    apart = port_step(arch, False, mshape, params, batch, unshared=True)
    check_errors(arch, step_errors(arch, apart, got, got["p0"]), ONE_TOL, "unshared")
    state = apart["state_tree"]
    step = state["step"]
    assert len(shd.distinct(step)) == len(step.parts) and all(int(t) == 1 for t in step.parts)


@pytest.fixture
def f32_activations(monkeypatch):
    """The LM run in f32 end to end: no bf16 embedding, attention output
    in its inputs' dtype."""
    flash = L.chunked_attention
    monkeypatch.setattr(L, "chunked_attention",
                        lambda q, k, v, **kw: flash(q, k, v, **kw).to(q.dtype))
    monkeypatch.setattr(tfm, "_embed", lambda params, tokens: params["embed"][tokens.long()])

    def embed(table, tokens, mesh):  # tmesh._embed without its bf16 cast
        vax, n = shd.axes_of(table.spec[0]), table.parts[0].shape[0]

        def take(t, tok, v0):
            local = tok.long() - v0
            return torch.where(((local >= 0) & (local < n))[..., None], t[local.clamp(0, n - 1)],
                               0)

        starts = [shd.block_index(mesh, q, vax) * n for q in range(len(mesh.devices))]
        return col.psum(col.per_position(take, mesh, table.parts, tokens, starts), mesh, vax)

    monkeypatch.setattr(tmesh, "_embed", embed)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_mesh_gradient_equals_one_device_in_f32(arch, f32_activations):
    """With the bf16 roundings taken out, the mesh loss's gradient (the
    vocab-split loss, partial sums, the combine over holders) equals the
    one-device gradient leaf for leaf within ``F32_TOL``, with shared and
    with distinct tensors a position."""
    params, batch = step_inputs(arch, False, 3)
    params = tree_map(lambda t: t.float(), params)
    cfg = ARCHS[arch].smoke_cfg
    loss1, g1 = trainer.value_and_grad(lambda p, b: tfm.loss_fn(cfg, p, b), params, batch)
    mshape = (1, 4) if cfg.moe else MESH
    prog = programs.build(arch, "train_4k", cpu_mesh(mshape), smoke=True)
    p, _, b = programs.lm_place(prog, (params, prog.opt.init(params), batch))
    for tree in (p, tree_map(_apart, p)):
        loss, g = trainer.value_and_grad(
            lambda p, b: tmesh.loss_fn(cfg, p, b, mesh=prog.mesh), tree, b)
        assert abs(float(loss) / float(loss1) - 1) <= 1e-5
        for (path, a), (_, want), (_, leaf) in zip(leaves(g), leaves(g1), leaves(tree)):
            assert isinstance(a, Sharded) and a.spec == leaf.spec, path
            assert rel_l2(f32(a), f32(want)) <= F32_TOL, (path, rel_l2(f32(a), f32(want)))


def test_gradient_combine_rules():
    """A leaf split over ``model`` and a replicated one, read at every
    position of a (2, 4) mesh through a ``psum`` over ``model`` and a
    detached ``pmax``, the loss read once a data slice: the gradients and
    ``grad_norm`` equal one device's (f32, 1e-6), with the parts shared on
    the repeated device and with a distinct tensor a position."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32))

    def one(p, x):
        h = (x * p["r"]) @ p["w"]
        return torch.sum(torch.tanh(h - h.detach().amax(-1, keepdim=True)) ** 2) / 3.0

    mesh = cpu_mesh(MESH)

    def sharded(p, xs):
        h = col.per_position(lambda x, w, r: (x * r) @ w, mesh, xs.parts, p["w"].parts,
                             p["r"].parts)
        m = col.pmax(col.per_position(lambda h: h.detach().amax(-1, keepdim=True), mesh, h),
                     mesh, ("model",))
        s = col.psum(col.per_position(lambda h, m: torch.sum(torch.tanh(h - m) ** 2, dim=-1),
                                      mesh, h, m), mesh, ("model",))
        firsts = [row[0] for row in mesh.grid()]
        return col.sum_in_order([s[q].sum() for q in firsts]) / 3.0

    loss1, g1 = trainer.value_and_grad(one, {"w": w, "r": r}, x)
    params = {"w": shd.shard(w, mesh, (None, "model")), "r": shd.shard(r, mesh, (None,))}
    xs = shd.shard(x, mesh, ("data", None))
    for tree in (params, tree_map(_apart, params)):
        loss, g = trainer.value_and_grad(sharded, tree, xs)
        torch.testing.assert_close(loss, loss1, **OPT_TOL)
        for k in ("w", "r"):
            assert g[k].spec == tree[k].spec
            torch.testing.assert_close(g[k].unshard(), g1[k], **OPT_TOL)
            for held in shd.holders(g[k]).values():  # every holder the same gradient
                assert all(torch.equal(t, held[0]) for t in held)
        sq = sum(trainer._squares(g[k], torch.device("cpu")) for k in ("w", "r"))
        torch.testing.assert_close(sq, sum(torch.sum(g1[k] ** 2) for k in ("w", "r")), **OPT_TOL)


def test_jax_moe_shmap_router_gradient(jax_side):
    """The JAX package's ``moe_ffn_shmap`` on (1, 4) gives the router a
    gradient far from its own ``moe_ffn``'s on the same tokens (no drops;
    the expert gradients agree): a fault of the reference (ROADMAP Queue
    3).  The port's (1, 4) router gradient equals its ``moe_ffn``'s
    exactly, and that one the JAX ``moe_ffn``'s within the one-device
    gradient bound (3e-2)."""
    lp, x, w = moe_grad_inputs()
    cfg = moe_grad_cfg(tfm)
    xb = torch.from_numpy(x).bfloat16()

    def router_grad(f):
        p = {k: torch.from_numpy(v).requires_grad_() for k, v in lp.items()}
        (f(p).float() * torch.from_numpy(w)).sum().backward()
        return p["router"].grad.numpy()

    single = router_grad(lambda p: tfm.moe_ffn(cfg, p, xb.reshape(-1, x.shape[-1]))
                         .reshape(x.shape))
    shmap = router_grad(lambda p: tfm.moe_ffn_shmap(cfg, p, xb, mesh=cpu_mesh((1, 4)),
                                                    dp_axes=("data",)))
    np.testing.assert_array_equal(shmap, single)
    assert rel_l2(single, jax_side["moe/single"]) <= 3e-2
    assert rel_l2(jax_side["moe/shmap"], jax_side["moe/single"]) > 0.5  # the reference's fault


def _adafactor_trees(rng, scale):
    shapes = {"stacked": (4, 8, 16), "matrix": (8, 16), "vector": (16,)}
    return {k: rng.standard_normal(s).astype(np.float32) * scale for k, s in shapes.items()}


@pytest.mark.parametrize("split", ["last", "second_last"])
def test_adafactor_on_a_split_leaf_like_jax(split):
    """Adafactor on leaves split over ``model`` of a (2, 4) mesh (the
    dimension its row or its column moment reduces) against the JAX
    ``adafactor`` on the whole arrays, the same gradients, three steps:
    parameters and moments within 1e-6; the moments laid out as
    ``state_logical_axes`` lays them."""
    rng = np.random.default_rng(3 if split == "last" else 4)
    mesh = cpu_mesh(MESH)
    specs = {"stacked": (None, None, "model") if split == "last" else (None, "model", None),
             "matrix": (None, "model") if split == "last" else ("model", None),
             "vector": ("model",)}
    jopt, opt = joptim.adafactor(1e-2), optim.adafactor(1e-2)
    p_np = _adafactor_trees(rng, 1.0)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    p = {k: shd.shard(torch.from_numpy(v.copy()), mesh, specs[k]) for k, v in p_np.items()}
    jstate, state = jopt.init(jp), opt.init(p)
    axes = {k: tuple(f"a{i}" if e is None else "ffn" for i, e in enumerate(s))
            for k, s in specs.items()}
    want_specs = tree_map(lambda t, ax: shd.spec_for(mesh, ax, t.shape),
                          opt.init({k: torch.zeros(v.shape) for k, v in p_np.items()}),
                          opt.state_logical_axes(axes))
    for path, s in leaves(state):
        assert s.spec == tree_map(lambda x: x, want_specs)[path[0]][path[1]][path[2]] \
            if len(path) == 3 else s.spec == ()
    update = jax.jit(jopt.update)
    for _ in range(3):
        g_np = _adafactor_trees(rng, 0.1)
        jp, jstate = update({k: jnp.asarray(v) for k, v in g_np.items()}, jstate, jp)
        g = {k: shd.shard(torch.from_numpy(v), mesh, specs[k]) for k, v in g_np.items()}
        new, new_state = opt.update(g, state, p)
        assert new is p and new_state is state
        for k in p_np:
            np.testing.assert_allclose(f32(p[k]), np.asarray(jp[k]), **OPT_TOL, err_msg=k)
        got = {path: f32(s) for path, s in leaves(state)}
        for (path, a), b in zip(sorted(got.items()), jax.tree.leaves(jstate)):
            np.testing.assert_allclose(a, np.asarray(b), **OPT_TOL, err_msg=str(path))


@pytest.mark.parametrize("mshape", [(2, 4), (1, 4), (1, 8)])
def test_state_layout_like_the_jax_builder(mshape):
    """``opt.init`` of parameters placed on a mesh lays the state out as
    the program's ``in_shardings`` (the JAX builder's ``spec_for`` of
    ``state_logical_axes``), every arch; so does ``lm_inputs``."""
    mesh = cpu_mesh(mshape)
    for arch in LM_ARCHS:
        prog = programs.build(arch, "train_4k", mesh, smoke=True)
        psh, osh, bsh = prog.in_shardings
        params = programs.shard_params(tfm.init(prog.cfg, torch.Generator(), device="cpu"),
                                       mesh, prog.rules)
        state = prog.opt.init(params)
        for (path, s), (_, want) in zip(leaves(state), leaves(osh)):
            assert s.spec == tuple(want), (arch, path, s.spec, want)
        p, st, b = programs.lm_inputs(prog, "cpu", seed=1)
        assert all(s.spec == tuple(w) for (_, s), (_, w) in zip(leaves(st), leaves(osh)))
        assert b["tokens"].spec == b["labels"].spec == tuple(bsh["tokens"])


def test_checkpoint_from_a_mesh(tmp_path):
    """The (2, 4) program's parameters and state after a step, written by
    ``checkpoint.save``: restored onto the (1, 1) program they step as the
    mesh ones would; restored onto the mesh by ``in_shardings`` they are
    the saved blocks; the JAX ``checkpoint.restore`` reads every leaf."""
    arch = "command-r-plus-104b"  # Adafactor: the factored state crosses too
    mesh = cpu_mesh(MESH)
    prog = programs.build(arch, "train_4k", mesh, smoke=True)
    single = programs.build(arch, "train_4k", cpu_mesh((1, 1)), smoke=True)
    params, batch = step_inputs(arch, False, 5)
    p, s, b = programs.lm_place(prog, (params, prog.opt.init(params), batch))
    prog.fn(p, s, b)
    ckpt.save(str(tmp_path), 1, {"params": p, "opt": s})
    like = {"params": params, "opt": single.opt.init(params)}
    got, step = ckpt.restore(str(tmp_path), 1, like)
    assert step == 1
    for (path, a), (_, m) in zip(leaves(got), leaves({"params": p, "opt": s})):
        assert a.device.type == "cpu" and torch.equal(a, m.unshard()), path
    jlike = tree_map(lambda t: np.zeros(t.shape, str(t.dtype).removeprefix("torch.")), like)
    back, _ = jckpt.restore(str(tmp_path), 1, jlike)
    for a, (path, want) in zip(jax.tree.leaves(back), leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), want.numpy(), err_msg=str(path))
    _, _, m1 = single.fn(got["params"], got["opt"], batch)
    _, _, m2 = prog.fn(p, s, b)
    assert abs(float(m1["loss"]) / float(m2["loss"]) - 1) <= DEPTH_TOL["loss"]
    placed, _ = ckpt.reshard_restore(str(tmp_path), 1, like, {"params": prog.in_shardings[0],
                                                             "opt": prog.in_shardings[1]}, mesh)
    fresh = prog.opt.init(programs.shard_params(params, mesh, prog.rules))
    for (path, a), (_, want) in zip(leaves(placed["opt"]), leaves(fresh)):
        assert isinstance(a, Sharded) and a.spec == want.spec, path


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_mesh_remat_changes_no_gradient(arch):
    """The mesh loss with each layer recomputed in the backward
    (``cfg.remat``, one autograd node a layer) gives the loss and gradients
    of the loss that keeps every activation, bit for bit, with shared and
    with distinct tensors a position."""
    params, batch = step_inputs(arch, False, 4)
    cfg = ARCHS[arch].smoke_cfg
    assert cfg.remat
    prog = programs.build(arch, "train_4k", cpu_mesh((1, 4) if cfg.moe else MESH), smoke=True)
    p, _, b = programs.lm_place(prog, (params, prog.opt.init(params), batch))
    for tree in (p, tree_map(_apart, p)):
        got = [trainer.value_and_grad(lambda p, b, c=c: tmesh.loss_fn(c, p, b, mesh=prog.mesh),
                                      tree, b)
               for c in (cfg, dataclasses.replace(cfg, remat=False))]
        assert torch.equal(got[0][0], got[1][0])
        for (path, a), (_, c) in zip(leaves(got[0][1]), leaves(got[1][1])):
            assert all(torch.equal(x, y) for x, y in zip(a.parts, c.parts)), path
