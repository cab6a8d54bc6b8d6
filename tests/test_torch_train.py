"""The training modules of ``repro_torch.train`` and the train driver
against the JAX package's ``repro.train`` / ``repro.launch.train``:

* ``adamw``, ``adafactor`` and ``sgd`` on the same numpy gradients, state
  and parameters (leaves stacked over layers and not, f32 and bf16) as the
  JAX optimizers, three steps, within 1e-6 (relative and absolute;
  measured ≤ 2.1e-7 of a leaf's largest value, bf16 parameters equal);
* the JAX package's ``tests/test_train.py`` cases on the port: the loss
  falls and a second trainer resumes, a torn checkpoint is skipped,
  ``gc_tmp``, a restore onto other devices, gradient accumulation against
  the full batch, the watchdog, Adafactor's layer slicing;
* checkpoints of parameters and AdamW state written by one package and
  restored by the other, every leaf equal; a bf16 leaf stored as the JAX
  package stores it (``|V2``, manifest dtype ``bfloat16``);
* ``python -m repro_torch.launch.train --smoke --device cpu --steps 3``.
"""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt, optim as joptim
from repro_torch.configs import ARCHS
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as train_driver
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt, optim, trainer
from repro_torch.tree import leaves, tree_map

OPT_TOL = dict(rtol=1e-6, atol=1e-6)
CFG = tf.TransformerCfg(
    name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=64, chunk_q=8, chunk_kv=16,
)


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

OPT_SHAPES = {"stacked": (4, 8, 16), "one_layer": (1, 8, 6), "matrix": (8, 16), "vector": (16,)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_like_jax(name, dtype):
    rng = np.random.default_rng(len(name) + len(dtype))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def tree(scale):
        j = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32) * scale).astype(jdt)
             for k, s in OPT_SHAPES.items()}
        return j, {k: torch.from_numpy(f32(v).copy()).to(tdt) for k, v in j.items()}

    jopt, opt = getattr(joptim, name)(1e-2), getattr(optim, name)(1e-2)
    jp, p = tree(1.0)
    jstate, state = jopt.init(jp), opt.init(p)
    update = jax.jit(jopt.update)
    for _ in range(3):
        jg, g = tree(0.1)
        jp, jstate = update(jg, jstate, jp)
        new, new_state = opt.update(g, state, p)
        assert new is p and new_state is state  # in place
        for k in OPT_SHAPES:
            assert p[k].dtype == tdt
            np.testing.assert_allclose(f32(p[k]), f32(jp[k]), **OPT_TOL, err_msg=k)
        got, want = list(leaves(state)), jax.tree.leaves(jstate)
        assert len(got) == len(want)
        for (path, a), b in zip(got, want):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **OPT_TOL, err_msg=str(path))
    axes = {k: tuple(f"a{i}" for i in range(len(s))) for k, s in OPT_SHAPES.items()}
    assert opt.state_logical_axes(axes) == jopt.state_logical_axes(axes)


def test_adafactor_layerwise_equivalence():
    """Layer-sliced Adafactor == Adafactor on each layer slice alone."""
    rng = np.random.default_rng(0)
    p = {"w": torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32))}
    g = {"w": torch.from_numpy(rng.standard_normal((4, 8, 16)).astype(np.float32)) * 0.1}
    slices = [{"w": p["w"][i].clone()} for i in range(4)]
    opt = optim.adafactor(1e-2)
    opt.update(g, opt.init(p), p)
    for i, pl in enumerate(slices):
        opt.update({"w": g["w"][i]}, opt.init(pl), pl)
        np.testing.assert_allclose(p["w"][i].numpy(), pl["w"].numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer (the JAX package's tests/test_train.py)
# ---------------------------------------------------------------------------


def _batches(seed=0, batch=8, seq=16):
    ts = TokenStream(64, seq, seed=seed)
    while True:
        yield {k: torch.from_numpy(v) for k, v in ts.batch(batch).items()}


def _loss(p, b):
    return tf.loss_fn(CFG, p, b)


@pytest.fixture(scope="module")
def params():
    """The JAX test's parameters (``init`` with key 0), carried over."""
    jcfg = jtf.TransformerCfg(**{f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
    jp = jax.jit(lambda key: jtf.init(jcfg, key))(jax.random.PRNGKey(0))
    return tf.params_from_arrays(CFG, jax.tree.map(np.asarray, jp), device="cpu")


def test_loss_decreases_and_resume(params):
    before = tree_map(torch.clone, params)
    with tempfile.TemporaryDirectory() as d:
        tc = trainer.TrainerConfig(ckpt_dir=d, ckpt_every=10, log_every=100)
        t = trainer.Trainer(tc, _loss, optim.adamw(1e-3), params)
        assert not t.try_resume()
        hist = t.run(_batches(), 20, log=lambda s: None)
        assert hist[-1]["loss"] < hist[0]["loss"]
        assert ckpt.published_steps(d) == [10, 20]
        # the caller's tensors survive (the trainer trained a copy)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(leaves(params), leaves(before)))

        t2 = trainer.Trainer(tc, _loss, optim.adamw(1e-3), params)
        assert t2.try_resume() and t2.step_num == 20
        for (_, a), (_, b) in zip(leaves(t.params), leaves(t2.params)):
            assert torch.equal(a, b)
        for (_, a), (_, b) in zip(leaves(t.opt_state), leaves(t2.opt_state)):
            assert torch.equal(a, b)


def test_torn_checkpoint_skipped(params):
    with tempfile.TemporaryDirectory() as d:
        tc = trainer.TrainerConfig(ckpt_dir=d, ckpt_every=1000, log_every=100)
        t = trainer.Trainer(tc, _loss, optim.adamw(1e-3), params)
        state = {"params": t.params, "opt": t.opt_state}
        ckpt.save(d, 10, state)
        ckpt.save(d, 20, state)
        with open(os.path.join(d, "step_000000020", "manifest.json"), "w") as f:
            f.write("{torn")
        got = ckpt.restore_latest(d, state)
        assert got is not None and got[1] == 10


def test_gc_tmp_cleans_crashed_writes():
    with tempfile.TemporaryDirectory() as d:
        os.makedirs(os.path.join(d, "step_000000005.tmp-abc"))
        assert ckpt.gc_tmp(d) == 1
        assert ckpt.published_steps(d) == []
        assert ckpt.restore_latest(d, {}) is None


def test_elastic_reshard(params):
    """Restore onto a device, or a tree of them."""
    with tempfile.TemporaryDirectory() as d:
        state = {"params": params}
        ckpt.save(d, 1, state)
        for devices in (torch.device("cpu"), tree_map(lambda t: "cpu", state)):
            restored, step = ckpt.reshard_restore(d, 1, state, devices)
            assert step == 1
            for (_, a), (_, b) in zip(leaves(restored), leaves(state)):
                assert a.device.type == "cpu" and torch.equal(a, b)
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(d, 1, {"params": dict(params, final_norm=torch.zeros(3))})


def test_grad_accum_matches_big_batch(params):
    """accum=2 over half-batches == one full batch (linear loss scaling)."""
    b = TokenStream(64, 16, seed=7).batch(8)
    full = {k: torch.from_numpy(v) for k, v in b.items()}
    micro = {k: torch.from_numpy(v).reshape(2, 4, 16) for k, v in b.items()}
    opt = optim.sgd(0.0)  # lr 0: isolate the gradient computation
    p1, p2 = tree_map(torch.clone, params), tree_map(torch.clone, params)
    _, _, m1 = trainer.make_train_step(_loss, opt, grad_accum=1)(p1, opt.init(p1), full)
    _, _, m2 = trainer.make_train_step(_loss, opt, grad_accum=2)(p2, opt.init(p2), micro)
    assert m2["loss"].dtype == m2["grad_norm"].dtype == torch.float32
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 2e-2
    assert abs(float(m1["grad_norm"]) - float(m2["grad_norm"])) / float(m1["grad_norm"]) < 0.05


def test_straggler_watchdog():
    w = trainer.StragglerWatchdog(factor=3.0)
    for i in range(10):
        assert not w.observe(i, 0.1)
    assert w.observe(10, 1.0)  # 10x median
    assert w.flagged and w.flagged[0][0] == 10


def test_trainer_reports_stragglers(params, monkeypatch):
    """``run`` feeds the watchdog each step's wall time and calls back."""
    times = iter([0.0, 0.1] * 6 + [0.0, 5.0])
    monkeypatch.setattr(trainer.time, "perf_counter", lambda: next(times))
    seen = []
    with tempfile.TemporaryDirectory() as d:
        tc = trainer.TrainerConfig(ckpt_dir=d, ckpt_every=1000, log_every=1)
        t = trainer.Trainer(tc, _loss, optim.sgd(0.0), params,
                            on_straggler=lambda s, dt: seen.append((s, dt)))
        lines = []
        t.run(_batches(batch=2), 7, log=lines.append)
    assert seen == [(7, 5.0)] and len(lines) == 7 and lines[0].startswith("step      1")


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------


def _jax_state(arch: str):
    """Parameters (numpy-drawn) and AdamW state after one step, both JAX."""
    jcfg = JARCHS[arch].smoke_cfg
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)),
                      jtf.param_specs(jcfg))
    opt = joptim.adamw(1e-3)
    jg = jax.tree.map(lambda a: a * 0.01, jp)
    _, s = jax.jit(opt.update)(jg, opt.init(jp), jp)
    return {"params": jp, "opt": s}


def test_checkpoints_cross_packages():
    jstate = _jax_state("tinyllama-1.1b")
    tstate = tree_map(lambda a: torch.from_numpy(np.array(a)), jax.tree.map(np.asarray, jstate))
    with tempfile.TemporaryDirectory() as d:
        # JAX writes, the port reads
        jckpt.save(os.path.join(d, "j"), 7, jstate)
        got, step = ckpt.restore(os.path.join(d, "j"), 7, tstate)
        assert step == 7
        for (path, a), b in zip(leaves(got), jax.tree.leaves(jstate)):
            assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path))
        # the port writes, JAX reads; the same manifest but for the time
        ckpt.save(os.path.join(d, "t"), 7, tstate)
        back, step = jckpt.restore(os.path.join(d, "t"), 7, jstate)
        assert step == 7
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, np.asarray(b))
        man = [json.load(open(os.path.join(d, w, "step_000000007", "manifest.json")))
               for w in ("j", "t")]
        assert man[0]["leaves"] == man[1]["leaves"]
        assert open(os.path.join(d, "t", "LATEST")).read() == "7"


def test_bf16_checkpoint_like_jax():
    """A bf16 leaf is stored as the JAX package stores it: its 2-byte
    pattern (``|V2``), ``bfloat16`` in the manifest; each package reads the
    other's bytes."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5)).astype(np.float32)
    jstate = {"w": jnp.asarray(a).astype(jnp.bfloat16), "step": jnp.zeros((), jnp.int32)}
    tstate = {"w": torch.from_numpy(a).bfloat16(), "step": torch.zeros((), dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(os.path.join(d, "j"), 1, jstate)
        ckpt.save(os.path.join(d, "t"), 1, tstate)
        files = [np.load(os.path.join(d, w, "step_000000001", "shard_h000.npz"))
                 for w in ("j", "t")]
        for k in ("a0", "a1"):
            assert files[0][k].dtype == files[1][k].dtype
            assert files[0][k].tobytes() == files[1][k].tobytes()
        assert files[1]["a1"].dtype.str == "|V2"
        man = json.load(open(os.path.join(d, "t", "step_000000001", "manifest.json")))
        assert [e["dtype"] for e in man["leaves"]] == ["int32", "bfloat16"]
        got, _ = ckpt.restore(os.path.join(d, "j"), 1, tstate)
        assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tstate["w"])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def test_train_driver_smoke_on_cpu(tmp_path, capsys):
    argv = ["--arch", "kimi-k2-1t-a32b", "--smoke", "--device", "cpu", "--steps", "3",
            "--seq", "16", "--batch", "2", "--log-every", "1", "--ckpt-dir", str(tmp_path)]
    hist = train_driver.main(argv)
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.published_steps(str(tmp_path)) == [3]
    man = json.load(open(tmp_path / "step_000000003" / "manifest.json"))
    assert any("['f']" in e["path"] for e in man["leaves"])  # the arch's Adafactor
    again = train_driver.main(argv[:6] + ["1"] + argv[7:])
    assert again[0]["step"] == 4
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "done: 3 steps" in out
    assert ARCHS["kimi-k2-1t-a32b"].optimizer == "adafactor"
    for arch in ("k2triples", "gcn-cora"):
        with pytest.raises(SystemExit, match="family 'engine'|Queue 1 item 3"):
            train_driver.main(["--arch", arch, "--device", "cpu"])
