"""The LM training path of ``repro_torch`` against the JAX package's, on
the same numpy inputs:

* the flash backward: gradients of ``layers.chunked_attention`` (the
  ``_Flash`` autograd function) against ``jax.grad`` through
  ``repro.models.layers.chunked_attention`` (its custom VJP): causal and
  not, a sliding window, a softcap, lengths that are not multiples of the
  chunks, GQA, fewer queries than keys; the output without a gradient
  bit-identical to the output with one; no saved tensor the size of a
  score matrix;
* the loss and every parameter leaf's gradient of ``transformer.loss_fn``
  against ``jax.value_and_grad(transformer.loss_fn)`` for the five smoke
  configs, on the JAX parameters carried over by ``params_from_arrays``;
  remat on and off giving the same gradients; the MoE router's gradient
  nonzero;
* one step of each smoke ``train_4k`` program against the JAX program's
  ``fn`` on an ``Auto``-axis (1, 1) mesh: loss, ``grad_norm``, the new
  parameters and optimizer state.

Tolerances (measured on this CPU in brackets):
* flash outputs: each side the f32 online softmax rounded once to bf16,
  so each within half a bf16 step + eps of the float64 attention, eps the
  f32 error bound of ``flash_float64``, and the two within a step + 2·eps;
  the loss, a sum of n f32 products, within the probabilistic bound
  (λ·√n + 1)·u·Σ|terms| of the float64 sum of its side's output (not a
  bound relative to the loss: Σ|terms| is ~670 times the loss);
* flash gradients (bf16): relative L2 1e-3 a gradient [≤ 1.5e-4; most
  cases bit-equal];
* loss 1e-4 relative [≤ 1.1e-5]; gradients relative L2 3e-2 a leaf [≤
  1.7e-2 (gemma2), ≤ 1.0e-2 the others]: the forward's bf16 roundings
  that land the other way (an ulp of an f32 ``rsqrt`` or sum order) and
  autograd's order of summing a bf16 cotangent's terms move single
  elements by a bf16 step, and the layers carry that;
* the program step: loss 1e-4, ``grad_norm`` 5e-3 relative [≤ 1.4e-3];
  the optimizer's moments relative L2 6e-2 a leaf [≤ 3.2e-2: gradients
  and their squares]; AdamW's first update is ±lr·(1 + wd·p) wherever
  |g| ≫ eps, so where a gradient element's sign differs an element moves
  the other way: each element within 2.02·lr, at most 3% of a leaf's
  elements off by more than 1e-6 [≤ 1.2%]; Adafactor (f32,
  command-r) the update's relative L2 5e-2 a leaf [≤ 2.6e-2]; Adafactor
  on bf16 parameters (kimi) each element within one bf16 step of the
  leaf's largest value, at most 10% of elements differing [≤ 4.9%].

The JAX side runs under ``jax.jit``, one compile a config.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.launch import programs as jprograms
from repro.models import layers as jL, transformer as jtf
from repro_torch.configs import ARCHS
from repro_torch.data import tokens
from repro_torch.launch import mesh as meshlib, programs
from repro_torch.models import layers as L, transformer as tf
from repro_torch.train.trainer import value_and_grad
from repro_torch.tree import leaves

from lm_float64 import LAMBDA, U_F32

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
FLASH_TOL = 1e-3
LOSS_TOL = 1e-4
GRAD_TOL = 3e-2
GNORM_TOL = 5e-3
STATE_TOL = 6e-2


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def rel_l2(got, want) -> float:
    got, want = f32(got).astype(np.float64), f32(want).astype(np.float64)
    assert got.shape == want.shape
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / n) if n else float(np.linalg.norm(got))


# ---------------------------------------------------------------------------
# the flash backward
# ---------------------------------------------------------------------------

def bf16_step(y) -> np.ndarray:
    """The bf16 spacing (8 significand bits) at magnitudes ``y``."""
    return np.exp2(np.floor(np.log2(np.maximum(y, 2.0 ** -126))) - 7)


def sum_bound(terms) -> float:
    """How far an f32 sum of the f32 products ``terms`` (given exactly)
    may lie from their exact sum, in any order: one rounding a product and
    the probabilistic bound λ·√n·u·Σ|x_i| of an n-term sum (Higham & Mary,
    SIAM J. Sci. Comput. 41(5), 2019), λ = ``LAMBDA``."""
    terms = np.asarray(terms, np.float64).ravel()
    return (LAMBDA * np.sqrt(terms.size) + 1) * U_F32 * float(np.abs(terms).sum())


def flash_float64(q, k, v, *, causal, window, attn_softcap, chunk_q, chunk_kv):
    """Attention of the bf16-rounded ``q``, ``k``, ``v`` in float64 (plain
    softmax) [B, Sq, H, dh], and an elementwise bound ``eps`` on how far the
    f32 online softmax of either side lies from it, to first order in u =
    2^-24: a score's error ``(dh + 8)·u·Σ_d|q_d k_d|/√dh`` (the dot, the
    scale, the softcap's divide, tanh within 4 ulps, multiply), each
    probability's relative error ρ_j that plus ``u·(|s_j| + 3·max|s|) + (5 +
    6·n_kv)·u`` (the shift by the running max, exp within 4 ulps, the n_kv
    chunks' rescales), and ``eps = Σ_j p_j ρ_j |v_j - o| + (n + 2·n_kv + 2)·u
    ·Σ_j p_j |v_j|`` (the n-key sums of p and p·v, the rescales, the
    divide)."""
    u = U_F32
    q, k, v = (torch.from_numpy(a).bfloat16().double() for a in (q, k, v))
    B, Sq, H, dh = q.shape
    Skv, Kv = k.shape[1:3]
    k, v = k.repeat_interleave(H // Kv, 2), v.repeat_interleave(H // Kv, 2)
    scale = 1 / np.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    a = torch.einsum("bqhd,bkhd->bhqk", q.abs(), k.abs()) * scale
    if attn_softcap is not None:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    qp, kp = torch.arange(Sq)[:, None], torch.arange(Skv)[None]
    mask = kp < Skv
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    p = torch.softmax(torch.where(mask, s, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p, v)
    n_kv = -(-Skv // min(chunk_kv, Skv))
    rho = ((dh + 8) * a + s.abs() + 3 * s.abs().amax() + 5 + 6 * n_kv) * u
    vt = v.permute(0, 2, 1, 3)  # [B, H, Skv, dh]
    eps = torch.einsum("bhqk,bhqkd->bhqd", p * rho, (vt[:, :, None] - o[:, :, :, None]).abs())
    eps = eps + (mask.sum(-1, keepdim=True) + 2 * n_kv + 2) * u * (p @ vt.abs())
    return (o.permute(0, 2, 1, 3).numpy(), eps.permute(0, 2, 1, 3).numpy())


FLASH_CASES = [
    # (B, Sq, Skv, H, Kv, dh, causal, window, softcap, chunk_q, chunk_kv)
    (2, 37, 37, 4, 2, 8, True, None, None, 8, 16),  # causal, GQA, short last chunks
    (2, 37, 37, 4, 2, 8, False, None, None, 8, 16),  # not causal
    (2, 40, 40, 4, 4, 8, True, 7, None, 8, 16),  # a window
    (2, 33, 33, 8, 2, 8, True, None, 5.0, 8, 16),  # a softcap
    (1, 50, 50, 6, 3, 16, True, 12, 10.0, 16, 8),  # window + softcap, chunk_kv < chunk_q
    (2, 64, 64, 8, 2, 8, True, None, None, 512, 1024),  # one block (default chunks)
    (2, 24, 45, 4, 1, 8, False, None, 20.0, 8, 16),  # fewer queries than keys, MQA
]


def flash_inputs(case):
    """A ``FLASH_CASES`` case's keywords, f32 q, k, v and the loss's weights."""
    B, Sq, Skv, H, Kv, dh, causal, window, cap, cq, ckv = case
    kw = dict(causal=causal, window=window, attn_softcap=cap, chunk_q=cq, chunk_kv=ckv)
    rng = np.random.default_rng(Sq + Skv + H)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, dh), (B, Skv, Kv, dh), (B, Skv, Kv, dh)))
    return kw, q, k, v, rng.standard_normal((B, Sq, H, dh)).astype(np.float32)


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_gradients_like_jax(case):
    B, Sq, Skv, H = case[:4]
    kw, q, k, v, w = flash_inputs(case)

    def jloss(q, k, v):
        out = jL.chunked_attention(q, k, v, **kw)
        return jnp.sum(out.astype(jnp.float32) * w), out

    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    (jval, jout), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = L.chunked_attention(tq, tk, tv, **kw)
    with torch.no_grad():
        assert torch.equal(out, L.chunked_attention(tq, tk, tv, **kw))
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    assert max(sizes) < B * H * Sq * Skv // 2  # no probabilities stored
    loss = (out.float() * torch.from_numpy(w)).sum()
    loss.backward()
    # Each output is the f32 flash rounded once to bf16: within one bf16 step of the other
    # side's (+ 2·eps, eps ``flash_float64``'s f32 bound); the loss a sum of n f32 terms in
    # another order, so within ``sum_bound`` of either side plus what the outputs' steps move it
    # (measured on an AMD EPYC host: 1 output of 4,224 a step apart, at 0.26 of its bound; the
    # loss at 3.7e-6 of its bound).
    o64, eps = flash_float64(q, k, v, **kw)
    got, want = f32(out).astype(np.float64), f32(jout).astype(np.float64)
    assert np.all(np.abs(got - want) <= bf16_step(np.abs(o64) + eps) + 2 * eps)
    slack = np.sum((bf16_step(np.abs(o64) + eps) + 2 * eps) * np.abs(w))
    bound = slack + sum_bound(got * w) + sum_bound(want * w)
    assert abs(float(loss.detach()) - float(jval)) <= bound
    for name, t, j in zip("qkv", (tq, tk, tv), jgrads):
        assert t.grad.dtype == torch.bfloat16, name
        assert rel_l2(t.grad, j) <= FLASH_TOL, (name, rel_l2(t.grad, j))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_like_float64(case):
    """The port's and the JAX package's flash outputs each within half a bf16
    step + eps of the float64 attention (``flash_float64``), and each
    side's f32 loss within ``sum_bound`` of the float64 sum of its own
    output's terms (measured on an AMD EPYC host: outputs within 0.9983 of
    their bound, their f32 values before the rounding within 0.18 of eps;
    losses within 8.6e-4 of theirs)."""
    kw, q, k, v, w = flash_inputs(case)
    o64, eps = flash_float64(q, k, v, **kw)

    def jfn(q, k, v):
        out = jL.chunked_attention(q, k, v, **kw)
        return out, jnp.sum(out.astype(jnp.float32) * w)

    jout, jval = jax.jit(jfn)(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)))
    with torch.no_grad():
        out = L.chunked_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)), **kw)
        loss = (out.float() * torch.from_numpy(w)).sum()
    for got, val in ((f32(out), loss), (f32(jout), jval)):
        got = got.astype(np.float64)
        assert np.all(np.abs(got - o64) <= bf16_step(np.abs(o64) + eps) / 2 + eps)
        assert abs(float(val) - float(np.sum(got * w))) <= sum_bound(got * w)


# ---------------------------------------------------------------------------
# the loss gradient of the five smoke configs
# ---------------------------------------------------------------------------


def _jax_params(arch: str, seed: int, specs):
    """The reference's init rule drawn by numpy into ``specs``."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) <= 1:
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(rng.standard_normal(s.shape, np.float32)
                           / np.sqrt(s.shape[-2])).astype(s.dtype)

    return jax.tree.map(leaf, specs)


@pytest.fixture(scope="module")
def grads():
    """Per arch: (port cfg, port params, batch, port loss and gradients,
    the JAX loss and gradients)."""
    out = {}
    for i, arch in enumerate(LM_ARCHS):
        jcfg, cfg = JARCHS[arch].smoke_cfg, ARCHS[arch].smoke_cfg
        dt = jnp.bfloat16 if JARCHS[arch].param_dtype == "bfloat16" else jnp.float32
        jp = _jax_params(arch, i, jtf.param_specs(jcfg, dt))
        p = tf.params_from_arrays(cfg, jax.tree.map(np.asarray, jp), device="cpu")
        batch = tokens.TokenStream(cfg.vocab, 64, seed=i).batch(2)
        batch["labels"][0, -3:] = -1  # masked labels
        jl, jg = jax.jit(jax.value_and_grad(partial(jtf.loss_fn, jcfg)))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss, g = value_and_grad(lambda p, b: tf.loss_fn(cfg, p, b), p, tb)
        out[arch] = (cfg, p, tb, loss, g, float(jl), jg)
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_gradients_like_jax(grads, arch):
    cfg, p, _, loss, g, jl, jg = grads[arch]
    np.testing.assert_allclose(float(loss), jl, rtol=LOSS_TOL)
    got = list(leaves(g))
    want = jax.tree.leaves(jg)
    assert len(got) == len(want)
    for (path, a), b, (_, leaf) in zip(got, want, leaves(p)):
        assert a.dtype == leaf.dtype and a.shape == leaf.shape, path
        assert rel_l2(a, b) <= GRAD_TOL, (path, rel_l2(a, b))
    if cfg.moe:  # the gradient reaches the router through the gates
        assert float(g["layers"]["router"].abs().sum()) > 0
    if cfg.parallel_residual:  # the FFN norm is unused: a zero gradient, as in JAX
        assert not g["layers"]["ffn_norm"].any()


@pytest.mark.parametrize("arch", ["gemma2-27b", "olmoe-1b-7b"])
def test_remat_changes_no_gradient(grads, arch):
    """Per-layer rematerialisation recomputes the same forward: the same
    loss and gradients, bit for bit, as keeping every activation."""
    import dataclasses

    cfg, p, tb, loss, g, _, _ = grads[arch]
    assert cfg.remat
    flat = dataclasses.replace(cfg, remat=False)
    loss2, g2 = value_and_grad(lambda p, b: tf.loss_fn(flat, p, b), p, tb)
    assert torch.equal(loss, loss2)
    for (path, a), (_, b) in zip(leaves(g), leaves(g2)):
        assert torch.equal(a, b), path


# ---------------------------------------------------------------------------
# one step of the smoke train_4k programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_program_step_like_jax(arch):
    i = LM_ARCHS.index(arch)
    auto = (jax.sharding.AxisType.Auto,) * 2  # the builder's sharding constraints need Auto axes
    jprog = jprograms.build(arch, "train_4k", jax.make_mesh((1, 1), ("data", "model"),
                                                            axis_types=auto), smoke=True)
    prog = programs.build(arch, "train_4k", meshlib.make_mesh((1, 1), ("data", "model"), ["cpu"]),
                          smoke=True)
    jp = _jax_params(arch, 10 + i, jprog.in_specs[0])
    jstate = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jprog.in_specs[1])
    batch = tokens.TokenStream(prog.cfg.vocab, 64, seed=10 + i).batch(2)
    jnew, jnew_state, jm = jax.jit(jprog.fn)(jp, jstate, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    p0 = tf.params_from_arrays(prog.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    p = tf.params_from_arrays(prog.cfg, jax.tree.map(np.asarray, jp), device="cpu")
    state = prog.opt.init(p)
    new, new_state, m = prog.fn(p, state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert new is p and new_state is state  # updated in place
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GNORM_TOL)
    got_state, want_state = list(leaves(new_state)), jax.tree.leaves(jnew_state)
    assert len(got_state) == len(want_state)
    for (path, a), b in zip(got_state, want_state):
        if path == ("step",):
            assert a.dtype == torch.int32 and int(a) == int(b) == 1
        else:
            assert rel_l2(a, b) <= STATE_TOL, (path, rel_l2(a, b))
    lr = 1e-3 if JARCHS[arch].optimizer == "adafactor" else 3e-4
    for (path, a), (_, a0), b in zip(leaves(new), leaves(p0), jax.tree.leaves(jnew)):
        a, a0, b = f32(a), f32(a0), f32(b)
        off = np.abs(a - b)
        if JARCHS[arch].optimizer == "adamw":
            assert off.max() <= 2.02 * lr, path
            assert np.mean(off > 1e-6 + 1e-6 * np.abs(b)) <= 0.03, path
        elif JARCHS[arch].param_dtype == "float32":
            assert rel_l2(a - a0, b - a0) <= 5e-2, (path, rel_l2(a - a0, b - a0))
        else:  # bf16 parameters: one bf16 step where the rounding lands the other way
            assert off.max() <= 2.0 ** -7 * max(np.abs(b).max(), 1e-30), path
            assert np.mean(off > 0) <= 0.1, path
