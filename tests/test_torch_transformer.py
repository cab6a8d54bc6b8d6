"""The transformer LM of ``repro_torch.models.transformer`` (and
``data.tokens``) against the JAX package's, on the smoke configs of the
five LM archs with the JAX parameters copied in (``params_from_arrays``):

* configs, ``n_params`` / ``n_active_params``, ``param_specs`` shapes
  and ``logical_axes``, smoke and full; ``params_from_arrays`` (f32 and
  bf16 trees, refusals) and ``init``'s rule;
* the MoE: ``moe_capacity`` (exact), ``_moe_dispatch_indices`` given the
  same f32 gates, ties and capacity overflow included (``idx`` / ``wslot``
  / ``valid`` exactly equal), the combine's slot order (bit for bit against
  a sequential scatter-add), ``moe_ffn`` on a layer;
* ``prefill`` and two ``decode_step``s (tinyllama: GQA; gemma2: window,
  both softcaps, tied embeddings; command-r: parallel residual; olmoe and
  kimi: MoE, kimi with bf16 parameters), a decode past the cache, and
  ``forward`` / ``unembed_logits`` / ``loss_fn``;
* ``TokenStream``: the same batches for a seed.

Tolerances: the whole model's hidden states, logits and caches, each side
within 6 standard deviations of the bf16 rounding spread of a float64
model (``lm_float64``), so within twice that of each other (they are ~2e-7
apart where every bf16 rounding lands alike; one attention output a hair
from a bf16 midpoint rounds the other way on some hosts, and four gemma2
layers carry that step to 0.08, past the 5e-2 of the JAX package's own LM
test); the loss 5e-2 relative and absolute; ``unembed_logits`` of the
same hidden states 1e-4 (an f32 product of the same bf16 operands);
``moe_ffn`` on the same input 1e-2, two bf16 steps.
The JAX side runs under ``jax.jit`` with the config static.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import tokens as jtokens
from repro.models import transformer as jtf
from repro_torch.configs import ARCHS
from repro_torch.data import tokens
from repro_torch.models import layers as L, transformer as tf

import lm_float64 as F64
from lm_float64 import LAMBDA

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
MODEL_TOL = dict(rtol=5e-2, atol=5e-2)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def models():
    """Per arch: (JAX cfg, port cfg, JAX params, port params on the CPU),
    the parameters in the arch's dtype."""
    out = {}
    for i, arch in enumerate(LM_ARCHS):
        jcfg, cfg = JARCHS[arch].smoke_cfg, ARCHS[arch].smoke_cfg
        dt = jnp.bfloat16 if JARCHS[arch].param_dtype == "bfloat16" else jnp.float32
        rng = np.random.default_rng(i)

        def leaf(s):  # the reference's init rule, drawn by numpy
            if len(s.shape) <= 1:
                return jnp.zeros(s.shape, dt)
            return jnp.asarray(rng.standard_normal(s.shape, np.float32)
                               / np.sqrt(s.shape[-2])).astype(dt)

        jp = jax.tree.map(leaf, jtf.param_specs(jcfg, dt))
        out[arch] = (jcfg, cfg, jp, tf.params_from_arrays(cfg, jax.tree.map(np.asarray, jp),
                                                          device="cpu"))
    return out


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cfg_and_param_shapes_like_jax(arch):
    for which in ("cfg", "smoke_cfg"):
        cfg, jcfg = getattr(ARCHS[arch], which), getattr(JARCHS[arch], which)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params == jcfg.n_params and cfg.n_active_params == jcfg.n_active_params
        specs, jspecs = tf.param_specs(cfg), jtf.param_specs(jcfg)
        got = dict(tf._leaves(specs))
        want = {tuple(k.key for k in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(jspecs)}
        assert set(got) == set(want)
        for path, s in got.items():
            assert s.device.type == "meta" and s.dtype == torch.float32
            assert tuple(s.shape) == tuple(want[path].shape), path
        assert sum(s.numel() for s in got.values()) == cfg.n_params
        assert tf.logical_axes(cfg) == jtf.logical_axes(jcfg)
        assert tf.local_flags(cfg) == [bool(f) for f in (
            (np.arange(cfg.n_layers) % cfg.local_every) != (cfg.local_every - 1)
            if cfg.window is not None else np.zeros(cfg.n_layers, bool))]


def test_params_from_arrays_and_init(models):
    for arch, (jcfg, cfg, jp, p) in models.items():
        for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
            got = p
            for k in path:
                got = got[k.key]
            assert got.dtype == (torch.bfloat16 if leaf.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_array_equal(f32(got), f32(leaf))
        assert sum(x.numel() for _, x in tf._leaves(p)) == cfg.n_params
    jcfg, cfg, jp, _ = models["tinyllama-1.1b"]
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        tf.params_from_arrays(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tf.params_from_arrays(cfg, {k: v for k, v in tree.items() if k != "unembed"},
                              device="cpu")
    # init: the reference's rule, drawn from the generator, the same for a seed
    a = tf.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tf.init(cfg, torch.Generator().manual_seed(3), device="cpu", dtype=torch.bfloat16)
    for (path, x), (_, y) in zip(tf._leaves(a), tf._leaves(b)):
        assert x.dtype == torch.float32 and y.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(x.bfloat16()), f32(y))
        if x.dim() <= 1:
            assert not x.any(), path
        else:
            std = float(x.std()) * np.sqrt(x.shape[-2])
            assert 0.8 < std < 1.2, (path, std)  # normal / sqrt(shape[-2])
    assert a["final_norm"].shape == (cfg.d_model,) and a["layers"]["attn_norm"].any()


def test_moe_capacity_like_jax():
    for arch in ("olmoe-1b-7b", "kimi-k2-1t-a32b"):
        for cfg, jcfg in ((ARCHS[arch].cfg, JARCHS[arch].cfg),
                          (ARCHS[arch].smoke_cfg, JARCHS[arch].smoke_cfg)):
            for T in (1, 4, 7, 48, 256, 8192, 65_536):
                assert tf.moe_capacity(cfg, T) == jtf.moe_capacity(jcfg, T), (arch, T)
    assert tf.moe_capacity(ARCHS["olmoe-1b-7b"].cfg, 8192) == 1280


DISPATCH_CASES = [
    # (T, E, K, C, e0, e_count, levels): levels > 0 quantises the gates (ties)
    (48, 8, 2, 15, 0, None, 0),
    (48, 8, 2, 15, 0, None, 3),  # many exact ties
    (64, 8, 2, 4, 0, None, 2),  # capacity overflow: pairs dropped
    (40, 64, 8, 8, 0, None, 5),  # olmoe's E and K
    (30, 8, 2, 9, 4, 4, 0),  # a local expert range (the sharded layout)
    (30, 8, 3, 6, 2, 3, 2),
]


@pytest.mark.parametrize("case", DISPATCH_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_dispatch_exact(case):
    T, E, K, C, e0, e_count, levels = case
    rng = np.random.default_rng(T + E + K + C + levels)
    g = rng.random((T, E)).astype(np.float32)
    if levels:
        g = np.floor(g * levels).astype(np.float32) / levels + 0.01
    g = g / g.sum(-1, keepdims=True)
    got = tf._moe_dispatch_indices(torch.from_numpy(g), E, K, C, e0, e_count)
    want = jax.jit(partial(jtf._moe_dispatch_indices, E=E, K=K, C=C, e0=e0,
                           e_count=e_count))(jnp.asarray(g))
    for name, a, b in zip(("idx", "wslot", "valid"), got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert got[2].any()


def test_moe_ffn_like_jax(models):
    jcfg, cfg, jp, p = models["olmoe-1b-7b"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((48, cfg.d_model)).astype(np.float32)
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    got = tf.moe_ffn(cfg, tf._layer_params(p, 1), torch.from_numpy(x).bfloat16())
    want = jax.jit(partial(jtf.moe_ffn, jcfg))(jlp, jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)


def test_moe_combine_in_slot_order(models):
    """``_moe_route``'s table holds each token's kept slots once, ascending;
    ``_moe_expert_compute``'s combine equals a sequential bf16 scatter-add
    in slot order bit for bit (what the JAX package computes on the CPU)
    and the JAX function within two bf16 steps; dropped pairs and empty
    slots add nothing."""
    jcfg, cfg, jp, p = models["olmoe-1b-7b"]
    m = cfg.moe
    rng = np.random.default_rng(6)
    T = 40
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    lp = tf._layer_params(p, 0)
    tx = torch.from_numpy(x).bfloat16()
    for C in (4, 12):  # overflow, then room
        idx, wslot, valid, tab = tf._moe_route(tf.moe_gates(lp, tx), m.n_experts, m.top_k, C)
        n = m.n_experts * C
        assert tab.shape == (T, m.top_k) and (tab[:, 1:] >= tab[:, :-1]).all()
        kept = tab[tab < n]
        assert sorted(kept.tolist()) == torch.nonzero(valid)[:, 0].tolist()
        assert all((idx[tab[t][tab[t] < n]] == t).all() for t in range(T))
        got = tf._moe_expert_compute(lp, tx, idx, wslot, valid, m.n_experts, C, tab)
        xe = (tx[idx.long()] * valid[:, None].bfloat16()).reshape(m.n_experts, C, -1)
        y = torch.bmm(L.silu(torch.bmm(xe, lp["we1"].bfloat16())) * torch.bmm(
            xe, lp["we3"].bfloat16()), lp["we2"].bfloat16()).reshape(n, -1)
        contrib = y * (wslot * valid).bfloat16()[:, None]
        want = torch.zeros_like(tx)
        for s in range(n):  # the reference's order: slot by slot, bf16 after each add
            want[idx[s]] = want[idx[s]] + contrib[s]
        assert torch.equal(got, want)
        jgot = jax.jit(partial(jtf._moe_expert_compute, E_loc=m.n_experts, C=C))(
            jax.tree.map(lambda a: a[0], jp["layers"]), jnp.asarray(x).astype(jnp.bfloat16),
            *(jnp.asarray(a.numpy()) for a in (idx, wslot, valid)))
        np.testing.assert_allclose(f32(got), f32(jgot), **BF16_TOL)


_JIT = {}


def _jit(name, fn):
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


SERVE_LENS = ([24, 24], [25, 25], [32, 35])  # the third past the cache: no write


def serve_inputs(cfg, arch):
    """A prompt of 2 x 24 tokens and a new token a sequence for each of
    the ``SERVE_LENS`` decode steps."""
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    return toks, [rng.integers(0, cfg.vocab, 2).astype(np.int32) for _ in SERVE_LENS]


def _pad_cache(cache):
    """A prefill's cache [L, B, 24, Kv, dh] with 8 empty slots more."""
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 8)) for k, v in cache.items()}


@pytest.fixture(scope="module")
def serve_spread(models):
    """Per arch: the float64 prefill of ``serve_inputs`` and its decode steps
    (``lm_float64.prefill64`` / ``decode64``), (logits, k, v) a step, and
    their elementwise standard deviation over 64 runs with every bf16
    rounding stood in for by a relative noise within bf16's roundoff."""
    out = {}
    for arch in LM_ARCHS:
        _, cfg, _, p = models[arch]
        toks, news = serve_inputs(cfg, arch)
        p64 = F64.params64(p)

        def serve(rnd):
            logits, cache = F64.prefill64(cfg, p64, torch.from_numpy(toks), rnd)
            got = [logits, cache["k"], cache["v"]]
            cache = _pad_cache(cache)
            for new, lens in zip(news, SERVE_LENS):
                logits, cache = F64.decode64(cfg, p64, cache, torch.from_numpy(new),
                                             torch.tensor(lens), rnd)
                got += [logits, cache["k"], cache["v"]]
            return tuple(got)

        out[arch] = F64.spread(serve, 64, "bf16")
    return out


def _serve_jax(jcfg, jp, arch, toks, news):
    """The JAX package's prefill and decode steps: (logits, k, v) a step."""
    jl, jc = _jit(("prefill", arch), partial(jtf.prefill, jcfg))(jp, jnp.asarray(toks))
    got = [jl, jc["k"], jc["v"]]
    jc = {k: jnp.pad(v, ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))) for k, v in jc.items()}
    dec = _jit(("decode", arch), partial(jtf.decode_step, jcfg))
    for new, lens in zip(news, SERVE_LENS):
        jl, jc = dec(jp, jc, jnp.asarray(new), jnp.asarray(np.array(lens, np.int32)))
        got += [jl, jc["k"], jc["v"]]
    return [f32(t) for t in got]


def _serve_port(cfg, p, toks, news):
    """The port's prefill and decode steps: (logits, k, v) a step; each
    step writes its new k / v in place, at its position, or nowhere past
    the cache."""
    tl, tc = tf.prefill(cfg, p, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (2, cfg.vocab)
    assert all(t.dtype == torch.bfloat16 for t in tc.values())
    got = [tl, tc["k"], tc["v"]]
    tc = _pad_cache(tc)
    for step, (new, lens) in enumerate(zip(news, SERVE_LENS)):
        before = {k: v.clone() for k, v in tc.items()}
        tl, out = tf.decode_step(cfg, p, tc, torch.from_numpy(new), torch.tensor(lens))
        assert out is tc  # written in place
        got += [tl, tc["k"].clone(), tc["v"].clone()]
        for k in ("k", "v"):
            if step == 2:
                assert torch.equal(tc[k], before[k])
            else:
                changed = (tc[k] != before[k]).any(dim=(0, 3, 4))
                assert changed[:, lens[0]].all() and changed.sum() == 2
    return [f32(t) for t in got]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_like_jax(models, serve_spread, arch):
    """prefill over 2 x 24 tokens, then two decode steps into a 32-slot
    cache, then one step past the cache (lengths >= S: nothing written).
    The logits and caches are held as ``forward``'s hidden states are:
    each side within LAMBDA standard deviations of the bf16 rounding
    spread of the float64 prefill and steps (``serve_spread``), so the two
    within twice that (measured on an AMD EPYC host: at 0.084 of it,
    gemma2; 0 the others)."""
    jcfg, cfg, jp, p = models[arch]
    toks, news = serve_inputs(cfg, arch)
    got = _serve_port(cfg, p, toks, news)
    want = _serve_jax(jcfg, jp, arch, toks, news)
    _, sd = serve_spread[arch]
    for a, b, s in zip(got, want, sd):
        assert a.shape == b.shape and np.all(np.abs(a - b) <= 2 * LAMBDA * s)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_like_float64(models, serve_spread, arch):
    """The port's and the JAX package's prefill and decode steps (logits
    and caches) each within LAMBDA standard deviations of the bf16
    rounding spread of the float64 ones, elementwise (measured on an AMD
    EPYC host: <= 3.40 of them)."""
    jcfg, cfg, jp, p = models[arch]
    toks, news = serve_inputs(cfg, arch)
    base, sd = serve_spread[arch]
    for side in (_serve_port(cfg, p, toks, news), _serve_jax(jcfg, jp, arch, toks, news)):
        for a, b, s in zip(side, base, sd):
            z = np.abs(a - b) / np.where(s > 0, s, np.inf)
            assert np.all((s > 0) | (a == b)) and z.max() <= LAMBDA, z.max()


FORWARD_ARCHS = ("tinyllama-1.1b", "gemma2-27b")


def forward_batch(cfg) -> dict:
    batch = tokens.TokenStream(cfg.vocab, 20, seed=4).batch(2)
    batch["labels"][0, -3:] = -1  # masked labels
    return batch


@pytest.fixture(scope="module")
def spread64(models):
    """Per arch of ``FORWARD_ARCHS``: the float64 forward of the test's batch
    (``lm_float64.forward64``, the parameters as both sides read them) and
    its elementwise standard deviation over 64 runs with every bf16
    rounding of the model stood in for by a relative noise within bf16's
    unit roundoff (``lm_float64.Noise``)."""
    out = {}
    for arch in FORWARD_ARCHS:
        _, cfg, _, p = models[arch]
        tok, p64 = torch.from_numpy(forward_batch(cfg)["tokens"]), F64.params64(p)
        (h64,), (sd,) = F64.spread(lambda rnd: F64.forward64(cfg, p64, tok, rnd), 64, "bf16")
        out[arch] = (h64, sd)
    return out


def test_forward_unembed_and_loss_like_jax(models, spread64):
    for arch in FORWARD_ARCHS:
        jcfg, cfg, jp, p = models[arch]
        batch = forward_batch(cfg)
        h = tf.forward(cfg, p, torch.from_numpy(batch["tokens"]))
        jh = jax.jit(partial(jtf.forward, jcfg))(jp, jnp.asarray(batch["tokens"]))
        assert h.dtype == torch.bfloat16
        # Each side within LAMBDA standard deviations of the bf16 model's rounding spread of the
        # float64 forward (``spread64``), so the two within twice that (measured on an AMD EPYC
        # host: at 0.050 of it, gemma2; 0 for tinyllama).
        _, sd = spread64[arch]
        assert np.all(np.abs(f32(h) - f32(jh)) <= 2 * LAMBDA * sd)
        same_h = jnp.asarray(f32(h[:, -2:])).astype(jnp.bfloat16)  # the same operands
        np.testing.assert_allclose(
            tf.unembed_logits(cfg, p, h[:, -2:]).numpy(),
            np.asarray(jtf.unembed_logits(jcfg, jp, same_h)), **F32_TOL)
        loss = tf.loss_fn(cfg, p, {k: torch.from_numpy(v) for k, v in batch.items()})
        jloss = jax.jit(partial(jtf.loss_fn, jcfg))(jp, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
        np.testing.assert_allclose(float(loss), float(jloss), **MODEL_TOL)
        # the module holds the same tensors and answers as the functions
        m = tf.Transformer(cfg, p)
        assert all(a is b or a.data_ptr() == b.data_ptr()
                   for (_, a), (_, b) in zip(tf._leaves(m.params), tf._leaves(p)))
        assert ("unembed" in m.params) != cfg.tie_embeddings
        assert torch.equal(m(torch.from_numpy(batch["tokens"])), h)


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_like_float64(models, spread64, arch):
    """The port's and the JAX package's bf16 forwards each within LAMBDA
    standard deviations of the bf16 rounding spread of the float64 forward,
    elementwise (measured on an AMD EPYC host: both at 3.12 of them,
    gemma2; 2.52 tinyllama)."""
    jcfg, cfg, jp, p = models[arch]
    tok = forward_batch(cfg)["tokens"]
    h64, sd = spread64[arch]
    for h in (tf.forward(cfg, p, torch.from_numpy(tok)),
              jax.jit(partial(jtf.forward, jcfg))(jp, jnp.asarray(tok))):
        z = np.abs(f32(h) - h64) / sd
        assert z.max() <= LAMBDA, z.max()


def test_token_stream_like_jax():
    for vocab, seq, seed in ((128, 16, 0), (32_000, 64, 7), (50_304, 5, 3)):
        a, b = tokens.TokenStream(vocab, seq, seed=seed), jtokens.TokenStream(vocab, seq, seed=seed)
        for n in (2, 3):
            x, y = a.batch(n), b.batch(n)
            for k in ("tokens", "labels"):
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
        np.testing.assert_array_equal(x["labels"][:, :-1], x["tokens"][:, 1:])
