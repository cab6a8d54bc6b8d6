"""The transformer layers of ``repro_torch.models.layers`` against the JAX
package's ``repro.models.layers`` on the same numpy inputs (seeded).

Tolerances: f32 pieces (``rope`` and ``rms_norm`` on f32, ``softcap``)
agree to 1e-6; the masks are equal.  bf16 results (``chunked_attention``,
``decode_attention``, ``rope`` on bf16, the MLPs) agree to 1e-2 relative
and absolute, two steps of bf16's 2^-8 and tighter than the 5e-2 of the
JAX package's own attention test; measured, the attention outputs differ
in at most a few elements by one bf16 step (the f32 accumulation order)
and the MLPs not at all.  The JAX side runs under ``jax.jit`` with the
shape arguments static.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jL
from repro_torch.models import layers as L

F32_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)

_JIT = {}


def jx(fn, *args, static=(), **kw):
    """``fn(*args, **kw)`` under ``jax.jit``, every keyword static."""
    key = (fn, static, tuple(sorted(kw.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda *a: fn(*a, **kw), static_argnums=static)
    return _JIT[key](*args)


def f32(x):
    """A JAX or torch array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def both(a: np.ndarray, dtype):
    """The same values as a JAX and a torch array of ``dtype`` ("f32" /
    "bf16"); bf16 rounds the same way on both sides."""
    if dtype == "f32":
        return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


@pytest.mark.parametrize("theta", [10_000.0, 75_000_000.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_like_jax(theta, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 8, 16)).astype(np.float32) * 4
    pos = rng.integers(0, 40_000, (2, 24)).astype(np.int32)
    jxv, tx = both(x, dtype)
    got = L.rope(tx, torch.from_numpy(pos), theta)
    want = jx(jL.rope, jxv, jnp.asarray(pos), theta=theta)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_allclose(f32(got), f32(want), **(F32_TOL if dtype == "f32" else BF16_TOL))
    # one position a row (the decode form)
    got = L.rope(tx[:, :1], torch.from_numpy(pos[:, :1]), theta)
    want = jx(jL.rope, jxv[:, :1], jnp.asarray(pos[:, :1]), theta=theta)
    np.testing.assert_allclose(f32(got), f32(want), **(F32_TOL if dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_and_softcap_like_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.2
    jxv, tx = both(x, dtype)
    got = L.rms_norm(tx, torch.from_numpy(scale))
    want = jx(jL.rms_norm, jxv, jnp.asarray(scale))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(f32(got), f32(want), **(F32_TOL if dtype == "f32" else BF16_TOL))
    s = rng.standard_normal((4, 100)).astype(np.float32) * 80
    for cap in (None, 30.0, 50.0):
        np.testing.assert_allclose(f32(L.softcap(torch.from_numpy(s), cap)),
                                   f32(jL.softcap(jnp.asarray(s), cap)), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 5, 16])
def test_attn_mask_and_block_kinds(causal, window):
    """``_attn_mask`` equals the reference's; ``_block_kind`` (which blocks
    the port skips or leaves unmasked) equals the mask's all/any over
    every block of a small grid."""
    qp, kp = np.arange(8, 16), np.arange(4, 20)
    got = L._attn_mask(torch.from_numpy(qp), torch.from_numpy(kp), 18, causal, window)
    want = jL._attn_mask(jnp.asarray(qp), jnp.asarray(kp), 18, causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for kv_len in (1, 13, 40):
        for q0 in range(0, 40, 3):
            for k0 in range(0, 40, 5):
                q1, k1 = q0 + 2, k0 + 4
                m = L._attn_mask(torch.arange(q0, q1 + 1), torch.arange(k0, k1 + 1), kv_len,
                                 causal, window)
                want = "full" if m.all() else ("partial" if m.any() else "empty")
                assert L._block_kind(q0, q1, k0, k1, kv_len, causal, window) == want


ATTN_CASES = [
    # (B, S, H, Kv, dh, window, softcap, chunk_q, chunk_kv)
    (2, 48, 8, 4, 16, None, None, 16, 16),
    (2, 40, 8, 2, 16, 16, 50.0, 8, 16),  # both chunk sizes pad
    (1, 37, 4, 4, 8, 5, None, 8, 16),  # windowed rows whose first kv chunk is all masked
    (2, 33, 8, 1, 16, 9, 30.0, 16, 8),  # one kv head (G = 8)
    (1, 5, 2, 2, 8, None, None, 512, 1024),  # chunks larger than the sequence
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: f"S{c[1]}-w{c[5]}-cap{c[6]}")
def test_chunked_attention_like_jax(case):
    B, S, H, Kv, dh, window, cap, cq, ckv = case
    rng = np.random.default_rng(S)
    q, k, v = (rng.standard_normal((B, S, n, dh)).astype(np.float32) * 2 for n in (H, Kv, Kv))
    jq, tq = both(q, "bf16")
    jk, tk = both(k, "bf16")
    jv, tv = both(v, "bf16")
    kw = dict(causal=True, window=window, attn_softcap=cap, chunk_q=cq, chunk_kv=ckv)
    got = L.chunked_attention(tq, tk, tv, **kw)
    want = jx(jL.chunked_attention, jq, jk, jv, **kw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, H, dh)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    with pytest.raises(ValueError):
        L.chunked_attention(tq, tk, tv, causal=True, q_offset=1)


DECODE_CASES = [
    # (window, is_local, softcap, lengths): S = 40; lengths past S attend to every slot
    (None, None, None, [40, 1]),
    (8, True, 50.0, [17, 43]),
    (8, False, None, [3, 40]),
    (8, "tensor", 30.0, [25, 9]),
    (4, None, None, [6, 38]),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"w{c[0]}-{c[1]}-len{c[3]}")
def test_decode_attention_like_jax(case):
    window, is_local, cap, lengths = case
    rng = np.random.default_rng(len(str(case)))
    B, S, H, Kv, dh = 2, 40, 8, 2, 16
    q = rng.standard_normal((B, H, dh)).astype(np.float32) * 2
    kc, vc = (rng.standard_normal((B, S, Kv, dh)).astype(np.float32) for _ in range(2))
    jq, tq = both(q, "bf16")
    jk, tk = both(kc, "bf16")
    jv, tv = both(vc, "bf16")
    ln = np.asarray(lengths, np.int32)
    j_local = t_local = is_local
    if is_local == "tensor":
        j_local, t_local = jnp.asarray(True), torch.tensor(True)
    got = L.decode_attention(tq, tk, tv, length=torch.from_numpy(ln), window=window,
                             is_local=t_local, attn_softcap=cap)
    want = jax.jit(lambda *a: jL.decode_attention(
        a[0], a[1], a[2], length=a[3], window=window, is_local=a[4], attn_softcap=cap),
    )(jq, jk, jv, jnp.asarray(ln), j_local)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, dh)
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    # a scalar length broadcasts over the batch
    got = L.decode_attention(tq, tk, tv, length=int(ln[0]), window=window, is_local=t_local,
                             attn_softcap=cap)
    want = jax.jit(lambda *a: jL.decode_attention(
        a[0], a[1], a[2], length=a[3], window=window, is_local=a[4], attn_softcap=cap),
    )(jq, jk, jv, jnp.int32(ln[0]), j_local)
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)


def test_mlps_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    w1, w3 = (rng.standard_normal((64, 176)).astype(np.float32) / 8 for _ in range(2))
    w2 = rng.standard_normal((176, 64)).astype(np.float32) / 13
    jxv, tx = both(x, "bf16")
    ws = [w1, w3, w2]
    got = L.swiglu(tx, *(torch.from_numpy(w) for w in ws))
    want = jx(jL.swiglu, jxv, *(jnp.asarray(w) for w in ws))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    got = L.gelu_mlp(tx, torch.from_numpy(w1), torch.from_numpy(w2))
    want = jx(jL.gelu_mlp, jxv, jnp.asarray(w1), jnp.asarray(w2))
    np.testing.assert_allclose(f32(got), f32(want), **BF16_TOL)
    # the activations alone: the reference's formulas, rounded op by op
    h = np.linspace(-8, 8, 3001).astype(np.float32)
    jh, th = both(h, "bf16")
    np.testing.assert_allclose(f32(L.silu(th)), f32(jx(jax.nn.silu, jh)), **BF16_TOL)
    np.testing.assert_allclose(f32(L.gelu(th)), f32(jx(jax.nn.gelu, jh)), **BF16_TOL)
    # the relu stack in f32
    xs = rng.standard_normal((5, 12)).astype(np.float32)
    wl = [rng.standard_normal(s).astype(np.float32) for s in ((12, 16), (16, 8), (8, 3))]
    bl = [rng.standard_normal(s[1]).astype(np.float32) for s in ((12, 16), (16, 8), (8, 3))]
    got = L.mlp_stack(torch.from_numpy(xs), [torch.from_numpy(w) for w in wl],
                      [torch.from_numpy(b) for b in bl])
    want = jL.mlp_stack(jnp.asarray(xs), [jnp.asarray(w) for w in wl],
                        [jnp.asarray(b) for b in bl])
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)
