"""A float64 reference of the LM smoke models, and the spread of
their rounding, for the port's CPU comparisons (``test_torch_transformer``,
``test_torch_train_mesh``).

``forward64`` / ``loss64`` / ``prefill64`` / ``decode64`` are the JAX
package's ``transformer.forward`` / ``loss_fn`` / ``prefill`` /
``decode_step`` (GQA, a sliding window on the local layers, both softcaps,
tied embeddings, the parallel residual, the capacity-routed top-k MoE)
written out in float64: plain softmax attention, no chunking, the MoE an
expert gather a token and choice.  Every place where the bf16 or f32
model rounds a value calls ``rnd(t, kind, k)``: ``kind`` is "bf16" where
the bf16 model rounds to bf16 (the f32 model rounds it to f32), "f32"
where both round to f32; ``k`` is the length of the sum the value comes
from (1 for an elementwise op).

``Noise`` stands in for those roundings: it multiplies a value by 1 + δ,
δ uniform in [-a, a], a = u the unit roundoff of the dtype the value is
rounded to, or u·√k for an f32 sum of k terms (the standard deviation of
k independent roundings of its partial sums), and under autograd its
cotangent by an independent 1 + δ' (the backward's rounding at the same
place).  The spread of many noisy runs around the noiseless one is the
model's rounding error under the probabilistic model of Higham & Mary
(SIAM J. Sci. Comput. 41(5), 2019: roundings independent, of mean zero):
a bf16 or f32 evaluation lies within ``LAMBDA`` standard deviations of the
float64 value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

U_BF16 = 2.0 ** -8  # unit roundoff: 8 significand bits
U_F32 = 2.0 ** -24
# standard deviations a rounded evaluation may lie from float64: a Gaussian's two-sided tail
# past 6σ is 2e-9 an element, ~5e-6 over the 2,560 elements of a smoke forward
LAMBDA = 6.0


def exact(t, kind, k=1):
    """``rnd`` that rounds nothing: the float64 model."""
    return t


class _Noisy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.save_for_backward(bwd)
        return t * fwd

    @staticmethod
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        return g * bwd, None, None


class Noise:
    """``rnd`` for one noisy run of ``model``'s roundings: "bf16" (the bf16
    sites at bf16's roundoff; an f32 site is 2^16 times finer and left
    exact) or "f32" (every site at f32's roundoff)."""

    def __init__(self, seed: int, model: str):
        self.gen = torch.Generator().manual_seed(seed)
        self.model = model

    def __call__(self, t, kind, k=1):
        if self.model == "bf16":
            if kind == "f32":
                return t
            a = U_BF16  # one rounding to bf16; its f32 sum before it is 2^16 times finer
        else:
            a = U_F32 * math.sqrt(k)  # the standard deviation of k independent roundings
        d = [(torch.rand(t.shape, generator=self.gen, dtype=torch.float64) * 2 - 1) * a + 1
             for _ in range(2)]
        return _Noisy.apply(t, *d) if t.requires_grad else t * d[0]


def params64(params) -> dict:
    """The port's parameter tree as float64 leaves (each leaf the value
    both models read: a bf16 leaf exactly, an f32 leaf exactly)."""
    if isinstance(params, dict):
        return {k: params64(v) for k, v in params.items()}
    return params.detach().double()


def _as(w, model):
    """A weight or an embedding row as a model reads it: cast to bf16 in
    the bf16 model (a rounding both sides make alike), as it is in the f32
    one."""
    return w.to(torch.bfloat16).double() if model == "bf16" else w


def _norm(x, scale, rnd, eps=1e-6):
    var = rnd((x * x).mean(dim=-1, keepdim=True), "f32", x.shape[-1])
    return rnd(rnd(x * torch.rsqrt(var + eps), "f32") * (1.0 + scale), "bf16")


def _rope(x, pos, theta, rnd):
    """x [..., n, dh] at positions ``pos`` (x's leading dims but n)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float64) / half)
    ang = pos.double()[..., None] * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return rnd(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1), "bf16", 2)


def _softmax_pv(cfg, q, k, v, mask, rnd):
    """Softmax attention of q [B, H, Q, dh] over k / v [B, H, K, dh] where
    ``mask`` [B or 1, 1, Q, K] holds: -> [B, H, Q, dh]."""
    s = rnd(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), "f32", q.shape[-1])
    if cfg.attn_softcap is not None:
        s = rnd(cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap), "f32")
    p = rnd(torch.softmax(torch.where(mask, s, -math.inf), dim=-1), "f32", k.shape[-2])
    return rnd(p @ v, "bf16", k.shape[-2])


def _heads(t, G):
    """[B, S, Kv, dh] -> [B, Kv·G, S, dh], kv head j serving query heads
    j·G .. j·G + G - 1."""
    return t.repeat_interleave(G, dim=2).transpose(1, 2)


def _attention(cfg, q, k, v, window, rnd):
    """Causal attention over the sequence: q [B, S, H, dh], k / v [B, S,
    Kv, dh] -> [B, S, H, dh]."""
    G, pos = q.shape[2] // k.shape[2], torch.arange(q.shape[1])
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)
    out = _softmax_pv(cfg, q.transpose(1, 2), _heads(k, G), _heads(v, G), mask, rnd)
    return out.transpose(1, 2)


def _silu(x, rnd):
    """``jax.nn.silu`` op by op, each op a rounding."""
    s = rnd(1 / rnd(1 + rnd(torch.exp(-x), "bf16"), "bf16"), "bf16")
    return rnd(x * s, "bf16")


def _moe(cfg, lp, x, rnd, model):
    """The capacity-routed top-k MoE of tokens ``x`` [T, D]: each expert
    takes its first C (token, choice) pairs in token order, a token's kept
    choices' outputs weighed by its normalised top-k gates and added."""
    m, (T, D) = cfg.moe, x.shape
    C = min(max(8, math.ceil(m.capacity_factor * T * m.top_k / m.n_experts)), T)
    gates = rnd(torch.softmax(rnd(x @ _as(lp["router"], model), "f32", D), -1), "f32",
                m.n_experts)
    topv, topi = (t[:, :m.top_k] for t in torch.sort(gates, dim=-1, descending=True, stable=True))
    w = _as(rnd(topv / topv.sum(-1, keepdim=True), "f32", m.top_k), model)
    hot = torch.nn.functional.one_hot(topi.reshape(-1), m.n_experts)  # pairs in token order
    keep = ((hot.cumsum(0) * hot).sum(-1) <= C).reshape(T, m.top_k)
    out = None
    for j in range(m.top_k):
        we = [lp[n][topi[:, j]] for n in ("we1", "we3", "we2")]  # each token's expert
        a = rnd(torch.einsum("td,tdf->tf", x, _as(we[0], model)), "bf16", D)
        b = rnd(torch.einsum("td,tdf->tf", x, _as(we[1], model)), "bf16", D)
        y = rnd(torch.einsum("tf,tfd->td", rnd(_silu(a, rnd) * b, "bf16"), _as(we[2], model)),
                "bf16", we[2].shape[1])
        y = rnd(y * (w[:, j] * keep[:, j])[:, None], "bf16")
        out = y if out is None else rnd(out + y, "bf16")
    return out


def _block(cfg, lp, x, pos, attend, rnd, model):
    """One layer of ``x`` [..., D] at positions ``pos`` [...]; ``attend(q,
    k, v)`` its attention ([..., n, dh] each, -> [..., H, dh]).  Returns
    (the layer's output, (k, v))."""
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = _norm(x, lp["attn_norm"], rnd)

    def proj(w, n):
        return rnd(h @ _as(w, model).reshape(D, n * dh), "bf16", D).reshape(*h.shape[:-1], n, dh)

    k, v = _rope(proj(lp["wk"], Kv), pos, cfg.rope_theta, rnd), proj(lp["wv"], Kv)
    o = attend(_rope(proj(lp["wq"], H), pos, cfg.rope_theta, rnd), k, v)
    attn = rnd(o.reshape(*o.shape[:-2], H * dh) @ _as(lp["wo"], model).reshape(H * dh, D),
               "bf16", H * dh)

    def ffn(h):
        if cfg.moe:
            return _moe(cfg, lp, h.reshape(-1, D), rnd, model).reshape(h.shape)
        a = rnd(h @ _as(lp["w1"], model), "bf16", D)
        b = rnd(h @ _as(lp["w3"], model), "bf16", D)
        return rnd(rnd(_silu(a, rnd) * b, "bf16") @ _as(lp["w2"], model), "bf16", cfg.d_ff)

    if cfg.parallel_residual:
        return rnd(rnd(x + attn, "bf16") + ffn(h), "bf16"), (k, v)
    h2 = _norm(rnd(x + attn, "f32"), lp["ffn_norm"], rnd)  # the norm reads the f32 sum
    return rnd(rnd(x + attn, "bf16") + ffn(h2), "bf16"), (k, v)


def _layers(cfg, p):
    """Each layer's parameters and whether it attends through the window."""
    for i in range(cfg.n_layers):
        local = cfg.window is not None and i % cfg.local_every != cfg.local_every - 1
        yield {n: w[i] for n, w in p["layers"].items()}, cfg.window if local else None


def forward64(cfg, p, tokens, rnd=exact, model="bf16", kv=None):
    """Token ids [B, S] -> final hidden states [B, S, D], float64, of the
    bf16 model (the port's and the reference's LM) or the f32 one (f32
    parameters and activations end to end); each layer's (k, v) [B, S, Kv,
    dh] appended to ``kv`` when given."""
    x = _as(p["embed"][tokens.long()], model)
    pos = torch.arange(tokens.shape[1])
    for lp, window in _layers(cfg, p):
        x, kv_l = _block(cfg, lp, x, pos,
                         lambda q, k, v: _attention(cfg, q, k, v, window, rnd), rnd, model)
        if kv is not None:
            kv.append(kv_l)
    return _norm(x, p["final_norm"], rnd)


def logits64(cfg, p, h, rnd=exact, model="bf16"):
    """The f32 unembedding of hidden states ``h`` [..., D], softcapped."""
    w = p["embed"].T if cfg.tie_embeddings else p["unembed"]
    logits = rnd(h @ _as(w, model), "f32", cfg.d_model)
    if cfg.final_softcap is not None:
        logits = rnd(cfg.final_softcap * torch.tanh(logits / cfg.final_softcap), "f32")
    return logits


def loss64(cfg, p, batch, rnd=exact, model="bf16"):
    """The next-token cross-entropy over labels >= 0, float64."""
    logits = logits64(cfg, p, forward64(cfg, p, batch["tokens"], rnd, model), rnd, model)
    labels = batch["labels"].long()
    lse = rnd(torch.logsumexp(logits, dim=-1), "f32", cfg.vocab)
    lab = torch.take_along_dim(logits, labels.clamp(min=0)[..., None], dim=-1)[..., 0]
    mask = labels >= 0
    return rnd(torch.where(mask, lse - lab, 0.0).sum(), "f32", mask.numel()) / mask.sum()


def prefill64(cfg, p, tokens, rnd=exact):
    """``transformer.prefill`` of the bf16 model: (the last position's
    logits [B, V], the cache {"k", "v"} [L, B, S, Kv, dh])."""
    kv = []
    h = forward64(cfg, p, tokens, rnd, "bf16", kv)
    return logits64(cfg, p, h[:, -1], rnd), {
        n: torch.stack([t[j] for t in kv]) for j, n in enumerate(("k", "v"))}


def decode64(cfg, p, cache, tokens_new, lengths, rnd=exact):
    """``transformer.decode_step`` of the bf16 model: one token a sequence
    at position ``lengths`` [B] against ``cache`` (as ``prefill64`` gives
    it, S slots), its k / v written there where that is below S; ->
    (logits [B, V], the new cache).  The new token attends to the slots
    below ``lengths + 1`` (the window's on a local layer), written or not."""
    cache = {n: c.clone() for n, c in cache.items()}
    S = cache["k"].shape[2]
    pos, b = lengths.long(), torch.arange(len(lengths))
    slot = torch.arange(S)[None, :]
    x = _as(p["embed"][tokens_new.long()], "bf16")
    for i, (lp, window) in enumerate(_layers(cfg, p)):
        kc, vc = cache["k"][i], cache["v"][i]

        def attend(q, k, v):
            ok = pos < S
            kc[b[ok], pos[ok]], vc[b[ok], pos[ok]] = k[ok], v[ok]
            mask = slot < (pos + 1)[:, None]
            if window is not None:
                mask = mask & (slot > pos[:, None] - window)
            G = q.shape[1] // kc.shape[2]
            out = _softmax_pv(cfg, q[:, :, None], _heads(kc, G), _heads(vc, G),
                              mask[:, None, None], rnd)
            return out[:, :, 0]

        x, _ = _block(cfg, lp, x, pos, attend, rnd, "bf16")
    return logits64(cfg, p, _norm(x, p["final_norm"], rnd), rnd), cache


def spread(fn, n: int, model: str) -> tuple:
    """``fn(rnd)`` noiseless and its standard deviation over ``n`` noisy
    runs (seeds 0 .. n-1) of ``model``'s roundings: each as ``fn``
    returns it (a tensor or a tuple of tensors), detached, as numpy."""
    def np_(out):
        out = out if isinstance(out, tuple) else (out,)
        return [o.detach().numpy() for o in out]

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # thousands of tiny ops: beside other processes a pool only spins
    try:
        base = np_(fn(exact))
        runs = [np_(fn(Noise(s, model))) for s in range(n)]
    finally:
        torch.set_num_threads(threads)
    sd = [np.sqrt(np.mean([(r[i] - base[i]) ** 2 for r in runs], axis=0)) for i in range(len(base))]
    return base, sd
