"""Shared neural-net layers, as plain functions on torch tensors.

Each function runs on the device of its inputs.  The conventions are the
JAX package's (``repro.models.layers``):

  * activations bf16, parameters f32 masters cast to bf16 at use;
  * attention is **chunked online-softmax** over KV blocks, so the S×S
    score matrix is never materialised;
  * GQA: q heads H grouped over Kv kv-heads (H % Kv == 0), head h in
    group h // (H / Kv);
  * optional logit soft-capping (gemma2) and sliding-window masks.

Products that the reference accumulates into f32 from bf16 operands
(``preferred_element_type=float32``: the attention scores, the
probability-value product and, in ``transformer.py``, the unembedding)
upcast their bf16 operands to f32 before a plain f32 product here, which
is exact for the operands and accumulates in f32 on the CPU and on the
card alike.  Every other product (projections, MLPs, experts) is a bf16
product with a bf16 result, as in the reference.  The activations
(:func:`silu`, :func:`gelu`) are the reference's formulas op by op in the
input's dtype, each op rounded as XLA rounds it, rather than torch's fused
versions, which round once.

The flash backward is the reference's custom VJP (``_flash_vjp_bwd``),
a :class:`torch.autograd.Function` that recomputes each block's
probabilities from the saved log-sum-exp.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEG_INF = -1e30  # a finite mask value: a wholly masked row stays NaN-free


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32, scaled by ``1 + scale``; the result in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split form.  x: [..., S, n, dh] (dh even),
    positions: [..., S]."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# chunked (flash-style) attention, shape-bounded memory
# ---------------------------------------------------------------------------


def _attn_mask(qp, kp, kv_len, causal, window):
    """[cq, ckv] validity mask from absolute positions."""
    m = kp[None, :] < kv_len
    if causal:
        m = m & (kp[None, :] <= qp[:, None])
    if window is not None:
        m = m & (kp[None, :] > qp[:, None] - window)
    return m


def _block_kind(q0, q1, k0, k1, kv_len, causal, window) -> str:
    """Whether the mask of query rows [q0, q1] against keys [k0, k1] is
    all false ("empty"), all true ("full") or mixed ("partial")."""
    lo = k0 if window is None else max(k0, q0 - window + 1)
    hi = min(k1, kv_len - 1, q1 if causal else k1)
    if lo > hi:
        return "empty"
    full = (k1 < kv_len and (not causal or k1 <= q0)
            and (window is None or k0 > q1 - window))
    return "full" if full else "partial"


def _blocks(Sq, Skv, chunk_q, chunk_kv, causal, window):
    """Every block of query rows [q0, q1] against keys [k0, k1] whose mask
    is not all false, as (q0, q1, k0, k1, kind): query chunks outer, key
    chunks inner, each in the reference's order.  The last chunks are
    short where the reference pads."""
    out = []
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq) - 1
        for k0 in range(0, Skv, chunk_kv):
            k1 = min(k0 + chunk_kv, Skv) - 1
            kind = _block_kind(q0, q1, k0, k1, Skv, causal, window)
            if kind != "empty":
                out.append((q0, q1, k0, k1, kind))
    return out


class _Geom(NamedTuple):
    """The static arguments of a flash call."""

    G: int  # query heads a kv head
    Sq: int
    Skv: int
    causal: bool
    window: int | None
    cap: float | None  # the attention softcap
    scale: float
    chunk_q: int
    chunk_kv: int


def _scores(qc, kc, g: _Geom, q0, q1, k0, k1, kind, pos):
    """One block's scores [B, Kv, rows, keys] in f32 (softcapped, masked
    to ``NEG_INF`` in a partial block) and the mask, None in a full one."""
    s = torch.matmul(qc, kc.transpose(-1, -2)) * g.scale
    s = softcap(s, g.cap)
    if kind == "full":
        return s, None
    mask = _attn_mask(pos[q0:q1 + 1], pos[k0:k1 + 1], g.Skv, g.causal,
                      g.window).repeat_interleave(g.G, dim=0)
    return torch.where(mask, s, NEG_INF), mask


def _flash_fwd(qh, kh, vh, g: _Geom, with_lse: bool):
    """The online softmax of the reference's ``_flash_fwd_impl`` over the
    ``[B, Kv, S·G, dh]`` query layout; -> (out f32, lse f32 [B, Kv, S·G]
    or None)."""
    B, Kv, _, dh = qh.shape
    dev = qh.device
    kf, vf = kh.float(), vh.float()
    pos = torch.arange(max(g.Sq, g.Skv), device=dev)
    out = torch.empty(B, Kv, g.Sq * g.G, dh, dtype=torch.float32, device=dev)
    lse = torch.empty(B, Kv, g.Sq * g.G, dtype=torch.float32, device=dev) if with_lse else None
    blocks = _blocks(g.Sq, g.Skv, g.chunk_q, g.chunk_kv, g.causal, g.window)
    for q0 in range(0, g.Sq, g.chunk_q):
        q1 = min(q0 + g.chunk_q, g.Sq) - 1
        rows = slice(q0 * g.G, (q1 + 1) * g.G)
        qc = qh[:, :, rows].float()
        n = qc.shape[2]
        m = torch.full((B, Kv, n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kv, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kv, n, dh), dtype=torch.float32, device=dev)
        for _, _, k0, k1, kind in (b for b in blocks if b[0] == q0):
            s, _ = _scores(qc, kf[:, :, k0:k1 + 1], g, q0, q1, k0, k1, kind, pos)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vf[:, :, k0:k1 + 1])
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
        if with_lse:
            lse[:, :, rows] = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def _ds(s, mask, lsec, doc, vc, dlt, g: _Geom):
    """The recomputed probabilities p = exp(s - lse) of one block and the
    scores' cotangent ds = p·(do·vᵀ - delta)·dcap·scale, dcap = 1 - (s/cap)²
    (0 where masked) the softcap's derivative."""
    p = torch.exp(s - lsec[..., None])
    dp = torch.matmul(doc, vc.transpose(-1, -2))
    ds = p * (dp - dlt[..., None])
    if g.cap is not None:  # without a cap dcap is 1 (a masked p is exactly 0)
        dcap = 1.0 - (s / g.cap) ** 2
        ds = ds * (dcap if mask is None else torch.where(mask, dcap, 0.0))
    return p, ds * g.scale


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom VJP (``_flash_vjp_fwd``
    / ``_flash_vjp_bwd``): the forward keeps each row's log-sum-exp, the
    backward recomputes every block's probabilities from it in two sweeps
    (dq, then dk / dv), in f32 on upcast operands.  No probability is
    stored: memory stays O(B·S·H·dh).  It skips and masks the blocks the
    forward skips and masks; a skipped block adds exactly 0 in the
    reference too (p and dcap are 0 there)."""

    @staticmethod
    def forward(ctx, qh, kh, vh, g: _Geom):
        out, lse = _flash_fwd(qh, kh, vh, g, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.g = g
        return out

    @staticmethod
    def backward(ctx, do):
        qh, kh, vh, out, lse = ctx.saved_tensors
        g = ctx.g
        B, Kv, _, dh = qh.shape
        dev = qh.device
        do = do.float().contiguous()
        delta = (do * out).sum(dim=-1)  # [B, Kv, S·G]
        kf, vf = kh.float(), vh.float()
        pos = torch.arange(max(g.Sq, g.Skv), device=dev)
        blocks = _blocks(g.Sq, g.Skv, g.chunk_q, g.chunk_kv, g.causal, g.window)

        def rows_of(q0, q1):
            r = slice(q0 * g.G, (q1 + 1) * g.G)
            return qh[:, :, r].float(), lse[:, :, r], do[:, :, r], delta[:, :, r], r

        dq = torch.zeros(B, Kv, g.Sq * g.G, dh, dtype=torch.float32, device=dev)
        for q0 in range(0, g.Sq, g.chunk_q):
            q1 = min(q0 + g.chunk_q, g.Sq) - 1
            qc, lsec, doc, dlt, r = rows_of(q0, q1)
            acc = torch.zeros_like(qc)
            for _, _, k0, k1, kind in (b for b in blocks if b[0] == q0):
                kc = kf[:, :, k0:k1 + 1]
                s, mask = _scores(qc, kc, g, q0, q1, k0, k1, kind, pos)
                _, ds = _ds(s, mask, lsec, doc, vf[:, :, k0:k1 + 1], dlt, g)
                acc = acc + torch.matmul(ds, kc)
            dq[:, :, r] = acc
        dk = torch.zeros(B, Kv, g.Skv, dh, dtype=torch.float32, device=dev)
        dv = torch.zeros_like(dk)
        for k0 in range(0, g.Skv, g.chunk_kv):
            k1 = min(k0 + g.chunk_kv, g.Skv) - 1
            kc, vc = kf[:, :, k0:k1 + 1], vf[:, :, k0:k1 + 1]
            dk_acc, dv_acc = torch.zeros_like(kc), torch.zeros_like(vc)
            for q0, q1, _, _, kind in (b for b in blocks if b[2] == k0):
                qc, lsec, doc, dlt, _ = rows_of(q0, q1)
                s, mask = _scores(qc, kc, g, q0, q1, k0, k1, kind, pos)
                p, ds = _ds(s, mask, lsec, doc, vc, dlt, g)
                dv_acc = dv_acc + torch.matmul(p.transpose(-1, -2), doc)
                dk_acc = dk_acc + torch.matmul(ds.transpose(-1, -2), qc)
            dk[:, :, k0:k1 + 1], dv[:, :, k0:k1 + 1] = dk_acc, dv_acc
        return dq.to(qh.dtype), dk.to(kh.dtype), dv.to(vh.dtype), None


def chunked_attention(
    q: torch.Tensor,  # [B, Sq, H, dh]
    k: torch.Tensor,  # [B, Skv, Kv, dh]
    v: torch.Tensor,  # [B, Skv, Kv, dh]
    *,
    causal: bool,
    q_offset: int = 0,  # full-sequence paths use 0
    window: int | None = None,  # sliding-window size (None = global)
    attn_softcap: float | None = None,
    chunk_q: int = 512,
    chunk_kv: int = 1024,
) -> torch.Tensor:
    """Flash-style attention: the online softmax of the reference's
    ``_flash_fwd_impl`` over ``chunk_q`` × ``chunk_kv`` blocks; the result
    in bf16.  Where a gradient is needed it runs through :class:`_Flash`,
    whose backward is the reference's custom VJP; otherwise the forward
    alone, the same values.

    Each query row sees the key chunks in the reference's order.  A block
    whose mask is all false is skipped: in the reference it either adds
    exactly 0 under a correction of exactly 1 (the row has a finite max)
    or leaves ``exp(0)`` terms that the row's first unmasked chunk
    multiplies by ``exp(-1e30 - m) = 0``; a block whose mask is all true
    is not masked.  The last chunks are short where the reference pads
    (padded keys are masked, padded query rows dropped), so neither adds
    a term.
    """
    if q_offset != 0:
        raise ValueError("the full-sequence path expects q_offset 0 (decode is separate)")
    B, Sq, H, dh = q.shape
    _, Skv, Kv, _ = k.shape
    G = H // Kv
    g = _Geom(G, Sq, Skv, causal, window, attn_softcap, 1.0 / math.sqrt(dh),
              min(chunk_q, max(Sq, 1)), min(chunk_kv, max(Skv, 1)))
    # [B, Kv, S·G, dh]: row s·G + g is query s of head (kv, g)
    qh = q.reshape(B, Sq, Kv, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Kv, Sq * G, dh)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)  # [B, Kv, Skv, dh]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _Flash.apply(qh, kh, vh, g)
    else:
        out = _flash_fwd(qh, kh, vh, g, with_lse=False)[0]
    out = out.reshape(B, Kv, Sq, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Sq, H, dh)
    return out.to(torch.bfloat16)


def decode_attention(
    q: torch.Tensor,  # [B, H, dh]: one new token a sequence
    k_cache: torch.Tensor,  # [B, S, Kv, dh]
    v_cache: torch.Tensor,  # [B, S, Kv, dh]
    *,
    length,  # [B] tensor, a scalar tensor or an int: valid cache positions
    window: int | None = None,
    is_local=None,  # bool or bool tensor: apply the window or not
    attn_softcap: float | None = None,
) -> torch.Tensor:
    """Single-token attention, linear in S: scores and probabilities in
    f32 against the bf16 cache upcast a layer at a time, the window under
    the ``is_local`` flag; the result in bf16."""
    B, H, dh = q.shape
    _, S, Kv, _ = k_cache.shape
    G = H // Kv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, Kv, G, dh).float()
    s = torch.matmul(qg, k_cache.permute(0, 2, 3, 1).float()) * scale  # [B, Kv, G, S]
    s = softcap(s, attn_softcap)
    pos = torch.arange(S, device=q.device)[None, None, None, :]
    ln = torch.as_tensor(length, device=q.device)
    ln = ln[:, None, None, None] if ln.dim() else ln
    mask = pos < ln
    if window is not None:
        win_mask = pos > ln - 1 - window
        if is_local is not None:
            win_mask = win_mask | ~torch.as_tensor(is_local, device=q.device)
        mask = mask & win_mask
    s = torch.where(mask, s, NEG_INF)
    # p stays f32, as in the reference
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v_cache.permute(0, 2, 1, 3).float())  # [B, Kv, G, dh]
    return out.reshape(B, H, dh).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` = x · logistic(x), logistic op by op as XLA expands
    it, 1 / (1 + exp(-x)), each op rounded to x's dtype.  The backward is
    the reference's: the product's two terms plus logistic's derivative
    rule ``ans · (1 - ans)``, ct·s + (ct·x)·(s·(1 - s)), each op rounded
    to x's dtype (autograd through the expansion rounds differently)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        return ct * s + (ct * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · 1 / (1 + exp(-x)), each op rounded to x's dtype."""
    return _Silu.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation, its default), op by op in x's
    dtype with the constants rounded to it first."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    cdf = c(0.5) * (1 + torch.tanh(c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * x * x))))
    return x * cdf


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Gated-SiLU MLP: (silu(x·w1) ⊙ (x·w3)) · w2."""
    h = silu(x @ w1.to(x.dtype)) * (x @ w3.to(x.dtype))
    return h @ w2.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    return gelu(x @ w1.to(x.dtype)) @ w2.to(x.dtype)


def mlp_stack(x: torch.Tensor, ws: list[torch.Tensor], bs: list[torch.Tensor]) -> torch.Tensor:
    """Plain relu MLP (recsys / GNN blocks)."""
    for i, (w, b) in enumerate(zip(ws, bs)):
        x = x @ w.to(x.dtype) + b.to(x.dtype)
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x
