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

The flash backward (the reference's custom VJP) is not here: these are
the serving forward passes.
"""

from __future__ import annotations

import math

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
    """Flash-style attention forward: the online softmax of the
    reference's ``_flash_fwd_impl`` over ``chunk_q`` × ``chunk_kv`` blocks;
    the result in bf16.

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
    scale = 1.0 / math.sqrt(dh)
    chunk_q = min(chunk_q, max(Sq, 1))
    chunk_kv = min(chunk_kv, max(Skv, 1))
    dev = q.device
    # [B, Kv, S·G, dh]: row s·G + g is query s of head (kv, g)
    qh = q.reshape(B, Sq, Kv, G, dh).permute(0, 2, 1, 3, 4).reshape(B, Kv, Sq * G, dh)
    kh = k.permute(0, 2, 1, 3).float()  # [B, Kv, Skv, dh]
    vh = v.permute(0, 2, 1, 3).float()
    pos = torch.arange(max(Sq, Skv), device=dev)
    out = torch.empty(B, Kv, Sq * G, dh, dtype=torch.float32, device=dev)
    for q0 in range(0, Sq, chunk_q):
        q1 = min(q0 + chunk_q, Sq) - 1
        rows = slice(q0 * G, (q1 + 1) * G)
        qc = qh[:, :, rows].float()
        n = qc.shape[2]
        m = torch.full((B, Kv, n), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kv, n), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kv, n, dh), dtype=torch.float32, device=dev)
        for k0 in range(0, Skv, chunk_kv):
            k1 = min(k0 + chunk_kv, Skv) - 1
            kind = _block_kind(q0, q1, k0, k1, Skv, causal, window)
            if kind == "empty":
                continue
            s = torch.matmul(qc, kh[:, :, k0:k1 + 1].transpose(-1, -2)) * scale
            s = softcap(s, attn_softcap)
            if kind == "partial":
                mask = _attn_mask(pos[q0:q1 + 1], pos[k0:k1 + 1], Skv, causal, window)
                s = torch.where(mask.repeat_interleave(G, dim=0), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vh[:, :, k0:k1 + 1])
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · 1 / (1 + exp(-x)), each op rounded to x's dtype."""
    return x * (1 / (1 + torch.exp(-x)))


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
