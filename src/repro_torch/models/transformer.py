"""Decoder-only transformer family covering the five LM archs.

One config dataclass expresses dense GQA (tinyllama, command-r-plus),
local/global alternating attention with logit softcaps (gemma2) and
top-k MoE (kimi-k2, olmoe), as the JAX package's
``repro.models.transformer`` does.  Parameters are a tree of tensors
stacked over layers (``params["layers"][name]`` is ``[L, ...]``, one
layer is ``params["layers"][name][i]``), held by :class:`Transformer` as
a module or passed to the functional entry points, which keep the JAX
signatures and run on the parameters' device.

This module holds ``forward``, ``unembed_logits``, ``loss_fn`` (its value
and, through autograd, its gradient, layers rematerialised as in the
reference), ``prefill`` and ``decode_step`` against a KV cache, with the
single-shard MoE, and the expert-parallel MoE ``moe_ffn_shmap`` on a
mesh of several devices.  The serving functions on such a mesh are in
``models/transformer_mesh.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.query import resolve_device
from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import Sharded, block_index, shard
from repro_torch.models import layers as L
from repro_torch.tree import build as _build, leaves as _leaves

Params = Any


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    moe: MoECfg | None = None
    window: int | None = None  # sliding window for local layers
    local_every: int = 2  # gemma2: alternate local/global when window set
    attn_softcap: float | None = None
    final_softcap: float | None = None
    parallel_residual: bool = False  # command-r style
    tie_embeddings: bool = False
    remat: bool = True  # the reference's per-layer rematerialisation (training)
    # attention chunking (flash-style)
    chunk_q: int = 512
    chunk_kv: int = 1024

    @property
    def n_params(self) -> int:
        """Total parameter count (dense equivalent; MoE counts all experts)."""
        D, H, Kv, dh, F_, V, Lz = (
            self.d_model, self.n_heads, self.n_kv_heads, self.d_head,
            self.d_ff, self.vocab, self.n_layers,
        )
        attn = D * H * dh + 2 * D * Kv * dh + H * dh * D
        if self.moe:
            ffn = D * self.moe.n_experts + 3 * self.moe.n_experts * D * self.moe.d_ff_expert
        else:
            ffn = 3 * D * F_
        emb = V * D * (1 if self.tie_embeddings else 2)
        return Lz * (attn + ffn + 2 * D) + emb + D

    @property
    def n_active_params(self) -> int:
        """Per-token active params (MoE: top-k experts only)."""
        if not self.moe:
            return self.n_params
        D, Lz = self.d_model, self.n_layers
        full_ffn = 3 * self.moe.n_experts * D * self.moe.d_ff_expert
        act_ffn = 3 * self.moe.top_k * D * self.moe.d_ff_expert
        return self.n_params - Lz * (full_ffn - act_ffn)


def local_flags(cfg: TransformerCfg) -> list[bool]:
    """Per layer, whether it attends through the sliding window (gemma2:
    every layer but each ``local_every``-th when a window is set)."""
    return [cfg.window is not None and i % cfg.local_every != cfg.local_every - 1
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# params: shapes, logical axes, init
# ---------------------------------------------------------------------------


# logical axes of each parameter: one layer's (stacked under "layers"), and the rest
LAYER_AXES: dict[str, tuple[str | None, ...]] = {
    "attn_norm": ("embed",),
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed_out"),
    "ffn_norm": ("embed",),
    "router": ("embed", None),
    "we1": ("experts", "embed", "ffn"),
    "we3": ("experts", "embed", "ffn"),
    "we2": ("experts", "ffn", "embed_out"),
    "w1": ("embed", "ffn"),
    "w3": ("embed", "ffn"),
    "w2": ("ffn", "embed_out"),
}
TOP_AXES: dict[str, tuple[str, ...]] = {
    "embed": ("vocab", "embed"), "unembed": ("embed", "vocab"), "final_norm": ("embed",)}


def _layer_shapes(cfg: TransformerCfg) -> dict[str, tuple[tuple[int, ...], tuple[str | None, ...]]]:
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    s = {"attn_norm": (D,), "wq": (D, H, dh), "wk": (D, Kv, dh), "wv": (D, Kv, dh),
         "wo": (H, dh, D), "ffn_norm": (D,)}
    if cfg.moe:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        s |= {"router": (D, E), "we1": (E, D, Fe), "we3": (E, D, Fe), "we2": (E, Fe, D)}
    else:
        s |= {"w1": (D, cfg.d_ff), "w3": (D, cfg.d_ff), "w2": (cfg.d_ff, D)}
    return {k: (shape, LAYER_AXES[k]) for k, shape in s.items()}


def param_specs(cfg: TransformerCfg, dtype=torch.float32) -> dict:
    """Every parameter as a ``meta``-device tensor (nothing allocated)."""
    def spec(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    p = {
        "embed": spec(cfg.vocab, cfg.d_model),
        "layers": {k: spec(cfg.n_layers, *shape) for k, (shape, _) in _layer_shapes(cfg).items()},
        "final_norm": spec(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = spec(cfg.d_model, cfg.vocab)
    return p


def logical_axes(cfg: TransformerCfg) -> dict:
    """Same tree as the params, leaves = logical axis-name tuples."""
    return param_axes(param_specs(cfg))


def param_axes(params: Params) -> dict:
    """The logical axes of a parameter tree, leaf for leaf, read from its
    names (:func:`logical_axes` of its config)."""
    return {k: ({n: ("layers", *LAYER_AXES[n]) for n in v} if k == "layers" else TOP_AXES[k])
            for k, v in params.items()}


def init(cfg: TransformerCfg, generator: torch.Generator, device="cuda",
         dtype=torch.float32) -> Params:
    """Random parameters by the reference's rule: a leaf of rank ≤ 1 (or
    last dim 1) is zeros, any other ``normal / sqrt(shape[-2])`` (for a
    stacked ``[L, D]`` norm that is ``L``, for ``[L, D, H, dh]`` it is
    ``H``: the reference's fan-in, kept).  The normals are drawn from
    ``generator`` on its own device, leaf by leaf in sorted-key order,
    and moved to ``device``; the values are not the JAX package's."""
    dev = resolve_device(device)

    def one(s: torch.Tensor) -> torch.Tensor:
        if s.dim() <= 1 or s.shape[-1] == 1:
            return torch.zeros(s.shape, dtype=dtype, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.div_(math.sqrt(int(s.shape[-2]))).to(dev, dtype)

    return _build((path, one(s)) for path, s in _leaves(param_specs(cfg, dtype)))


def _as_tensor(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a JAX array's numpy view: torch must own a copy
        a = a.copy()
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: no numpy twin in torch
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_arrays(cfg: TransformerCfg, tree: dict, device="cuda") -> Params:
    """The JAX package's parameter tree, given as numpy arrays (f32 or
    bfloat16), as the port's tensors on ``device``; every name and shape
    is checked against :func:`param_specs`."""
    dev = resolve_device(device)
    want = dict(_leaves(param_specs(cfg)))
    got = dict(_leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    out = []
    for path, s in want.items():
        t = _as_tensor(got[path], dev)
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, want {tuple(s.shape)}")
        out.append((path, t))
    return _build(out)


class Transformer(nn.Module):
    """A config's parameters as a module: ``embed``, ``final_norm``,
    ``unembed`` (untied configs) and ``layers.<name>`` stacked ``[L, ...]``
    under the JAX names.  ``params`` is the tree the functional entry
    points take; the methods call them.  The parameters need no gradient:
    this is the serving path."""

    def __init__(self, cfg: TransformerCfg, params: Params):
        super().__init__()
        self.cfg = cfg

        def keep(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = keep(params["embed"])
        self.final_norm = keep(params["final_norm"])
        self.unembed = None if cfg.tie_embeddings else keep(params["unembed"])
        self.layers = nn.ParameterDict({k: keep(v) for k, v in params["layers"].items()})

    @property
    def params(self) -> Params:
        p = {"embed": self.embed, "final_norm": self.final_norm, "layers": dict(self.layers)}
        if self.unembed is not None:
            p["unembed"] = self.unembed
        return p

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params, tokens)

    def prefill(self, tokens: torch.Tensor):
        return prefill(self.cfg, self.params, tokens)

    def decode_step(self, cache: dict, tokens_new: torch.Tensor, lengths: torch.Tensor):
        return decode_step(self.cfg, self.params, cache, tokens_new, lengths)


def _layer_params(params: Params, i: int) -> dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# MoE FFN: top-k, capacity-based sort dispatch (single shard)
# ---------------------------------------------------------------------------


def _moe_route(gates: torch.Tensor, E: int, K: int, C: int, e0: int = 0,
               e_count: int | None = None):
    """Sort-based capacity routing: :func:`_moe_dispatch_indices`' three
    index tensors and ``tab`` [T, K], each token's slots in ascending
    order, ``e_count·C`` (past the last slot) where its pair was dropped
    or went to a foreign expert."""
    T = gates.shape[0]
    e_count = e_count or E
    dev = gates.device
    vals, ranked = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :K], ranked[:, :K]
    total = topv[:, 0]
    for j in range(1, K):
        total = total + topv[:, j]
    topv = topv / torch.clamp(total, min=1e-9)[:, None]

    tok = torch.arange(T, dtype=torch.int32, device=dev).repeat_interleave(K)
    exp = topi.reshape(-1).to(torch.int32) - e0
    wgt = topv.reshape(-1)
    local = (exp >= 0) & (exp < e_count)
    exp = torch.where(local, exp, e_count)  # foreign experts sort to the tail
    order = torch.argsort(exp, stable=True)  # groups by expert, arrival order kept
    exp_s, tok_s, w_s = exp[order], tok[order], wgt[order]
    start = torch.searchsorted(exp_s, torch.arange(e_count, dtype=torch.int32, device=dev))
    rank = torch.arange(T * K, device=dev) - start[exp_s.clamp(max=e_count - 1)]
    keep = (rank < C) & (exp_s < e_count)
    slot = torch.where(keep, exp_s.long() * C + rank, e_count * C)  # overflow -> dropped

    z = e_count * C + 1
    idx = torch.zeros(z, dtype=torch.int32, device=dev).index_put_((slot,), tok_s)[:-1]
    wslot = torch.zeros(z, dtype=torch.float32, device=dev).index_put_((slot,), w_s)[:-1]
    valid = torch.zeros(z, dtype=torch.bool, device=dev).index_put_((slot,), keep)[:-1]
    tab = torch.empty(T * K, dtype=torch.long, device=dev).index_put_((order,), slot)
    return idx, wslot, valid, tab.view(T, K).sort(dim=1).values


def _moe_dispatch_indices(gates: torch.Tensor, E: int, K: int, C: int, e0: int = 0,
                          e_count: int | None = None):
    """Sort-based capacity routing -> gather/scatter index tensors.

    Returns (idx [E_loc·C] int32 token a slot, wslot [E_loc·C] f32 combine
    weight, valid [E_loc·C] bool), equal to the reference's for the same
    gates: the top K by a stable descending sort (the lower expert first
    on a tie, as ``lax.top_k``), the weights normalised by a left-to-right
    sum, a stable sort by expert, left-sided ``searchsorted``, pairs past
    capacity written to the extra slot ``e_count·C`` and sliced off; an
    empty slot keeps token 0 with weight 0.  ``e0`` / ``e_count`` restrict
    to a local expert range.
    """
    return _moe_route(gates, E, K, C, e0, e_count)[:3]


def _moe_expert_compute(lp, x2, idx, wslot, valid, E_loc: int, C: int, tab) -> torch.Tensor:
    """Gather -> per-expert gated MLP -> weighted combine (bf16).  The
    combine adds each token's slots (``tab``, from :func:`_moe_route`) one
    at a time in ascending slot order, rounding to bf16 after each add, as
    the reference's scatter-add does: one gather and K - 1 adds, no
    atomics, the same bits on every run.  The gather is an ``index_select``:
    its backward adds into each slot once (a slot belongs to one pair; only
    the zero row repeats, read by every dropped or, on a model shard,
    foreign pair, and its gradient is dropped), where advanced indexing's
    backward would sort and walk the zero row's run serially (3/4 of the
    pairs on each of four model shards)."""
    D = x2.shape[1]
    xe = (x2[idx.long()] * valid[:, None].to(x2.dtype)).reshape(E_loc, C, D)
    h = torch.bmm(xe, lp["we1"].to(x2.dtype))
    g = torch.bmm(xe, lp["we3"].to(x2.dtype))
    y = torch.bmm(L.silu(h) * g, lp["we2"].to(x2.dtype)).reshape(E_loc * C, D)
    contrib = torch.cat([y * (wslot * valid).to(x2.dtype)[:, None],
                         torch.zeros((1, D), dtype=x2.dtype, device=x2.device)])
    parts = contrib.index_select(0, tab.reshape(-1)).view(*tab.shape, D)  # [T, K, D]
    out = parts[:, 0]
    for r in range(1, tab.shape[1]):
        out = out + parts[:, r]
    return out


def moe_capacity(cfg: TransformerCfg, T: int) -> int:
    m = cfg.moe
    C = max(8, int(math.ceil(m.capacity_factor * T * m.top_k / m.n_experts)))
    return min(C, T)


def moe_gates(lp, x: torch.Tensor) -> torch.Tensor:
    """Router probabilities [T, E] in f32.  The logits are the bf16
    operands' product accumulated and kept in f32: the reference rounds
    the product to bf16 and casts it back to f32, a pair XLA folds away."""
    return torch.softmax(x.float() @ lp["router"].to(x.dtype).float(), dim=-1)


def moe_ffn(cfg: TransformerCfg, lp: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """x: [T, D] -> [T, D].  The single-shard path."""
    m = cfg.moe
    C = moe_capacity(cfg, x.shape[0])
    idx, wslot, valid, tab = _moe_route(moe_gates(lp, x), m.n_experts, m.top_k, C)
    return _moe_expert_compute(lp, x, idx, wslot, valid, m.n_experts, C, tab)


def moe_shmap_partials(cfg: TransformerCfg, router, we1, we3, we2, x2, mesh, e_axes) -> tuple:
    """The expert-parallel MoE over per-position values (``dist``'s
    layout) before its sum: ``x2`` each position's tokens [T_p, D] (bf16),
    ``router`` its router, ``we1`` / ``we3`` / ``we2`` its experts ``e0 ..
    e0 + E_loc - 1``, ``e0`` its block over ``e_axes`` times ``E_loc``.
    Each position routes its own T_p tokens (capacity from T_p) to its
    local experts, foreign experts sorted to the tail, runs them and
    combines; -> each position's share [T_p, D] of its tokens' output."""
    m = cfg.moe
    E_loc = we1[0].shape[0]
    e0s = [block_index(mesh, p, e_axes) * E_loc for p in range(len(mesh.devices))]
    gates = col.per_position(lambda x, r: moe_gates({"router": r}, x), mesh, x2, router)

    def local(x, g, w1, w3, w2, e0):
        C = moe_capacity(cfg, x.shape[0])
        idx, wslot, valid, tab = _moe_route(g, m.n_experts, m.top_k, C, e0, E_loc)
        return _moe_expert_compute({"we1": w1, "we3": w3, "we2": w2}, x, idx, wslot, valid,
                                   E_loc, C, tab)

    return col.per_position(local, mesh, x2, gates, we1, we3, we2, e0s)


def moe_shmap_parts(cfg: TransformerCfg, router, we1, we3, we2, x2, mesh, e_axes) -> tuple:
    """:func:`moe_shmap_partials` summed over ``e_axes``: each position's
    tokens' output [T_p, D]."""
    return col.psum(moe_shmap_partials(cfg, router, we1, we3, we2, x2, mesh, e_axes), mesh,
                    e_axes)


def moe_ffn_shmap(cfg: TransformerCfg, lp, x3: torch.Tensor, *, mesh, dp_axes,
                  model_axis: str = "model") -> torch.Tensor:
    """Expert-parallel MoE on ``mesh``, the reference's ``shard_map``
    layout: ``x3`` [B, S, D] split over the data axes ``dp_axes`` (those on
    the mesh), ``lp``'s experts (``we1`` / ``we3`` / ``we2``) over
    ``model_axis``, the router replicated (views on the tensors' own
    device).  Every model shard routes its data slice's tokens (capacity
    from the slice's token count) to its local experts and a sum over
    ``model_axis`` combines: with more than one data slice the dropped
    (token, expert) pairs differ from the single-shard :func:`moe_ffn`'s.
    Returns [B, S, D] on the mesh's lead device."""
    dp = tuple(a for a in dp_axes if a in mesh.shape)
    x_spec = (dp if len(dp) > 1 else (dp[0] if dp else None), None, None)
    xs = shard(x3, mesh, x_spec)
    w = {k: shard(lp[k], mesh, (None, None) if k == "router" else (model_axis, None, None)).parts
         for k in ("router", "we1", "we3", "we2")}
    x2 = col.per_position(lambda x: x.reshape(-1, x.shape[-1]), mesh, xs.parts)
    out = moe_shmap_parts(cfg, w["router"], w["we1"], w["we3"], w["we2"], x2, mesh,
                          (model_axis,))
    return Sharded(col.per_position(lambda o, x: o.reshape(x.shape), mesh, out, xs.parts),
                   mesh, x_spec).unshard()


# ---------------------------------------------------------------------------
# layer + full forward
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., D] · w [D, n, dh] -> [..., n, dh] in x's dtype."""
    D, n, dh = w.shape
    return (x @ w.reshape(D, n * dh).to(x.dtype)).reshape(*x.shape[:-1], n, dh)


def _attention(cfg, lp, x, positions, *, is_local: bool):
    """Full-sequence attention (prefill). Returns (out, (k, v)); a local
    layer attends through the window, any other globally."""
    q = L.rope(_proj(x, lp["wq"]), positions, cfg.rope_theta)
    k = L.rope(_proj(x, lp["wk"]), positions, cfg.rope_theta)
    v = _proj(x, lp["wv"])
    out = L.chunked_attention(
        q, k, v, causal=True, window=cfg.window if is_local else None,
        attn_softcap=cfg.attn_softcap, chunk_q=cfg.chunk_q, chunk_kv=cfg.chunk_kv,
    )
    H, dh, D = lp["wo"].shape
    out = out.reshape(*out.shape[:-2], H * dh) @ lp["wo"].reshape(H * dh, D).to(x.dtype)
    return out, (k, v)


def _ffn(cfg, lp, x):
    B, S, D = x.shape
    if cfg.moe:
        return moe_ffn(cfg, lp, x.reshape(B * S, D)).reshape(B, S, D)
    return L.swiglu(x, lp["w1"], lp["w3"], lp["w2"])


def _layer(cfg, lp, x, positions, is_local):
    """One block; returns (x, (k, v))."""
    h = L.rms_norm(x, lp["attn_norm"])
    attn, kv = _attention(cfg, lp, h, positions, is_local=is_local)
    if cfg.parallel_residual:
        return x + attn + _ffn(cfg, lp, h), kv
    return _ffn_residual(cfg, lp, x, attn), kv


def _ffn_residual(cfg, lp, x, attn):
    """x + attn, then its FFN added.  The FFN's norm reads the f32 sum, as
    the reference's fused add and norm do; the residual is rounded to bf16."""
    h2 = L.rms_norm(x.float() + attn.float(), lp["ffn_norm"]).to(x.dtype)
    return (x + attn) + _ffn(cfg, lp, h2)


def _embed(params, tokens):
    return params["embed"][tokens.long()].to(torch.bfloat16)


def _layer_list(params: Params) -> list[dict[str, torch.Tensor]]:
    """Every layer's parameters, one ``unbind`` a stacked leaf: under
    autograd each leaf's gradient is one stack of the layers' gradients."""
    names = list(params["layers"])
    return [dict(zip(names, lp)) for lp in zip(*(params["layers"][k].unbind(0) for k in names))]


def _train_layer(cfg, lp, x, positions, is_local):
    """One block's output; its k / v are not kept."""
    return _layer(cfg, lp, x, positions, is_local)[0]


def forward(cfg: TransformerCfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Token ids int[B, S] -> final hidden states [B, S, D] (bf16).  Under
    autograd with ``cfg.remat`` each layer is rematerialised in the
    backward (``torch.utils.checkpoint``, the reference's
    ``jax.checkpoint(nothing_saveable)``): only its input is kept."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for _, t in _leaves(params))
    for lp, is_local in zip(_layer_list(params), local_flags(cfg)):
        if remat:
            x = checkpoint(_train_layer, cfg, lp, x, positions, is_local, use_reentrant=False)
        else:
            x = _train_layer(cfg, lp, x, positions, is_local)
    return L.rms_norm(x, params["final_norm"])


def unembed_logits(cfg, params, h):
    """Logits [..., V] in f32: the bf16-cast unembedding and ``h`` upcast
    to f32 before the product (the reference accumulates it in f32)."""
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = h.float() @ w.to(h.dtype).float()
    return L.softcap(logits, cfg.final_softcap)


def loss_fn(cfg: TransformerCfg, params: Params, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy over labels >= 0, differentiable in the
    parameters; the row max is detached (the reference's
    ``stop_gradient``)."""
    tokens, labels = batch["tokens"], batch["labels"].long()
    logits = unembed_logits(cfg, params, forward(cfg, params, tokens))  # [B,S,V] f32
    lmax = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - lmax), dim=-1)) + lmax[..., 0]
    lab = torch.take_along_dim(logits, labels.clamp(min=0)[..., None], dim=-1)[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - lab, 0.0)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


class KVCache:
    """Layout helper: k/v stacked over layers, [L, B, S, Kv, dh] bf16."""

    @staticmethod
    def specs(cfg: TransformerCfg, batch: int, max_seq: int) -> dict:
        sh = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {k: torch.empty(sh, dtype=torch.bfloat16, device="meta") for k in ("k", "v")}

    @staticmethod
    def zeros(cfg: TransformerCfg, batch: int, max_seq: int, device="cuda") -> dict:
        dev = resolve_device(device)
        return {k: torch.zeros(s.shape, dtype=s.dtype, device=dev)
                for k, s in KVCache.specs(cfg, batch, max_seq).items()}


@torch.no_grad()
def prefill(cfg: TransformerCfg, params: Params, tokens: torch.Tensor):
    """Process a prompt int[B, S]; returns (last-position logits [B, V]
    f32, kv cache {"k", "v"} [L, B, S, Kv, dh] bf16)."""
    B, S = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    cache = {k: torch.empty(s.shape, dtype=s.dtype, device=x.device)
             for k, s in KVCache.specs(cfg, B, S).items()}
    for i, is_local in enumerate(local_flags(cfg)):
        x, (k, v) = _layer(cfg, _layer_params(params, i), x, positions, is_local)
        cache["k"][i], cache["v"][i] = k, v
    h = L.rms_norm(x[:, -1:, :], params["final_norm"])
    return unembed_logits(cfg, params, h)[:, 0], cache


def _write_at(c: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """c[b, pos[b]] = new[b] in place where 0 <= pos[b] < S; elsewhere
    nothing, as the reference's one-hot write leaves such a cache."""
    S = c.shape[1]
    ok = ((pos >= 0) & (pos < S))[:, None, None]
    at = pos.clamp(0, S - 1).long()
    b = torch.arange(c.shape[0], device=c.device)
    c[b, at] = torch.where(ok, new.to(c.dtype), c[b, at])


def _decode_layer(cfg, lp, x, kc, vc, pos, is_local: bool):
    """One block of a decode step: x [B, D] (bf16) at positions ``pos``
    [B] against one layer's cache ``kc`` / ``vc`` [B, S, Kv, dh], into
    which the new k/v are written in place; returns the block's output."""
    h = L.rms_norm(x, lp["attn_norm"])
    q = L.rope(_proj(h, lp["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    k = L.rope(_proj(h, lp["wk"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    _write_at(kc, pos, k)
    _write_at(vc, pos, _proj(h, lp["wv"]))
    attn = L.decode_attention(
        q, kc, vc, length=pos + 1, window=cfg.window,
        is_local=is_local if cfg.window is not None else None,
        attn_softcap=cfg.attn_softcap,
    )
    H, dh, D = lp["wo"].shape
    attn = attn.reshape(-1, H * dh) @ lp["wo"].reshape(H * dh, D).to(h.dtype)
    if cfg.parallel_residual:
        return x + attn + _ffn(cfg, lp, h[:, None, :])[:, 0]
    return _ffn_residual(cfg, lp, x[:, None, :], attn[:, None, :])[:, 0]


@torch.no_grad()
def decode_step(cfg: TransformerCfg, params: Params, cache: dict, tokens_new: torch.Tensor,
                lengths: torch.Tensor):
    """One autoregressive step against a [L, B, S, Kv, dh] cache, linear
    in S: ``tokens_new`` int[B], ``lengths`` int[B] the current fill (the
    new token's position).  Returns (logits [B, V] f32, cache); the new
    k/v are written into ``cache`` in place (the reference's program
    donates it) at ``lengths``, nowhere if that is outside the cache."""
    x = _embed(params, tokens_new)  # [B, D]
    pos = lengths.to(torch.int32)
    for i, is_local in enumerate(local_flags(cfg)):
        x = _decode_layer(cfg, _layer_params(params, i), x, cache["k"][i], cache["v"][i], pos,
                          is_local)
    h = L.rms_norm(x, params["final_norm"])
    return unembed_logits(cfg, params, h[:, None, :])[:, 0], cache
