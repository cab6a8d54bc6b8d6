"""The transformer's serving and training functions on a mesh of several
devices.

``forward``, ``prefill``, ``decode_step`` and ``loss_fn`` take the
parameters, tokens, labels, lengths and cache as
:class:`~repro_torch.dist.sharding.Sharded` values
laid out by ``dist.sharding.spec_for`` (the JAX program builder's
``in_shardings``: ``launch.programs.shard_params`` / ``lm_inputs``) and
run each mesh position's share on its device, one process driving every
position (``dist.collectives``).  The values are those of the
single-device functions in ``transformer.py`` up to the order of sums;
the layout is the reference's:

* the batch rows split over the data axes; the residual stream [B, S, D]
  laid out as the reference's sequence-parallel constraint lays it out,
  ``spec_for(("batch", "seq_sp", None))`` under the program's rules: where
  that splits S over some axes (``"seq_sp"`` -> ``"model"`` by default),
  each position holds its S block [B_p, S/m, D] (the norms run on the
  block, the block is all-gathered over S before the q / k / v, w1 / w3 and
  expert products, and the sums after wo, w2 and the experts are
  reduce-scatters); where it does not (S does not divide, the rule is None,
  decode's S = 1), the block is all of S.  The values are the whole
  residual's bit for bit (the norms are per token and each element's sum is
  the same ordered ``sum_in_order``);
* ``heads`` (wq, wo), ``kv_heads`` (wk, wv), ``ffn`` (w1, w3, w2),
  ``experts`` (we1, we3, we2) and ``vocab`` (embed, unembed) split over
  the model axis where they divide, each position computing its share;
  sums over that axis after wo, w2 and the experts (bf16 partials summed
  in f32 and rounded once).  Query heads read kv head ``h // G`` at their
  global index ``h``, a replicated wk / wv included;
* the embedding a masked take from each vocab block plus a sum; the last
  position's logits gathered over the vocab blocks and the batch into
  ``[B, V]`` on the mesh's lead device, the final softcap after;
* prefill's MoE is ``moe_ffn_shmap``'s (capacity from each data slice's
  tokens); decode's routes globally, as the reference's ``decode_step``
  does (it passes no ``moe_ctx``): every data slice's tokens gathered,
  capacity from the whole batch, each model shard its local experts;
* decode against a cache split over batch, S (``kv_seq``) and kv heads by
  its spec: the new k / v written only where a position's S block holds
  its position, attention partials (max, sum, weighted v) over each S
  block at absolute positions combined by log-sum-exp over the ``kv_seq``
  axes (``layers.decode_attention_partial``).

Under autograd the wire count (``dist.collectives``) follows the rule of
that module: a value every position of a model group holds alike (the
whole residual's normed input, an S-gathered normed block, the final normed
rows) read by products whose weights split over the group's axes has its
gradient summed over the group (``collectives.replicated``: an all-reduce
over the readers' axes that the S gather's reduce-scatter does not already
cover), and a whole value cut into S blocks (the embedding rows, a sum that
falls back to ``psum``) has its gradient assembled from them
(``collectives.split``: an all-gather).  The sums themselves are autograd's,
as before: no value changes.
"""

from __future__ import annotations

import torch

from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.dist.sharding import Sharded, axes_of, block_index
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import layers as L, transformer as tfm

KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
# the one dimension each parameter may split over (layer tensors stacked [L, ...])
SPLIT_DIM = {"embed": 0, "unembed": 1, "wq": 2, "wk": 2, "wv": 2, "wo": 1, "w1": 2, "w3": 2,
             "w2": 1, "we1": 1, "we3": 1, "we2": 1}


_pp = col.per_position


def _starts(mesh, axes, size: int) -> list[int]:
    """Each position's first index of a dimension split over ``axes`` into
    blocks of ``size``."""
    return [block_index(mesh, p, axes) * size for p in range(len(mesh.devices))]


def _index(parts, i: int) -> tuple:
    """``part[i]`` of each position, one view a distinct part."""
    memo: dict = {}
    return tuple(memo[id(p)] if id(p) in memo else memo.setdefault(id(p), p[i]) for p in parts)


def _axes(params) -> dict[str, tuple]:
    """The mesh axes of each split dimension, checked against the layout
    these functions run: every other dimension replicated, wq / wo and
    w1 / w3 / w2 (or we1 / we3 / we2) alike."""
    lay = params["layers"]
    top = [(k, v) for k, v in params.items() if k != "layers"]
    for name, s in top + list(lay.items()):
        for d, e in enumerate(s.spec):
            if e is not None and d != SPLIT_DIM.get(name):
                raise ValueError(f"{name} is split over {e} on dimension {d}: the mesh programs "
                                 f"split it only on dimension {SPLIT_DIM.get(name)}")
    ax = {"heads": axes_of(lay["wq"].spec[2]), "kv": axes_of(lay["wk"].spec[2]),
          "vocab": axes_of(params["embed"].spec[0])}
    pairs = [("wo", 1, "heads"), ("wv", 2, "kv")]
    if "we1" in lay:
        ax["experts"] = axes_of(lay["we1"].spec[1])
        pairs += [("we3", 1, "experts"), ("we2", 1, "experts")]
    else:
        ax["ffn"] = axes_of(lay["w1"].spec[2])
        pairs += [("w3", 2, "ffn"), ("w2", 1, "ffn")]
    for name, d, key in pairs:
        if axes_of(lay[name].spec[d]) != ax[key]:
            raise ValueError(f"{name} splits over {lay[name].spec[d]}, its partner over {ax[key]}")
    return ax


def _layer(params, i: int) -> dict[str, tuple]:
    return {k: _index(v.parts, i) for k, v in params["layers"].items()}


def seq_entry(mesh, shape, rules):
    """The spec entry of the residual stream's S: the reference's
    constraint ``spec_for(("batch", "seq_sp", None), (B, S, D))`` under
    ``rules`` (None: S whole)."""
    return shd.spec_for(mesh, ("batch", "seq_sp", None), shape, rules)[1]


def _scatter(parts, mesh, sum_axes, seq_axes) -> tuple:
    """Partials [B_p, S, D] summed over ``sum_axes``, each position given
    its S block over ``seq_axes``: a reduce-scatter where the two are the
    same axes, else a sum and a block."""
    if sum_axes == seq_axes:
        return col.reduce_scatter(parts, mesh, seq_axes, 1)
    return col.split(col.psum(parts, mesh, sum_axes), mesh, seq_axes, 1)


def _embed(table: Sharded, tokens, mesh) -> tuple:
    """Rows of ``tokens`` (any shape, each position its own) in bf16: a
    masked take from each position's vocab block, summed over the vocab
    axes (one nonzero term: exact)."""
    vax = axes_of(table.spec[0])
    V_loc = table.parts[0].shape[0]

    def take(t, tok, v0):
        local = tok.long() - v0
        ok = (local >= 0) & (local < V_loc)
        return torch.where(ok[..., None], t[local.clamp(0, V_loc - 1)], 0)

    rows = col.psum(_pp(take, mesh, table.parts, tokens, _starts(mesh, vax, V_loc)), mesh, vax)
    return _pp(lambda r: r.to(torch.bfloat16), mesh, rows)


def _logits(cfg, params, h, mesh, batch_entry) -> torch.Tensor:
    """f32 logits [B, V] on the lead device of final-normed ``h`` (each
    position's rows [B_p, D]): each vocab block's product, gathered, then
    the final softcap."""
    w, entry = _vocab_weight(cfg, params, mesh)
    parts = _pp(lambda h, w: h.float() @ w.to(h.dtype).float(), mesh, h, w)
    return L.softcap(Sharded(parts, mesh, (batch_entry, entry)).unshard(), cfg.final_softcap)


def _kv_select(h0: int, n: int, G: int, k0: int, n_kv: int):
    """The kv heads that query heads ``h0 .. h0 + n - 1`` read (global
    head h reads kv head h // G), as a function of a block ``[..., n_kv,
    dh]`` of kv heads ``k0 ..``: a slice where the heads group evenly, else
    one kv head a query head."""
    idx = [h // G - k0 for h in range(h0, h0 + n)]
    if idx[0] < 0 or idx[-1] >= n_kv:
        raise ValueError(f"query heads {h0}..{h0 + n - 1} read kv heads outside the block")
    lo, hi = idx[0], idx[-1] + 1
    if idx == [lo + t * (hi - lo) // n for t in range(n)]:
        return lambda t: t[..., lo:hi, :]
    return lambda t: t[..., idx, :]


def _ffn(cfg, lp, h2, mesh, ax, route_axes=None) -> tuple:
    """The FFN of each position's tokens ``h2`` [B_p, S, D] (all of S),
    summed over the model axis, each position given its S block over
    ``ax["seq"]``.  MoE: each position routes its data slice's tokens
    (``moe_ffn_shmap``), or with ``route_axes`` (decode: S whole) every
    data slice's tokens gathered over those axes (the global routing of a
    decode step)."""
    if not cfg.moe:
        part = _pp(L.swiglu, mesh, h2, lp["w1"], lp["w3"], lp["w2"])
        return _scatter(part, mesh, ax["ffn"], ax["seq"])
    D = cfg.d_model
    x2 = _pp(lambda x: x.reshape(-1, D), mesh, h2)
    if route_axes:
        n = x2[0].shape[0]
        x2 = col.all_gather(x2, mesh, route_axes, 0)
        out = tfm.moe_shmap_parts(cfg, lp["router"], lp["we1"], lp["we3"], lp["we2"], x2, mesh,
                                  ax["experts"])
        out = _pp(lambda o, r0: o[r0:r0 + n], mesh, out, _starts(mesh, route_axes, n))
        return _pp(lambda o, x: o.reshape(x.shape), mesh, out, h2)
    part = tfm.moe_shmap_partials(cfg, lp["router"], lp["we1"], lp["we3"], lp["we2"], x2, mesh,
                                  ax["experts"])
    part = _pp(lambda o, x: o.reshape(x.shape), mesh, part, h2)
    return _scatter(part, mesh, ax["experts"], ax["seq"])


def _residual(cfg, lp, x, h, attn, mesh, ax, route_axes=None) -> tuple:
    """The block's output (each position's S block) from its input block
    ``x``, its normed input ``h`` gathered over S and the attention
    output's block, as ``transformer._layer`` / ``_ffn_residual``."""
    if cfg.parallel_residual:
        f = _ffn(cfg, lp, h, mesh, ax, route_axes)
        return _pp(lambda x, a, f: x + a + f, mesh, x, attn, f)
    res = _pp(lambda x, a: x + a, mesh, x, attn)
    h2 = _pp(lambda x, a, n: L.rms_norm(x.float() + a.float(), n).to(x.dtype), mesh, x, attn,
             lp["ffn_norm"])
    f = _ffn(cfg, lp, _read_by(col.all_gather(h2, mesh, ax["seq"], 1), mesh, ax,
                               _ffn_axes(cfg, ax)), mesh, ax, route_axes)
    return _pp(lambda r, f: r + f, mesh, res, f)


def _ffn_axes(cfg, ax) -> tuple:
    """The axes the FFN's weights split over."""
    return ax["experts"] if cfg.moe else ax["ffn"]


def _attn_axes(cfg, ax) -> tuple:
    """The axes the weights reading a block's normed input split over: the
    attention's, and with a parallel residual the FFN's too."""
    axes = ax["heads"] + ax["kv"] + (_ffn_axes(cfg, ax) if cfg.parallel_residual else ())
    return tuple(dict.fromkeys(axes))


def _read_by(h, mesh, ax, axes) -> tuple:
    """``h`` (gathered over S) handed to products split over ``axes``: its
    gradient summed over those of them the S gather's backward does not
    sum (``collectives.replicated``)."""
    return col.replicated(h, mesh, tuple(a for a in axes if a not in ax["seq"]))


def _normed(x, scale, mesh, ax, readers) -> tuple:
    """RMS norm of each position's block ``x``, gathered over S, read by
    products split over ``readers``."""
    return _read_by(col.all_gather(_pp(L.rms_norm, mesh, x, scale), mesh, ax["seq"], 1), mesh,
                    ax, readers)


def _attention(cfg, lp, h, positions, is_local: bool, mesh, ax):
    """Full-sequence attention of each position's query heads over ``h``
    (all of S); -> (the output summed over the heads axes, each position
    given its S block over ``ax["seq"]``, each position's (k, v) of its kv
    heads)."""
    H, Kv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    G, H_p, Kv_p = H // Kv, H // mesh.size(ax["heads"]), Kv // mesh.size(ax["kv"])
    kv = _pp(lambda h, wk, wv, pos: (L.rope(tfm._proj(h, wk), pos, cfg.rope_theta),
                                     tfm._proj(h, wv)), mesh, h, lp["wk"], lp["wv"], positions)

    def heads(h, wq, wo, kv, pos, h0, k0):
        sel = _kv_select(h0, H_p, G, k0, Kv_p)
        q = L.rope(tfm._proj(h, wq), pos, cfg.rope_theta)
        out = L.chunked_attention(
            q, sel(kv[0]), sel(kv[1]), causal=True, window=cfg.window if is_local else None,
            attn_softcap=cfg.attn_softcap, chunk_q=cfg.chunk_q, chunk_kv=cfg.chunk_kv)
        return out.reshape(*out.shape[:-2], H_p * dh) @ wo.reshape(H_p * dh, D).to(h.dtype)

    part = _pp(heads, mesh, h, lp["wq"], lp["wo"], kv, positions, _starts(mesh, ax["heads"], H_p),
               _starts(mesh, ax["kv"], Kv_p))
    return _scatter(part, mesh, ax["heads"], ax["seq"]), kv


def _cache_axes(cache: Sharded, batch_entry) -> dict[str, tuple]:
    s = cache.spec
    if s[0] is not None or s[4] is not None:
        raise ValueError(f"a cache split over layers or head_dim ({s}) is not a serving layout")
    if axes_of(s[1]) != axes_of(batch_entry):
        raise ValueError(f"the cache's batch splits over {s[1]}, the tokens' over {batch_entry}")
    return {"seq": axes_of(s[2]), "kv": axes_of(s[3])}


def _mesh_axes(cfg, params, tokens: Sharded, mesh, rules) -> dict[str, tuple]:
    """:func:`_axes` and ``"seq"``, the axes the residual's S splits over."""
    if tokens.spec[1] is not None:
        raise ValueError(f"tokens split over the sequence ({tokens.spec}): the programs take "
                         f"them whole")
    return {**_axes(params), "seq": axes_of(seq_entry(mesh, (*tokens.shape, cfg.d_model),
                                                        rules))}


def _hidden(cfg, params, tokens: Sharded, mesh, cache=None, rules=None) -> tuple:
    """The layers over each position's prompt rows; -> the last layer's
    output a position (its S block under ``rules``' ``"seq_sp"``), writing
    each layer's k / v into ``cache`` (a ``{"k", "v"}`` of :class:`Sharded`
    [L, B, S, Kv, dh]) when given."""
    ax = _mesh_axes(cfg, params, tokens, mesh, rules)
    B, S = tokens.shape
    x = col.split(_embed(params["embed"], tokens.parts, mesh), mesh, ax["seq"], 1)
    positions = _pp(lambda t: torch.arange(S, dtype=torch.int32, device=t.device)
                    .expand(t.shape[0], S), mesh, tokens.parts)
    if cache is not None:
        cax = _cache_axes(cache["k"], tokens.spec[0])
        S_c, Kv_c = cache["k"].parts[0].shape[2:4]
        s0s, c0s = _starts(mesh, cax["seq"], S_c), _starts(mesh, cax["kv"], Kv_c)
    for i, is_local in enumerate(tfm.local_flags(cfg)):
        lp = _layer(params, i)
        h = _normed(x, lp["attn_norm"], mesh, ax, _attn_axes(cfg, ax))
        attn, kv = _attention(cfg, lp, h, positions, is_local, mesh, ax)
        if cache is not None:
            k0s = _starts(mesh, ax["kv"], cfg.n_kv_heads // mesh.size(ax["kv"]))
            if cax["kv"] != ax["kv"]:  # the cache's kv blocks are not wk's: gather them
                kv = col.all_gather(kv, mesh, ax["kv"], 2)
                k0s = [0] * len(k0s)
            for j, name in enumerate(("k", "v")):
                _pp(lambda c, t, s0, c0, k0: c.copy_(t[j][:, s0:s0 + S_c, c0 - k0:c0 - k0 + Kv_c]),
                    mesh, _index(cache[name].parts, i), kv, s0s, c0s, k0s)
        x = _residual(cfg, lp, x, h, attn, mesh, ax)
    return x


@torch.no_grad()
def forward(cfg, params, tokens: Sharded, *, mesh, rules=None) -> Sharded:
    """Token ids [B, S] (batch split over the data axes) -> final hidden
    states [B, S, D] (bf16), the batch split as the tokens', S as the
    residual stream's under ``rules``."""
    x = _hidden(cfg, params, tokens, mesh, rules=rules)
    x = _pp(L.rms_norm, mesh, x, params["final_norm"].parts)
    return Sharded(x, mesh, (tokens.spec[0], seq_entry(mesh, (*tokens.shape, cfg.d_model), rules),
                             None))


@torch.no_grad()
def prefill(cfg, params, tokens: Sharded, *, mesh, rules=None):
    """Process a prompt [B, S] on ``mesh``; returns (last-position logits
    [B, V] f32 on the lead device, the kv cache ``{"k", "v"}`` of
    :class:`Sharded` [L, B, S, Kv, dh] bf16 laid out by ``spec_for`` over
    ``KV_AXES`` under ``rules``)."""
    B, S = tokens.shape
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    spec = shd.spec_for(mesh, KV_AXES, shape, rules)
    cache = {k: shd.empty(shape, torch.bfloat16, mesh, spec) for k in ("k", "v")}
    x = _hidden(cfg, params, tokens, mesh, cache, rules)
    # position S - 1 is the last row of the last S block: every block's last row gathered
    last = col.all_gather(_pp(lambda x: x[:, -1:], mesh, x), mesh,
                          axes_of(seq_entry(mesh, (B, S, cfg.d_model), rules)), 1)
    h = _pp(lambda x, n: L.rms_norm(x[:, -1], n), mesh, last, params["final_norm"].parts)
    return _logits(cfg, params, h, mesh, tokens.spec[0]), cache


def _write(c, new, pos, s0: int, c0: int) -> None:
    """The new k or v [B_p, Kv, dh] into cache block ``c`` [B_p, S_c, Kv_c,
    dh] (positions ``s0 ..``, kv heads ``c0 ..``) where it holds ``pos``."""
    tfm._write_at(c, pos - s0, new[:, c0:c0 + c.shape[2]])


def _decode_attention(cfg, lp, h, pos, kc, vc, is_local: bool, mesh, ax, cax) -> tuple:
    """One decode layer's attention: q / k / v of each position's heads
    gathered over their axes, the new k / v written where the cache block
    holds ``pos``, partials over each S block combined over the ``kv_seq``
    axes, the output's heads of wo's block projected and summed."""
    H, Kv, dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    G, H_p = H // Kv, H // mesh.size(ax["heads"])

    def roped(h, w, p):
        return L.rope(tfm._proj(h, w)[:, None], p[:, None], cfg.rope_theta)[:, 0]

    q = col.all_gather(_pp(roped, mesh, h, lp["wq"], pos), mesh, ax["heads"], 1)
    k = col.all_gather(_pp(roped, mesh, h, lp["wk"], pos), mesh, ax["kv"], 1)
    v = col.all_gather(_pp(tfm._proj, mesh, h, lp["wv"]), mesh, ax["kv"], 1)
    S_c, Kv_c = kc[0].shape[1], kc[0].shape[2]
    s0s, c0s = _starts(mesh, cax["seq"], S_c), _starts(mesh, cax["kv"], Kv_c)
    _pp(_write, mesh, kc, k, pos, s0s, c0s)
    _pp(_write, mesh, vc, v, pos, s0s, c0s)

    def partial(q, kc, vc, p, s0, c0):
        return L.decode_attention_partial(
            q[:, c0 * G:(c0 + Kv_c) * G], kc, vc, length=p + 1, start=s0, window=cfg.window,
            is_local=is_local if cfg.window is not None else None, attn_softcap=cfg.attn_softcap)

    out = col.reduce_over(_pp(partial, mesh, q, kc, vc, pos, s0s, c0s), mesh, cax["seq"],
                          L.combine_decode_partials)
    out = col.all_gather(out, mesh, cax["kv"], 1)  # [B_p, H, dh] f32

    def project(o, wo, h0):
        o = o[:, h0:h0 + H_p].to(torch.bfloat16)
        return o.reshape(-1, H_p * dh) @ wo.reshape(H_p * dh, D).to(torch.bfloat16)

    return col.psum(_pp(project, mesh, out, lp["wo"], _starts(mesh, ax["heads"], H_p)), mesh,
                    ax["heads"])


@torch.no_grad()
def decode_step(cfg, params, cache: dict, tokens_new: Sharded, lengths: Sharded, *, mesh):
    """One decode step on ``mesh`` against ``cache`` ({"k", "v"} of
    :class:`Sharded` [L, B, S, Kv, dh], written in place at ``lengths``,
    nowhere outside it); ``tokens_new`` / ``lengths`` int[B] split as the
    cache's batch.  Returns (logits [B, V] f32 on the lead device, cache)."""
    ax = _axes(params)
    if lengths.spec != tokens_new.spec:
        raise ValueError(f"lengths split as {lengths.spec}, tokens as {tokens_new.spec}")
    cax = _cache_axes(cache["k"], tokens_new.spec[0])
    if cache["v"].spec != cache["k"].spec:
        raise ValueError(f"v split as {cache['v'].spec}, k as {cache['k'].spec}")
    route = axes_of(tokens_new.spec[0])
    ax["seq"] = ()  # one token a row: the residual whole
    x = _embed(params["embed"], tokens_new.parts, mesh)
    pos = _pp(lambda n: n.to(torch.int32), mesh, lengths.parts)
    for i, is_local in enumerate(tfm.local_flags(cfg)):
        lp = _layer(params, i)
        h = _pp(L.rms_norm, mesh, x, lp["attn_norm"])
        attn = _decode_attention(cfg, lp, h, pos, _index(cache["k"].parts, i),
                                 _index(cache["v"].parts, i), is_local, mesh, ax, cax)
        x = _residual(cfg, lp, x, h, attn, mesh, ax, route)
    h = _pp(L.rms_norm, mesh, x, params["final_norm"].parts)
    return _logits(cfg, params, h, mesh, tokens_new.spec[0]), cache


# ---------------------------------------------------------------------------
# training: the loss and its gradient
# ---------------------------------------------------------------------------


def _layer_parts(params) -> list[dict[str, tuple]]:
    """Every layer's parameters a position, one ``unbind`` a distinct part
    of each stacked leaf: under autograd a part's gradient is one stack of
    its layers' (not a full-size zero tensor a layer).  The norm scales in
    f32 (:func:`_f32`)."""
    memo: dict = {}

    def layers(part, name):
        if id(part) not in memo:
            memo[id(part)] = (part.float() if name in ("attn_norm", "ffn_norm") else part).unbind(0)
        return memo[id(part)]

    stacked = {k: [layers(p, k) for p in v.parts] for k, v in params["layers"].items()}
    return [{k: tuple(ls[i] for ls in v) for k, v in stacked.items()}
            for i in range(len(next(iter(stacked.values()))[0]))]


def _f32(parts, mesh) -> tuple:
    """A norm scale's parts in f32, one conversion a distinct part (the
    norm computes in f32): its gradient sums every S block's and data
    slice's share in f32 and is rounded to a bf16 scale's dtype once, not
    once a block."""
    return _pp(lambda t: t.float(), mesh, parts)


def _train_layer(cfg, lp, x, positions, is_local: bool, mesh, ax) -> tuple:
    """One block's output a position (its S block); its k / v are not
    kept."""
    h = _normed(x, lp["attn_norm"], mesh, ax, _attn_axes(cfg, ax))
    attn, _ = _attention(cfg, lp, h, positions, is_local, mesh, ax)
    return _residual(cfg, lp, x, h, attn, mesh, ax)


class _Remat(torch.autograd.Function):
    """``fn(*inputs)`` (distinct tensors in, distinct tensors out) kept as
    its inputs only (a mesh layer's: each position's residual block, the
    positions and the weights): the forward runs without a graph, the backward runs it
    again and differentiates it.  One autograd node for the whole mesh
    layer, so its recomputation runs once, in whichever device's backward
    thread reaches it (``torch.utils.checkpoint``'s per-tensor unpack hooks
    race between the threads of a mesh's distinct devices)."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.fn = fn
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            return tuple(fn(*inputs))

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.fn(*inputs)
        used = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        wanted = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in used], wanted, [g for _, g in used],
                                       allow_unused=True))
        return (None, *(next(got) if t.requires_grad else None for t in inputs))


def _rematerialised(cfg, lp, x, positions, is_local: bool, mesh, ax) -> tuple:
    """:func:`_train_layer` through :class:`_Remat`: its distinct input
    tensors flattened in, its distinct outputs back to their positions."""
    names = list(lp)
    groups = [x, positions, *(lp[k] for k in names)]
    flat = list({id(t): t for g in groups for t in g}.values())
    slot = {id(t): i for i, t in enumerate(flat)}
    index = [[slot[id(t)] for t in g] for g in groups]
    owner = []

    def run(*ts):
        xs, ps, *ws = (tuple(ts[i] for i in ix) for ix in index)
        out = _train_layer(cfg, dict(zip(names, ws)), xs, ps, is_local, mesh, ax)
        distinct = list({id(t): t for t in out}.values())
        owner[:] = [next(i for i, d in enumerate(distinct) if d is t) for t in out]
        return distinct

    outs = _Remat.apply(run, *flat)
    return tuple(outs[i] for i in owner)


def _vocab_weight(cfg, params, mesh) -> tuple[tuple, object]:
    """Each position's output projection [D, V_p] and its vocab spec entry."""
    if cfg.tie_embeddings:
        return _pp(lambda t: t.T, mesh, params["embed"].parts), params["embed"].spec[0]
    return params["unembed"].parts, params["unembed"].spec[1]


def _logit_blocks(cfg, h, w, entry, mesh) -> tuple[tuple, tuple, int]:
    """Each position's f32 logits of its rows ``h`` [B_p, S, D] (all of S)
    over its vocab block of ``w`` (:func:`_vocab_weight`; the final softcap
    applied), the vocab axes and the block size."""
    logits = _pp(lambda h, w: L.softcap(h.float() @ w.to(h.dtype).float(), cfg.final_softcap),
                 mesh, h, w)
    return logits, axes_of(entry), w[0].shape[1]


def loss_fn(cfg, params, batch: dict, *, mesh, rules=None) -> torch.Tensor:
    """Next-token cross-entropy over labels >= 0 on ``mesh`` (see the
    module docstring; the residual stream laid out under ``rules``),
    differentiable in every part of ``params``; ``batch`` holds ``tokens``
    and ``labels`` int[B, S] :class:`Sharded` over the data axes.  Returns
    the f32 scalar on the mesh's lead device."""
    tokens, labels = batch["tokens"], batch["labels"]
    if labels.spec != tokens.spec:
        raise ValueError(f"labels split as {labels.spec}, tokens as {tokens.spec}")
    ax = _mesh_axes(cfg, params, tokens, mesh, rules)
    B, S = tokens.shape
    x = col.split(_embed(params["embed"], tokens.parts, mesh), mesh, ax["seq"], 1)
    positions = _pp(lambda t: torch.arange(S, dtype=torch.int32, device=t.device)
                    .expand(t.shape[0], S), mesh, tokens.parts)
    layer = _rematerialised if cfg.remat and torch.is_grad_enabled() else _train_layer
    for lp, is_local in zip(_layer_parts(params), tfm.local_flags(cfg)):
        x = layer(cfg, lp, x, positions, is_local, mesh, ax)
    w, entry = _vocab_weight(cfg, params, mesh)
    h = _normed(x, _f32(params["final_norm"].parts, mesh), mesh, ax, axes_of(entry))
    logits, vax, V_loc = _logit_blocks(cfg, h, w, entry, mesh)
    lmax = col.pmax(_pp(lambda l: l.detach().amax(dim=-1, keepdim=True), mesh, logits), mesh, vax)
    sums = col.psum(_pp(lambda l, m: torch.sum(torch.exp(l - m), dim=-1), mesh, logits, lmax),
                    mesh, vax)

    def label_logit(l, y, v0):
        local = y.long() - v0
        ok = (local >= 0) & (local < V_loc)
        got = torch.take_along_dim(l, local.clamp(0, V_loc - 1)[..., None], dim=-1)[..., 0]
        return torch.where(ok, got, 0.0)

    lab = col.psum(_pp(label_logit, mesh, logits, labels.parts, _starts(mesh, vax, V_loc)),
                   mesh, vax)

    def nll(s, m, lab, y):
        return torch.where(y >= 0, torch.log(s) + m[..., 0] - lab, 0.0).sum()

    total = _pp(nll, mesh, sums, lmax, lab, labels.parts)
    count = _pp(lambda y: (y >= 0).sum(), mesh, labels.parts)
    loss = col.over_slices(col.sum_in_order, total, mesh)  # one position a data slice
    n = col.over_slices(col.sum_in_order, count, mesh)
    for t in (loss, n):  # each the all-reduce over the data slices every position would run
        col.count_over("all-reduce", t.numel() * t.element_size(), mesh, dp_axes(mesh))
    return loss / torch.clamp(n, min=1)
