"""The LM mesh programs' sequence-parallel residual stream (``"seq_sp"``,
``models/transformer_mesh.py``) and the collectives under it
(``dist/collectives.py``):

* ``reduce_scatter`` on a (2, 4) ``cpu`` mesh against a plain ordered sum
  then a split, each block a storage of its own, its backward an
  all-gather of the blocks' gradients; ``all_gather``'s backward giving
  each position the summed gradient of its own block;
* for each of the five smoke LM archs on (1, 4), (2, 2) and (2, 4) ``cpu``
  meshes: ``forward``, ``prefill`` (logits and caches) and the loss bit for
  bit equal between the ``seq_sp`` layout (the default rules, ``"seq_sp"``
  -> ``"model"``: S split four or two ways) and the whole residual
  (``"seq_sp"`` -> None).  The gradients are equal but for the norm
  scales' (their sums over tokens run a block at a time): f32 leaves within
  1e-6 relative L2, the f32 tolerance of the mesh tests' gradient combine
  rules (``test_torch_train_mesh.py::test_gradient_combine_rules``); a bf16
  scale's gradient is summed in f32 and rounded once, so kimi's are equal;
* the tensors a mesh training step saves for its backward
  (``saved_tensors_hooks``): under ``seq_sp`` the rematerialised layers keep
  each position's residual block [B_p, S/m, D] and no whole [B_p, S, D]
  residual; with the residual whole they keep that.

The parameters and batch of an arch are made once and shared by its cases.
"""

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.dist import collectives as col, sharding as shd
from repro_torch.launch import mesh as meshlib, programs
from repro_torch.models import transformer_mesh as tmesh
from repro_torch.train import trainer
from repro_torch.tree import leaves

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
MESHES = ((1, 4), (2, 2), (2, 4))
WHOLE = {"seq_sp": None}
GRAD_F32_TOL = 1e-6  # relative L2 of an f32 leaf: test_gradient_combine_rules' f32 bound


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * (shape[0] * shape[1]))


_INPUTS: dict = {}


def arch_inputs(arch):
    """An arch's smoke parameters and batch (seeded; made once)."""
    if arch not in _INPUTS:
        prog = programs.build(arch, "train_4k", cpu_mesh((1, 1)), smoke=True)
        params, _, batch = programs.lm_inputs(prog, "cpu", seed=7)
        _INPUTS[arch] = params, batch
    return _INPUTS[arch]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


def _parts(mesh, shape, dtype, seed, grad=False):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=g).to(dtype).requires_grad_(grad)
                 for _ in mesh.devices)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_scatter_like_sum_then_split(dtype):
    """Each (data) group's entries summed in block order over ``model`` (in
    f32, rounded once, for bf16), each position given its block along S:
    equal to ``sum_in_order`` then a split, each block's storage its own
    (not a view of the sum), and the wire bytes those of a reduce-scatter.
    The backward gives every entry the blocks' gradients concatenated."""
    mesh = cpu_mesh((2, 4))
    parts = _parts(mesh, (2, 8, 3), dtype, 0, grad=True)
    col.reset_wire()
    out = col.reduce_scatter(parts, mesh, ("model",), 1)
    assert col.wire_bytes()["reduce-scatter"] == 2 * 3 * (2 * 8 * 3 * parts[0].element_size())
    for grp in col.groups(mesh, ("model",)):
        full = col.sum_in_order([parts[p].detach() for p in grp])
        for j, p in enumerate(grp):
            assert torch.equal(out[p].detach(), full[:, 2 * j:2 * j + 2])
            s = out[p].untyped_storage()
            assert s.nbytes() == out[p].numel() * out[p].element_size()
        assert len({out[p].untyped_storage().data_ptr() for p in grp}) == len(grp)
    g = _parts(mesh, (2, 2, 3), dtype, 1)
    torch.autograd.backward(out, g)
    want = col.all_gather(g, mesh, ("model",), 1)
    for p in range(len(parts)):
        assert parts[p].grad.dtype == dtype and torch.equal(parts[p].grad, want[p])
    assert all(a is b for a, b in zip(col.reduce_scatter(parts, mesh, (), 1), parts))


def test_all_gather_backward_sums_each_block():
    """``all_gather`` over ``model``: a position's gradient is its own
    block of the gathered value's gradient summed over the positions that
    took it (the whole group, which shares one tensor here).  Small
    integers: every sum exact."""
    mesh = cpu_mesh((2, 4))
    gen = torch.Generator().manual_seed(2)
    parts = tuple(torch.randint(-8, 8, (2, 2, 3), generator=gen).float().requires_grad_()
                  for _ in mesh.devices)
    g = tuple(torch.randint(-8, 8, (2, 8, 3), generator=gen).float() for _ in mesh.devices)
    out = col.all_gather(parts, mesh, ("model",), 1)
    sum((o * w).sum() for o, w in zip(out, g)).backward()
    for grp in col.groups(mesh, ("model",)):
        total = sum(g[p] for p in grp)
        for j, p in enumerate(grp):
            assert torch.equal(out[p], torch.cat([parts[q] for q in grp], 1))
            assert torch.equal(parts[p].grad, total[:, 2 * j:2 * j + 2])


# ---------------------------------------------------------------------------
# the layouts: values
# ---------------------------------------------------------------------------


def _serve(arch, mesh, rules):
    params, batch = arch_inputs(arch)
    cfg = ARCHS[arch].smoke_cfg
    p = programs.shard_params(params, mesh)
    toks = shd.shard(batch["tokens"], mesh, shd.spec_for(mesh, ("batch", None),
                                                         tuple(batch["tokens"].shape)))
    h = tmesh.forward(cfg, p, toks, mesh=mesh, rules=rules)
    logits, cache = tmesh.prefill(cfg, p, toks, mesh=mesh, rules=rules)
    return h, logits, cache


def _loss(arch, mesh, rules):
    params, batch = arch_inputs(arch)
    cfg = ARCHS[arch].smoke_cfg
    prog = programs.build(arch, "train_4k", mesh, smoke=True, rules=rules)
    p, _, b = programs.lm_place(prog, (params, prog.opt.init(params), batch))
    return trainer.value_and_grad(lambda p, b: tmesh.loss_fn(cfg, p, b, mesh=mesh, rules=rules),
                                  p, b)


@pytest.mark.parametrize("mshape", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_seq_sp_equals_the_whole_residual(arch, mshape):
    """Forward, prefill and loss bit for bit equal between the two layouts,
    S split over ``model`` under ``seq_sp``; the gradients equal but for the
    f32 norm scales' token sums (``GRAD_F32_TOL``)."""
    mesh = cpu_mesh(mshape)
    h, logits, cache = _serve(arch, mesh, None)
    h0, logits0, cache0 = _serve(arch, mesh, WHOLE)
    assert h.spec[1] == "model" and h0.spec[1] is None
    assert h.parts[0].shape[1] * mshape[1] == h0.parts[0].shape[1]
    assert torch.equal(h.unshard(), h0.unshard()) and torch.equal(logits, logits0)
    for k in ("k", "v"):
        assert cache[k].spec == cache0[k].spec
        assert torch.equal(cache[k].unshard(), cache0[k].unshard())
    loss, g = _loss(arch, mesh, None)
    loss0, g0 = _loss(arch, mesh, WHOLE)
    assert torch.equal(loss, loss0)
    for (path, a), (_, b) in zip(leaves(g), leaves(g0)):
        a, b = a.unshard(), b.unshard()
        assert a.dtype == b.dtype
        if torch.equal(a, b):
            continue
        assert a.dtype == torch.float32 and "norm" in path[-1], path
        err = ((a - b).norm() / b.norm()).item()
        assert err <= GRAD_F32_TOL, (path, err)


# ---------------------------------------------------------------------------
# the layouts: what a training step keeps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rules", [None, WHOLE], ids=["seq_sp", "whole"])
def test_training_step_saves_residual_blocks(rules):
    """A (2, 4) smoke step of tinyllama (remat on): the tensors packed for
    the backward.  Under ``seq_sp`` every layer keeps each position's bf16
    residual block [B_p, S/4, D] and no bf16 [B_p, S, D] is kept; with the
    residual whole each layer keeps a data slice's [B_p, S, D] and no
    block."""
    arch, mshape = "tinyllama-1.1b", (2, 4)
    cfg = ARCHS[arch].smoke_cfg
    assert cfg.remat
    mesh = cpu_mesh(mshape)
    params, batch = arch_inputs(arch)
    prog = programs.build(arch, "train_4k", mesh, smoke=True, rules=rules)
    p, _, b = programs.lm_place(prog, (params, prog.opt.init(params), batch))
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    def forward(p, b):  # the hooks see the forward's saves, not the recomputation's
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return tmesh.loss_fn(cfg, p, b, mesh=mesh, rules=rules)

    trainer.value_and_grad(forward, p, b)
    B, S = batch["tokens"].shape
    B_p, D = B // mshape[0], cfg.d_model
    whole = saved.count(((B_p, S, D), torch.bfloat16))
    block = saved.count(((B_p, S // mshape[1], D), torch.bfloat16))
    if rules is None:
        assert whole == 0 and block >= cfg.n_layers * mshape[0] * mshape[1], (whole, block)
    else:
        assert block == 0 and whole >= cfg.n_layers * mshape[0], (whole, block)
