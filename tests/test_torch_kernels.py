"""The port's ``popcount``, ``sorted_intersect_mask`` and ``block_spmm``
entry points and ``mask_from_k2_level`` against the JAX package.

On the CPU the entry points run their plain versions (``kernels/ref.py``);
each is held against the Pallas kernel in interpret mode (the JAX
package's ``repro.kernels.ops`` function of the same name) on the same
seeded numpy inputs: bit for bit for the two integer kernels, within the
tolerances of ``tests/test_kernels.py`` for ``block_spmm``.  Also: the
shape contracts, the NaN-in-a-masked-off-tile semantics, a rank directory
rebuilt from ``popcount``, and the intersection masks of real join inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops, ref as jref
from repro.kernels import block_spmm as jblock_spmm
from repro.kernels import sorted_intersect as jsorted_intersect
from repro_torch.core import engine as eng, sortedset
from repro_torch.core.query import ExecConfig, JoinQ
from repro_torch.kernels import build, ops
from repro_torch.kernels.block_spmm import mask_from_k2_level
from test_torch_store import build_pair

SENTINEL = 2**31 - 1


def _words(rng, m, n):
    return rng.integers(0, 2**32, (m, n), dtype=np.uint32)


def _i32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32))


# ---------------------------------------------------------------------------
# popcount
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(8, 128), (16, 256), (32, 512), (8, 1024)])
def test_popcount_matches_pallas(rng, m, n):
    w = _words(rng, m, n)
    w[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    got = ops.popcount(_i32(w)).numpy()
    want = np.asarray(jops.popcount(jnp.asarray(w)))
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.unpackbits(w.view(np.uint8), axis=1).reshape(m, n, 32).sum(-1))


def test_popcount_block_m_contract(rng):
    """Rows in multiples of the Pallas kernel's default block of 8, lanes in
    multiples of 128; the port raises ValueError where JAX asserts."""
    w = _words(rng, 24, 256)
    got = ops.popcount(_i32(w)).numpy()
    assert np.array_equal(got, np.asarray(jops.popcount(jnp.asarray(w))))
    with pytest.raises(AssertionError):
        jops.popcount(jnp.asarray(w[:20]))
    for bad in (w[:20], w[:, :200], w[0]):
        with pytest.raises(ValueError):
            ops.popcount(_i32(bad))
    with pytest.raises(TypeError):
        ops.popcount(torch.from_numpy(w.astype(np.int64)))


def test_rank_directory_rebuilt_from_popcount():
    """The slice as a whole: each tree's exclusive cumsum of per-word
    counts, over the whole arena flattened and zero-padded to (M, 1024),
    is the JAX store's rank directory (padding words rank-extended)."""
    st, jst, _ = build_pair("preds16")
    words = st.forest.t_words
    p, w = words.shape
    flat = torch.zeros(-(-words.numel() // 8192) * 8192, dtype=torch.int32)
    flat[: words.numel()] = words.reshape(-1)
    arena = flat.reshape(-1, 1024)
    counts = ops.popcount(arena)
    jcounts = np.asarray(jops.popcount(jnp.asarray(arena.numpy().view(np.uint32))))
    assert np.array_equal(counts.numpy(), jcounts)
    per_word = counts.reshape(-1)[: p * w].reshape(p, w).to(torch.int64)
    rank = torch.cumsum(per_word, dim=1) - per_word
    assert np.array_equal(rank.numpy(), np.asarray(jst.forest.t_rank).astype(np.int64))


# ---------------------------------------------------------------------------
# sorted_intersect_mask
# ---------------------------------------------------------------------------


def _padded(vals, cap):
    out = np.full(cap, SENTINEL, np.int32)
    out[: len(vals)] = vals
    return out


def _intersect_both(a, b, **kw):
    got = ops.sorted_intersect_mask(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    want = np.asarray(jops.sorted_intersect_mask(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == want.dtype == np.bool_
    return got, want


@pytest.mark.parametrize("ca,cb,na,nb", [(128, 128, 50, 100), (512, 1024, 300, 700), (2048, 256, 1000, 200)])
def test_sorted_intersect_matches_pallas(rng, ca, cb, na, nb):
    b = np.sort(rng.choice(100_000, nb, replace=False)).astype(np.int32)
    shared = rng.choice(b[2:], min(na, nb) // 3, replace=False)
    a = np.union1d(rng.choice(100_000, na - shared.size, replace=False), shared)
    a = a[a != b[1]].astype(np.int32)  # the lane the Pallas kernel misses
    ap, bp = _padded(a, ca), _padded(b, cb)
    got, want = _intersect_both(ap, bp)
    assert np.array_equal(got, want)
    assert np.array_equal(got[: a.size], np.isin(a, b)) and got[: a.size].any()
    assert not got[a.size:].any()  # sentinels never match


# (a lanes, b lanes): every case keeps clear of the lane the Pallas kernel
# misses (see test_sorted_intersect_pallas_short_search)
EDGE_CASES = {
    "cb=1": ([-3, 4, 9, SENTINEL], [4]),
    "cb=1 sentinel": ([4, SENTINEL], [SENTINEL]),
    "cb=3": ([1, 2, 5, 7, 8, 11, 12, SENTINEL], [2, 7, 11]),
    "negative ids": ([-2**31, -900, -5, -1, 0, 3, 4, 6], [-2**31, -901, -5, 0, 4, SENTINEL]),
    "beyond max(b)": ([10, 20, 30, 40, 1000, 2**31 - 2, SENTINEL, SENTINEL], [10, 30, 35]),
    "duplicates in b": ([1, 3, 5, 7, 9, 11, 13, 15], [3, 3, 3, 7, 7, 9, 15, 15, 15, SENTINEL]),
    "empty b": ([1, 2, SENTINEL, SENTINEL], [SENTINEL] * 4),
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_sorted_intersect_edge_cases(case):
    a, b = (np.array(v, np.int32) for v in EDGE_CASES[case])
    got, want = _intersect_both(a, b)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.isin(a, b) & (a != SENTINEL))
    ref = np.asarray(jref.sorted_intersect_mask_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("cb", [2, 8, 1024])
def test_sorted_intersect_pallas_short_search(cb):
    """With ``cb`` a power of two the Pallas kernel stops its search one step
    short and misses ``a == b[1] > b[0]``.  The port returns membership, as
    the JAX package's ``ref.sorted_intersect_mask_ref`` does."""
    b = _padded(np.arange(0, 3 * min(cb, 6), 3), cb)
    a = _padded(np.array([b[0], b[1], b[1] + 1]), 8)
    got, pallas = _intersect_both(a, b)
    ref = np.asarray(jref.sorted_intersect_mask_ref(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, np.isin(a, b) & (a != SENTINEL))
    assert got[1] and not pallas[1]
    assert np.array_equal(np.delete(got, 1), np.delete(pallas, 1))


def test_sorted_intersect_block_contract(rng):
    """A in multiples of the Pallas kernel's 2048-lane block (or one short
    block); the port raises ValueError where JAX asserts."""
    b = _padded(np.sort(rng.choice(50_000, 300, replace=False)), 512)
    a = np.sort(rng.choice(50_000, 3000, replace=False))
    a = _padded(a[a != b[1]], 4096)  # the lane the Pallas kernel misses
    got = ops.sorted_intersect_mask(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jops.sorted_intersect_mask(jnp.asarray(a), jnp.asarray(b)))
    assert np.array_equal(got, want)
    with pytest.raises(AssertionError):
        jsorted_intersect.sorted_intersect_mask(jnp.asarray(a[:3000]), jnp.asarray(b),
                                                interpret=True)
    for a_bad, b_bad in ((a[:3000], b), (a, b[:0]), (a[:0], b), (a.reshape(64, 64), b)):
        with pytest.raises(ValueError):
            ops.sorted_intersect_mask(torch.from_numpy(a_bad), torch.from_numpy(b_bad))
    with pytest.raises(TypeError):
        ops.sorted_intersect_mask(torch.from_numpy(a.astype(np.int64)), torch.from_numpy(b))


def test_sorted_intersect_masks_of_join_inputs(monkeypatch):
    """The slice as a whole: every (A, B row) that ``sortedset.intersect``
    receives in join categories A-C; the mask picks exactly the kept lanes."""
    st, _, ids = build_pair("preds16")
    seen = []
    orig = sortedset.intersect

    def recording(a, b):
        out = orig(a, b)
        seen.append((a, b, out))
        return out

    monkeypatch.setattr(sortedset, "intersect", recording)
    engine = eng.Engine(st, device="cpu")
    cfg = ExecConfig(cap=256, device="cpu")
    s1, p1, o1 = (int(v) for v in ids[7])
    s2 = int(ids[ids[:, 2] == o1][-1, 0])
    for q in (JoinQ("A", "s", "s", p1=p1, c1=o1, p2=p1, c2=o1),
              JoinQ("B", "s", "s", p1=p1, c1=o1, c2=o1),
              JoinQ("C", "s", "s", c1=o1, c2=o1), JoinQ("C", "o", "o", c1=s1, c2=s2)):
        engine.compile(q, cfg)()
    rows = 0
    for a, b, out in seen:
        b_ids = b.ids.reshape(-1, b.ids.shape[-1])
        kept = out.ids.reshape(b_ids.shape[0], -1)
        kept_valid = out.valid.reshape(b_ids.shape[0], -1)
        for i in range(b_ids.shape[0]):
            mask = ops.sorted_intersect_mask(a.ids, b_ids[i].contiguous())
            want = jref.sorted_intersect_mask_ref(jnp.asarray(a.ids.numpy()),
                                                  jnp.asarray(b_ids[i].numpy()))
            assert np.array_equal(mask.numpy(), np.asarray(want))
            assert torch.equal(a.ids[mask], kept[i][kept_valid[i]])
            rows += 1
    assert rows >= 3 + st.n_preds and any(bool(o.valid.any()) for _, _, o in seen)


@pytest.mark.parametrize("ca,cb,sms,plan", [
    (1024, 1024, 132, (1, 256, 4, 0)),  # a join's intersection
    (2**16, 2**18, 132, (1, 256, 256, 0)),  # the JAX bench's shape
    (655_360, 532_480, 132, (0, 256, 640, 4096)),  # two geonames predicates' subjects
    (2048, 2**20, 132, (1, 256, 8, 0)),  # sparse A in dense B
    (135_168, 3, 132, (1, 256, 528, 0)),  # 1024 lanes for each of 132 SMs
    (135_169, 3, 132, (0, 256, 133, 3)),  # more: tiles, all of B staged
    (2**18, 4096, 132, (0, 256, 256, 4096)),
    (2**18, 2**20, 132, (0, 256, 256, 4096)),  # a tile's share of B fills the window
    (2**18, 2**20 + 1, 132, (1, 256, 1024, 0)),  # and past it
    (100, 50, 132, (1, 256, 1, 0)),
    (4096, 9, 4, (1, 256, 16, 0)),  # a card of 4 SMs
    (4097, 9, 4, (0, 256, 5, 9)),  # a tail tile
])
def test_intersect_plan(ca, cb, sms, plan):
    """sorted_intersect_mask: a thread a lane (kernel 1) up to 1024 lanes
    an SM or where a tile's even share of B would pass the window; else
    tiles of 1024 lanes (kernel 0) staging all of B up to INTERSECT_WINDOW
    ids, else a window of that many."""
    kernel, threads, blocks, window = ops._intersect_plan(ca, cb, sms)
    assert (kernel, threads, blocks, window) == plan
    lanes = 4 * threads if kernel == 0 else threads
    assert (blocks - 1) * lanes < ca <= blocks * lanes
    assert window == (min(cb, ops.INTERSECT_WINDOW) if kernel == 0 else 0)


# ---------------------------------------------------------------------------
# block_spmm and mask_from_k2_level
# ---------------------------------------------------------------------------


def _spmm_both(mask, a, x, dtype, **kw):
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = ops.block_spmm(torch.from_numpy(mask), torch.from_numpy(a).to(tdtype),
                         torch.from_numpy(x).to(tdtype), **kw)
    want = jops.block_spmm(jnp.asarray(mask), jnp.asarray(a, dtype), jnp.asarray(x, dtype), **kw)
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("m,k,d,dtype", [
    (256, 256, 128, np.float32),
    (512, 384, 256, np.float32),
    (256, 256, 128, jnp.bfloat16),
])
def test_block_spmm_matches_pallas(rng, m, k, d, dtype):
    mask = (rng.random((m // 128, k // 128)) < 0.5).astype(np.int32)
    mask[0, 0] = 1
    a = (rng.random((m, k)) < 0.02).astype(np.float32)
    x = rng.standard_normal((k, d)).astype(np.float32)
    got, want = _spmm_both(mask, a, x, dtype)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_block_spmm_mask_semantics():
    """Masked-off tiles contribute exactly zero; any non-zero entry,
    negative too, turns a tile on."""
    mask = np.array([[1, 0], [0, -3]], np.int32)
    a = np.ones((256, 256), np.float32)
    x = np.ones((256, 128), np.float32)
    got, want = _spmm_both(mask, a, x, np.float32)
    assert np.array_equal(got, want)
    assert (got == 128.0).all()  # one ON tile of 128 k-elements per row band


def test_block_spmm_nan_in_masked_off_tile():
    """A NaN in a masked-off tile of A, or in X rows that only masked-off
    tiles meet, never reaches Y: the Pallas kernel never reads such a tile
    (its jnp reference, which multiplies A by the mask, would give NaN)."""
    mask = np.array([[1, 0], [0, 1]], np.int32)
    a = np.ones((256, 256), np.float32)
    a[:128, 128:] = np.nan
    x = np.ones((256, 128), np.float32)
    got, want = _spmm_both(mask, a, x, np.float32)
    assert np.isfinite(got).all() and np.array_equal(got, want)
    assert (got == 128.0).all()
    mask = np.array([[1, 0], [1, 0]], np.int32)
    a = np.ones((256, 256), np.float32)
    x[128:] = np.inf
    for dtype in (np.float32, jnp.bfloat16):
        got, want = _spmm_both(mask, a, x, dtype)
        assert np.isfinite(got).all() and np.array_equal(got, want)


def test_block_spmm_block_kwargs(rng):
    m, k, d = 256, 192, 256
    kw = dict(block_m=64, block_k=32, block_d=128)
    mask = (rng.random((m // 64, k // 32)) < 0.4).astype(np.int32)
    a = (rng.random((m, k)) < 0.1).astype(np.float32)
    x = rng.standard_normal((k, d)).astype(np.float32)
    got, want = _spmm_both(mask, a, x, np.float32, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(AssertionError):
        jops.block_spmm(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(x), block_m=96)


def test_block_spmm_contract():
    mask = torch.ones((2, 2), dtype=torch.int32)
    a = torch.zeros((256, 256))
    x = torch.zeros((256, 128))
    for args, kw in (
        ((mask, a, x[:200]), {}),  # K mismatch
        ((mask, a[:200], x), {}),  # M % block_m
        ((mask, a, x), dict(block_d=96)),  # D % block_d
        ((mask[:1], a, x), {}),  # mask shape
        ((mask, a, x), dict(block_k=0)),
        ((mask, a[0], x), {}),
    ):
        with pytest.raises(ValueError):
            ops.block_spmm(*args, **kw)
    for args in ((mask.float(), a, x), (mask, a.double(), x.double()),
                 (mask, a, x.to(torch.bfloat16))):
        with pytest.raises(TypeError):
            ops.block_spmm(*args)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    # bf16 on the grid: wgmma, the largest tile that gives 3/4 of 132 SMs a block
    ((16384, 16384, 256, 128, 128, 128), BF16, True, ("wgmma", 128, 256, 64, 288)),
    ((16384, 256, 128, 128, 128, 128), BF16, True, ("wgmma", 128, 128, 64, 288)),
    ((16384, 16384, 256, 64, 64, 64), BF16, True, ("wgmma", 64, 256, 64, 160)),
    ((4096, 256, 256, 64, 128, 128), BF16, True, ("wgmma", 64, 128, 64, 160)),
    # no tile reaches 3/4 of the SMs: the one with the most blocks
    ((1024, 1024, 512, 128, 128, 128), BF16, True, ("wgmma", 64, 64, 64, 160)),
    # BK a multiple of 16 but not of 64: 16-wide k chunks
    ((512, 768, 192, 64, 32, 64), BF16, True, ("wgmma", 64, 64, 16, 160)),
    ((16384, 256, 256, 128, 16, 128), BF16, True, ("wgmma", 128, 256, 16, 288)),
    # f32 on the grid: fma, 64 threads of 8 x 8 sums once every SM gets 4 blocks
    ((16384, 16384, 256, 128, 128, 128), F32, True, ("fma", 64, 64, 32, 64)),
    ((16384, 16384, 256, 64, 64, 64), F32, True, ("fma", 64, 64, 32, 64)),
    ((16384, 256, 256, 64, 16, 64), F32, True, ("fma", 64, 64, 16, 64)),
    ((1024, 1024, 512, 128, 128, 128), F32, True, ("fma", 64, 64, 32, 256)),
    ((512, 768, 256, 64, 16, 64), F32, True, ("fma", 64, 64, 16, 256)),
    # off the grid: the SIMT kernel
    ((512, 512, 256, 128, 128, 128), BF16, False, ("simt", 128, 128, 16, 256)),
    ((512, 512, 256, 128, 128, 128), F32, False, ("simt", 128, 128, 16, 256)),
    ((240, 120, 96, 48, 24, 96), BF16, True, ("simt", 128, 128, 16, 256)),
    ((512, 120, 256, 128, 24, 128), BF16, True, ("simt", 128, 128, 16, 256)),
    ((512, 120, 256, 128, 24, 128), F32, True, ("simt", 128, 128, 16, 256)),
    ((512, 512, 96, 128, 128, 96), BF16, True, ("simt", 128, 128, 16, 256)),
    ((512, 512, 96, 128, 128, 96), F32, True, ("simt", 128, 128, 16, 256)),
    ((256, 256, 256, 32, 128, 128), F32, True, ("simt", 128, 128, 16, 256)),
])
def test_spmm_variant(shape, dtype, aligned, want):
    assert ops._spmm_variant(*shape, dtype, aligned, 132) == want


def test_spmm_variant_follows_the_card():
    """A card of fewer SMs takes the larger tile, or the larger thread
    tile, sooner."""
    shape = (4096, 256, 256, 128, 128, 128)
    assert ops._spmm_variant(*shape, BF16, True, 132) == ("wgmma", 64, 128, 64, 160)
    assert ops._spmm_variant(*shape, BF16, True, 40) == ("wgmma", 128, 256, 64, 288)
    assert ops._spmm_variant(*shape, F32, True, 132)[-1] == 256
    assert ops._spmm_variant(*shape, F32, True, 64)[-1] == 64


@pytest.mark.parametrize("side,side_l,block,density", [
    (512, 2, 128, 0.5),  # repeat: region 256 >= 128
    (1024, 8, 128, 0.3),  # region == block
    (512, 16, 128, 0.05),  # OR-reduce: region 32 < 128
    (256, 256, 64, 0.01),  # OR-reduce from single cells
])
def test_mask_from_k2_level_matches_jax(rng, side, side_l, block, density):
    lvl = (rng.random((side_l, side_l)) < density).astype(np.int32)
    got = mask_from_k2_level(torch.from_numpy(lvl), side=side, block=block)
    want = np.asarray(jblock_spmm.mask_from_k2_level(jnp.asarray(lvl), side=side, block=block))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert got.shape == (side // block, side // block)


def test_mask_from_k2_level_raises_where_jax_does():
    lvl = np.ones((64, 64), np.int32)  # region 8 < block 96: 5 tiles of 12 regions != 64
    with pytest.raises(TypeError):
        jblock_spmm.mask_from_k2_level(jnp.asarray(lvl), side=512, block=96)
    with pytest.raises(RuntimeError):
        mask_from_k2_level(torch.from_numpy(lvl), side=512, block=96)


# ---------------------------------------------------------------------------
# entry-point rules
# ---------------------------------------------------------------------------


def test_cpu_tensors_never_reach_build(monkeypatch, rng):
    def refuse(*_, **__):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(build, "load_all", refuse)
    monkeypatch.setattr(build, "build_all", refuse)
    before = dict(ops.LAUNCHES)
    ops.popcount(_i32(_words(rng, 8, 128)))
    ops.sorted_intersect_mask(torch.arange(8, dtype=torch.int32), torch.arange(4, dtype=torch.int32))
    ops.block_spmm(torch.ones((1, 1), dtype=torch.int32), torch.ones((128, 128)),
                   torch.ones((128, 128)))
    assert ops.LAUNCHES == before
    for name in ("popcount", "sorted_intersect_mask", "block_spmm"):
        assert name in ops.LAUNCHES and name in build.SOURCES
