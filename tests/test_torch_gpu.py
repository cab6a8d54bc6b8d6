"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: the fixture below decides at run time whether a card is
present and skips otherwise, so every worker collects the same tests.  On
the card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import bitvec, engine as eng, k2triples
from repro_torch.core.query import ExecConfig, JoinQ, ServeQ, TriplePatternQ
from repro_torch.data import rdf
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module", params=[16, 600])
def store(request, cuda):
    n_preds = request.param
    # at 600 predicates these lists hold gaps > 255: a two-level DAC
    ds = rdf.generate(2500, n_subjects=150, n_preds=n_preds, n_objects=150,
                      pred_alpha=1.0, seed=11)
    st = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
        n_preds=ds.n_preds, device=cuda,
    )
    return st, ds


def _lanes(rng, q, lo, hi, dev):
    return torch.from_numpy(rng.integers(lo, hi, q).astype(np.int32)).to(dev)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


@pytest.mark.parametrize("cap", [1, 4, 64])
def test_k2_scan_kernel(store, cap, cuda):
    st, _ = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(cap)
    q = 300
    side = meta.side
    preds = _lanes(rng, q, -st.n_preds - 2, st.n_preds + 2, cuda)
    keys = _lanes(rng, q, -5, side + 5, cuda)
    axes = _lanes(rng, q, 0, 2, cuda)
    n0 = ops.LAUNCHES["k2_scan"]
    got = ops.k2_scan(meta, f, preds, keys, axes, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_scan"] == n0 + 1
    want = ref.k2_scan_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                           f.level_start, preds, keys, axes, cap=cap)
    _equal(got, want)


def test_k2_check_kernel(store, cuda):
    st, ds = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(2)
    q = 1000
    rows = ds.ids[rng.integers(0, ds.n_triples, q)]
    preds = torch.from_numpy((rows[:, 1] - 1).astype(np.int32)).to(cuda)
    s = torch.from_numpy((rows[:, 0] - 1).astype(np.int32)).to(cuda)
    o = torch.from_numpy((rows[:, 2] - 1).astype(np.int32)).to(cuda)
    o[::3] = _lanes(rng, o[::3].shape[0], -9, meta.side + 9, cuda)
    preds[::7] = _lanes(rng, preds[::7].shape[0], -40, st.n_preds + 40, cuda)
    got = ops.k2_check(meta, f, preds, s, o)
    want = ref.k2_check_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                            f.level_start, preds, s, o)
    assert torch.equal(got, want) and got[1::3].any()


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_pred_gather_dac_kernel(store, cap, cuda):
    st, _ = store
    dev, pmeta = st.pred_index.select("dac")
    rng = np.random.default_rng(3)
    rows = _lanes(rng, 500, 0, st.n_subjects + st.n_objects, cuda)
    got = ops.pred_gather_dac(pmeta, dev, rows, cap=cap)
    want = ref.pred_gather_dac_ref(
        rows, dev.offsets, dev.words, dev.degs, dev.flags, dev.frank,
        levels=pmeta.levels, level_byte_start=pmeta.level_byte_start,
        flag_word_start=pmeta.flag_word_start, deg_width=pmeta.deg_width,
        rows_per_block=pmeta.rows_per_block, cap=cap,
    )
    _equal(got, want)
    if st.n_preds == 600:
        assert pmeta.levels >= 2


def test_serve_on_card_matches_cpu(store, cuda):
    st, ds = store
    rng = np.random.default_rng(4)
    rows = ds.ids[rng.integers(0, ds.n_triples, 200)]
    op = rng.integers(-1, 6, 200).astype(np.int32)
    batch = eng.ServeBatch(op, rows[:, 0].astype(np.int32),
                           np.where(op >= 3, 0, rows[:, 1]).astype(np.int32),
                           rows[:, 2].astype(np.int32))
    r_gpu = eng.host_result(eng.Engine(st, device=cuda).compile(
        ServeQ(), ExecConfig(cap=8, device="cuda"))(batch))
    r_cpu = eng.host_result(eng.Engine(st.to("cpu"), device="cpu").compile(
        ServeQ(), ExecConfig(cap=8, device="cpu"))(batch))
    for name in eng.RESULT_FIELDS:
        assert np.array_equal(getattr(r_gpu, name), getattr(r_cpu, name)), name


def _wild_preds(rng, n, q, dev):
    fixed = np.array([-1, n, -n - 3, 2 * n + 1], np.int32)
    rest = rng.integers(0, n, q - fixed.size).astype(np.int32)
    return torch.from_numpy(np.concatenate([fixed, rest])).to(dev)


@pytest.mark.parametrize("cap", [2, 16, 4096])
def test_k2_range_kernel(store, cap, cuda):
    st, _ = store
    f, meta = st.forest, st.meta
    preds = _wild_preds(np.random.default_rng(cap), st.n_preds, 24, cuda)
    n0 = ops.LAUNCHES["k2_range"]
    got = ops.k2_range(meta, f, preds, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_range"] == n0 + 1
    want = ref.k2_range_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                            f.level_start, preds, cap=cap)
    _equal(got, want)
    if cap == 2:
        assert got[4].any()  # more than two root children are set somewhere
    if cap == 4096:
        assert not got[4].any()


@pytest.mark.parametrize("cap_x,cap_y", [(3, 2), (32, 8)])
def test_k2_scan_rebind_kernel(store, cap_x, cap_y, cuda):
    st, ds = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(cap_x)
    q = 40
    rows = ds.ids[rng.integers(0, ds.n_triples, q)]
    axes1 = _lanes(rng, q, 0, 2, cuda)
    preds1 = torch.from_numpy((rows[:, 1] - 1).astype(np.int32)).to(cuda)
    keys1 = torch.from_numpy(np.where(
        axes1.cpu().numpy() == 0, rows[:, 0] - 1, rows[:, 2] - 1).astype(np.int32)).to(cuda)
    keys1[::5] = _lanes(rng, keys1[::5].shape[0], -9, meta.side + 9, cuda)
    preds2 = _wild_preds(rng, st.n_preds, q, cuda)
    axes2 = _lanes(rng, q, 0, 2, cuda)
    n0 = ops.LAUNCHES["k2_scan_rebind"]
    got = ops.k2_scan_rebind(meta, f, preds1, keys1, axes1, preds2, axes2,
                             cap_x=cap_x, cap_y=cap_y)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_scan_rebind"] == n0 + 1
    want = ref.k2_scan_rebind_ref(meta, f.t_words, f.t_rank, f.l_words,
                                  f.ones_before, f.level_start, preds1, keys1,
                                  axes1, preds2, axes2, cap_x=cap_x, cap_y=cap_y)
    _equal(got, want)
    assert (~got[1]).any()  # dead X slots are compared too


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_pred_gather_kernel(store, cap, cuda):
    st, _ = store
    dev, pmeta = st.pred_index.select("fixed")
    assert pmeta.bytes_per_pred == (1 if st.n_preds < 256 else 2)
    rng = np.random.default_rng(5)
    rows = _lanes(rng, 500, 0, st.n_subjects + st.n_objects, cuda)
    n0 = ops.LAUNCHES["pred_gather"]
    got = ops.pred_gather(pmeta, dev, rows, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pred_gather"] == n0 + 1
    want = ref.pred_gather_ref(rows, dev.offsets, dev.words,
                               bytes_per_pred=pmeta.bytes_per_pred, cap=cap)
    _equal(got, want)


def test_patterns_and_joins_on_card_match_cpu(store, cuda):
    st, ds = store
    gpu = eng.Engine(st, device=cuda)
    cpu = eng.Engine(st.to("cpu"), device="cpu")
    s, p, o = (int(v) for v in ds.ids[17])
    queries = [
        TriplePatternQ(s, "?p", "?o"), TriplePatternQ("?s", "?p", o),
        TriplePatternQ(s, "?p", o), TriplePatternQ("?s", p, "?o"),
        TriplePatternQ("?s", "?p", "?o"),
        JoinQ("D", "s", "s", p1=p, c1=o, p2=p), JoinQ("E", "s", "s", p1=p, c1=o),
        JoinQ("F", "s", "o", c1=o), JoinQ("C", "s", "o", c1=o, c2=s),
    ]
    for layout in ("dac", "fixed"):
        for q in queries:
            kw = dict(cap=1024, cap_y=64, pred_index_layout=layout)
            a = gpu.compile(q, ExecConfig(device="cuda", **kw))()
            b = cpu.compile(q, ExecConfig(device="cpu", **kw))()
            _same_answer(a, b)


def _same_answer(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same_answer(a[k], b[k])
    elif isinstance(b, bool):
        assert a == b
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_popcount_kernel(cuda):
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.integers(0, 2**32, (40, 1024), dtype=np.uint32).view(np.int32)).to(cuda)
    n0 = ops.LAUNCHES["popcount"]
    got = ops.popcount(w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["popcount"] == n0 + 1
    _equal((got,), (ref.popcount_ref(w),))
    # an arena view that is not 16-byte aligned is copied to an aligned one
    flat = w.reshape(-1)[1:1 + 8 * 128].reshape(8, 128)
    _equal((ops.popcount(flat),), (ref.popcount_ref(flat),))


@pytest.mark.parametrize("ca,cb", [(2048, 1), (2048, 3), (4096, 1024), (8192, 262144)])
def test_sorted_intersect_mask_kernel(ca, cb, cuda):
    rng = np.random.default_rng(ca + cb)
    span = 4 * cb + 100_000
    b = np.sort(rng.choice(span, cb, replace=False) - span // 2).astype(np.int32)
    b[cb // 2:cb // 2 + min(cb // 4, 9)] = b[cb // 2]  # repeated values
    a = np.concatenate([rng.choice(b, ca // 4), rng.integers(-span, span, ca // 2)])
    a = np.unique(a).astype(np.int32)
    a = np.concatenate([a, np.full(ca - a.size, 2**31 - 1, np.int32)])
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    n0 = ops.LAUNCHES["sorted_intersect_mask"]
    got = ops.sorted_intersect_mask(ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sorted_intersect_mask"] == n0 + 1
    _equal((got,), (ref.sorted_intersect_mask_ref(ta, tb),))
    assert np.array_equal(got.cpu().numpy(), np.isin(a, b) & (a != 2**31 - 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blocks", [(128, 128, 128), (256, 64, 128), (64, 32, 64)])
def test_block_spmm_kernel(dtype, blocks, cuda):
    bm, bk, bd = blocks
    m, k, d = 512, 768, 256
    g = torch.Generator(device=cuda).manual_seed(7)
    mask = (torch.rand((m // bm, k // bk), generator=g, device=cuda) < 0.4).to(torch.int32)
    mask[0, 0] = -1
    mask[-1, -1] = 0
    a = (torch.rand((m, k), generator=g, device=cuda) < 0.05).to(dtype)
    a[-bm:, -bk:] = float("nan")  # a masked-off tile
    x = torch.randn((k, d), generator=g, device=cuda).to(dtype)
    n0 = ops.LAUNCHES["block_spmm"]
    got = ops.block_spmm(mask, a, x, block_m=bm, block_k=bk, block_d=bd)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_spmm"] == n0 + 1
    want = ref.block_spmm_ref(mask, a, x, bm, bk)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    on = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1) != 0
    absprod = torch.where(on, a.float().abs(), 0.0) @ x.float().abs()
    assert ((got - want).abs() <= k * 2.0**-24 * absprod + 1e-6).all()


def _spmm_limits(mask, a, x, bm, bk, got, want):
    """``chip_smoke.spmm_check``'s limits: ``K·2^-24·(|A|@|X|) + 1e-6`` and
    the statistical ``sqrt(K)·2^-24·(|A|@|X|) + 1e-6``."""
    on = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1) != 0
    absprod = torch.where(on, a.float().abs(), 0.0) @ x.float().abs()
    err = (got - want).abs()
    k = a.shape[1]
    assert (err <= k * 2.0**-24 * absprod + 1e-6).all()
    assert (err <= k**0.5 * 2.0**-24 * absprod + 1e-6).all()


# (M, K, D, (BM, BK, BD), dtype, the variant block_spmm_variant must pick)
SPMM_CASES = [
    (512, 768, 256, (128, 128, 128), torch.bfloat16, ("wgmma", 64, 64, 64, 160)),
    (512, 768, 64, (64, 64, 64), torch.bfloat16, ("wgmma", 64, 64, 64, 160)),
    (512, 768, 192, (256, 64, 64), torch.bfloat16, ("wgmma", 64, 64, 64, 160)),
    (512, 768, 192, (64, 32, 64), torch.bfloat16, ("wgmma", 64, 64, 16, 160)),
    (16384, 256, 256, (128, 64, 128), torch.bfloat16, ("wgmma", 128, 256, 64, 288)),
    (16384, 256, 256, (128, 16, 128), torch.bfloat16, ("wgmma", 128, 256, 16, 288)),
    (16384, 256, 128, (128, 128, 128), torch.bfloat16, ("wgmma", 128, 128, 64, 288)),
    (4096, 256, 512, (64, 128, 128), torch.bfloat16, ("wgmma", 64, 256, 64, 160)),
    (4096, 256, 256, (64, 128, 128), torch.bfloat16, ("wgmma", 64, 128, 64, 160)),
    (512, 768, 256, (128, 128, 128), torch.float32, ("fma", 64, 64, 32, 256)),
    (512, 768, 192, (64, 16, 64), torch.float32, ("fma", 64, 64, 16, 256)),
    (16384, 256, 256, (128, 64, 128), torch.float32, ("fma", 64, 64, 32, 64)),
    (16384, 256, 256, (64, 16, 64), torch.float32, ("fma", 64, 64, 16, 64)),
    (240, 120, 96, (48, 24, 96), torch.bfloat16, ("simt", 128, 128, 16, 256)),
    (240, 120, 96, (48, 24, 96), torch.float32, ("simt", 128, 128, 16, 256)),
]


@pytest.mark.parametrize("tiles", ["random", "all off", "one on"])
@pytest.mark.parametrize("case", range(len(SPMM_CASES)))
def test_block_spmm_variants(case, tiles, cuda):
    m, k, d, (bm, bk, bd), dtype, variant = SPMM_CASES[case]
    if torch.cuda.get_device_properties(cuda).multi_processor_count != 132:
        pytest.skip("the expected tiles assume an H100's 132 SMs")
    g = torch.Generator(device=cuda).manual_seed(case)
    shape = (m // bm, k // bk)
    if tiles == "random":
        mask = (torch.rand(shape, generator=g, device=cuda) < 0.4).to(torch.int32)
        mask[0, 0], mask[-1, -1] = -3, 0
    else:
        mask = torch.zeros(shape, dtype=torch.int32, device=cuda)
        if tiles == "one on":
            mask[shape[0] // 2, shape[1] // 2] = 1
    a = (torch.rand((m, k), generator=g, device=cuda) < 0.05).to(dtype)
    x = torch.randn((k, d), generator=g, device=cuda).to(dtype)
    off = (mask == 0).nonzero()
    i, j = (int(v) for v in off[-1])
    a[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk] = float("nan")  # a masked-off tile
    kw = dict(block_m=bm, block_k=bk, block_d=bd)
    assert ops.block_spmm_variant(a, x, **kw) == variant
    n0 = ops.LAUNCHES["block_spmm"]
    got = ops.block_spmm(mask, a, x, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["block_spmm"] == n0 + 1
    want = ref.block_spmm_ref(mask, a, x, bm, bk)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    _spmm_limits(mask, a, x, bm, bk, got, want)
    if tiles == "all off":
        assert not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_spmm_unaligned_view(dtype, cuda):
    """A and X as views 2 elements into their buffers take the SIMT kernel."""
    m, k, d = 256, 256, 128
    g = torch.Generator(device=cuda).manual_seed(9)
    buf_a = torch.randn(m * k + 2, generator=g, device=cuda).to(dtype)
    buf_x = torch.randn(k * d + 2, generator=g, device=cuda).to(dtype)
    a, x = buf_a[2:].view(m, k), buf_x[2:].view(k, d)
    mask = torch.tensor([[1, 0], [-1, 1]], dtype=torch.int32, device=cuda)
    assert a.data_ptr() % 16 and ops.block_spmm_variant(a, x)[0] == "simt"
    got = ops.block_spmm(mask, a, x)
    _spmm_limits(mask, a, x, 128, 128, got, ref.block_spmm_ref(mask, a, x))


@pytest.fixture(scope="module")
def skewed_forest(cuda):
    """Four trees of one 4096-side geometry: 200,000 pairs, 1,500, 15, none."""
    from repro_torch.core import k2forest, k2tree

    meta = k2tree.K2Meta(k2tree.hybrid_ks(4096))
    rng = np.random.default_rng(21)
    coords = []
    for n in (200_000, 1_500, 15, 0):
        cells = rng.choice(4096 * 4096, n, replace=False)
        coords.append((cells // 4096, cells % 4096))
    f, _ = k2forest.build_forest(coords, meta, cuda)
    return meta, f


@pytest.mark.parametrize("cap", [8, 1000, 1 << 18])
def test_k2_range_skewed_lanes(skewed_forest, cap, cuda):
    """Lanes of 200,000 and 15 pairs in one launch; cap 8 cuts level 0 (16
    root children set), 1000 a middle level, 2^18 nothing."""
    meta, f = skewed_forest
    preds = torch.tensor([0, 1, 2, 3, 0, -4, 7, 2], dtype=torch.int32, device=cuda)
    n0 = ops.LAUNCHES["k2_range"]
    got = ops.k2_range(meta, f, preds, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_range"] == n0 + 1
    want = ref.k2_range_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                            f.level_start, preds, cap=cap)
    _equal(got, want)
    count, overflow = got[3].tolist(), got[4].tolist()
    assert count[:4] == [min(n, cap) for n in (200_000, 1_500, 15, 0)]
    assert overflow[:4] == [cap < 200_000, cap < 1_500, cap < 15, False]


def _scan_both(meta, f, preds, keys, axes, cap):
    n0 = ops.LAUNCHES["k2_scan"]
    got = ops.k2_scan(meta, f, preds, keys, axes, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_scan"] == n0 + 1
    want = ref.k2_scan_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                           f.level_start, preds, keys, axes, cap=cap)
    _equal(got, want)
    return got


@pytest.fixture(scope="module")
def wide_forest(cuda):
    """One tree (P=1) of the 4096-side geometry: rows 5 and 4000 and columns
    9 and 4095 full, plus 2,000 random cells, so a lane's frontier reaches
    4,096 nodes: far above a warp and the shared-memory slab."""
    from repro_torch.core import k2forest, k2tree

    meta = k2tree.K2Meta(k2tree.hybrid_ks(4096))
    rng = np.random.default_rng(31)
    full = np.arange(4096)
    rows = np.concatenate([np.full(4096, 5), np.full(4096, 4000), full, full,
                           rng.integers(0, 4096, 2000)])
    cols = np.concatenate([full, full, np.full(4096, 9), np.full(4096, 4095),
                           rng.integers(0, 4096, 2000)])
    cells = np.unique(rows * 4096 + cols)
    f, _ = k2forest.build_forest([(cells // 4096, cells % 4096)], meta, cuda)
    return meta, f


@pytest.mark.parametrize("cap", [1, 31, 32, 33, 64, 127, 128, 129, 255, 256, 257, 4096, 5000])
def test_k2_scan_wide_frontier(wide_forest, cap, cuda):
    """Full rows and columns at caps around a warp (32), a round (128
    candidates) and the shared-memory slab (256 entries), exactly the
    frontier (4096) and above it; P=1 with predicates and keys out of range
    on both sides; Q=33, not a multiple of the lanes a block."""
    meta, f = wide_forest
    rng = np.random.default_rng(cap)
    keys = np.concatenate([[5, 9, 4000, 4095, 5, 9, -1, 4096, -5000, 9000],
                           rng.integers(0, 4096, 23)]).astype(np.int32)
    axes = np.concatenate([[0, 1, 0, 1, 1, 0, 0, 1, 0, 1],
                           rng.integers(0, 2, 23)]).astype(np.int32)
    preds = np.concatenate([[0, -1, 3, -7, 0, 0, 0, 0, 2, -2],
                            rng.integers(-3, 4, 23)]).astype(np.int32)
    got = _scan_both(meta, f, *(torch.from_numpy(a).to(cuda) for a in (preds, keys, axes)),
                     cap)
    count, overflow = got[2].tolist(), got[3].tolist()
    assert count[:4] == [min(4096, cap)] * 4
    assert overflow[:4] == [cap < 4096] * 4
    assert torch.equal(got[0][0, :count[0]].cpu(), torch.arange(count[0], dtype=torch.int32))


def test_k2_scan_rebind_wide_frontier(wide_forest, cuda):
    """X = the first 300 columns of full row 5 (beyond the slab), each
    re-bound as a column scan at cap_y 260: column 9's 4,096 rows overflow
    it, and the dead X slots of a short lane copy its key-0 scan."""
    meta, f = wide_forest
    t = lambda v: torch.tensor(v, dtype=torch.int32, device=cuda)  # noqa: E731
    preds1, keys1, axes1 = t([0, 0, 0]), t([5, 77, -3]), t([0, 1, 0])
    preds2, axes2 = t([0, -1, 0]), t([1, 0, 1])
    got = ops.k2_scan_rebind(meta, f, preds1, keys1, axes1, preds2, axes2,
                             cap_x=300, cap_y=260)
    torch.cuda.synchronize()
    want = ref.k2_scan_rebind_ref(meta, f.t_words, f.t_rank, f.l_words,
                                  f.ones_before, f.level_start, preds1, keys1,
                                  axes1, preds2, axes2, cap_x=300, cap_y=260)
    _equal(got, want)
    assert bool(got[3][0]) and bool(got[7][0, 9]) and (~got[1][1]).any()


@pytest.mark.parametrize("cap", [8, 64, 1000])
def test_k2_scan_skewed_lanes(skewed_forest, cap, cuda):
    """Lanes of the 200,000 / 1,500 / 15 / 0-pair trees mixed in one launch."""
    meta, f = skewed_forest
    rng = np.random.default_rng(cap)
    q = 300
    preds = _lanes(rng, q, -6, 8, cuda)
    keys = _lanes(rng, q, -3, 4100, cuda)
    axes = _lanes(rng, q, 0, 2, cuda)
    got = _scan_both(meta, f, preds, keys, axes, cap)
    # a line of the dense tree holds ~49 cells; its frontier has 256 nodes
    # at the 16-side level, so caps 8 and 64 overflow there, 1000 nowhere
    dense = (bitvec.row_index(preds, 4) == 0) & (keys >= 0) & (keys < 4096)
    if cap == 1000:
        assert bool((got[2][dense] > 20).all()) and not bool(got[3][dense].any())
    else:
        assert bool(got[3][dense].all())


@pytest.mark.parametrize("q", [1, 7, 33, 300, 301])
def test_k2_scan_lane_counts(store, q, cuda):
    """Batches of 1, 7, 33, 300 and 301 lanes (4 a block): 1, 7, 33 and 301
    end in a partial block."""
    st, ds = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(q)
    rows = ds.ids[rng.integers(0, ds.n_triples, q)]
    axes = _lanes(rng, q, 0, 2, cuda)
    preds = torch.from_numpy((rows[:, 1] - 1).astype(np.int32)).to(cuda)
    keys = torch.from_numpy(np.where(axes.cpu().numpy() == 0, rows[:, 0] - 1,
                                     rows[:, 2] - 1).astype(np.int32)).to(cuda)
    got = _scan_both(meta, f, preds, keys, axes, 16)
    assert bool((got[2] > 0).all())  # every lane holds its own triple


def test_k2_scan_rebind_beyond_resident_warps(store, cuda):
    """48 × 256 = 12,288 Y lanes: more than the grid's warps, so warps run
    several lanes each; nearly every X slot is dead."""
    st, ds = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(48)
    q, cap_x, cap_y = 48, 256, 8
    rows = ds.ids[rng.integers(0, ds.n_triples, q)]
    axes1 = _lanes(rng, q, 0, 2, cuda)
    preds1 = torch.from_numpy((rows[:, 1] - 1).astype(np.int32)).to(cuda)
    keys1 = torch.from_numpy(np.where(axes1.cpu().numpy() == 0, rows[:, 0] - 1,
                                      rows[:, 2] - 1).astype(np.int32)).to(cuda)
    preds2 = _wild_preds(rng, st.n_preds, q, cuda)
    axes2 = _lanes(rng, q, 0, 2, cuda)
    blocks, _ = ops._scan_grid("k2_scan_rebind", cuda, q * cap_x, cap_y)
    assert ops._scan_grid("k2_scan_rebind", cuda, 2 * q * cap_x, cap_y)[0] == blocks
    got = ops.k2_scan_rebind(meta, f, preds1, keys1, axes1, preds2, axes2,
                             cap_x=cap_x, cap_y=cap_y)
    torch.cuda.synchronize()
    want = ref.k2_scan_rebind_ref(meta, f.t_words, f.t_rank, f.l_words,
                                  f.ones_before, f.level_start, preds1, keys1,
                                  axes1, preds2, axes2, cap_x=cap_x, cap_y=cap_y)
    _equal(got, want)
    assert (~got[1]).float().mean() > 0.9


def test_k2_scan_repeated_lanes(store, cuda):
    """20,000 lanes in runs of equal (pred, key, axis), as join F's flat scan
    sends them, so a warp's run of lanes repeats scans; runs that differ
    only in the axis, in the key, or in a predicate that wraps to the same
    tree (-1 and P - 1) sit side by side."""
    st, ds = store
    f, meta = st.forest, st.meta
    rng = np.random.default_rng(20)
    rows = ds.ids[rng.integers(0, ds.n_triples, 2000)]
    preds, keys, axes = [], [], []
    for r in rows:
        length = int(rng.integers(1, 40))
        p, axis = int(r[1]) - 1, int(rng.integers(0, 2))
        key = int(r[0] if axis == 0 else r[2]) - 1
        for p_, k_, a_ in ((p, key, axis), (p - st.n_preds, key, axis),
                           (p, key, 1 - axis), (p, key + 1, axis)):
            preds += [p_] * length
            keys += [k_] * length
            axes += [a_] * length
    t = lambda v: torch.tensor(v[:20_000], dtype=torch.int32, device=cuda)  # noqa: E731
    got = _scan_both(meta, f, t(preds), t(keys), t(axes), 8)
    assert bool((got[2] > 0).any())


def _tree_cells(ds, n_preds):
    """Per tree p, the (row, col) cells of predicate p + 1."""
    ids = ds.ids
    return [(ids[ids[:, 1] == p + 1, 0] - 1, ids[ids[:, 1] == p + 1, 2] - 1)
            for p in range(n_preds)]


def _death_levels(meta, cells, p, rows, cols):
    """Per lane of tree p[i] at in-range (rows[i], cols[i]): the level whose
    bit is the walk's first 0, or H where the cell is set."""
    H = meta.n_levels
    out = np.full(rows.size, H)
    for lvl, sub in enumerate(meta.subsides):
        span = meta.side // sub + 1
        for t in np.unique(p):
            r, c = cells[t]
            present = np.unique(r // sub * span + c // sub)
            lane = p == t
            miss = ~np.isin(rows[lane] // sub * span + cols[lane] // sub, present)
            out[lane] = np.where((out[lane] == H) & miss, lvl, out[lane])
    return out


def _near_misses(meta, cells, rng, per_tree):
    """(p, rows, cols): set cells, and the same cells with the column digit
    of one level changed, so that walks stop at every level."""
    ps, rows, cols = [], [], []
    for t, (r, c) in enumerate(cells):
        if r.size == 0:
            continue
        pick = rng.integers(0, r.size, per_tree)
        r, c = r[pick], c[pick]
        ps.append(np.full(r.size, t))
        rows.append(r)
        cols.append(c)
        for k, sub in zip(meta.ks, meta.subsides):
            d = (c // sub) % k
            ps.append(np.full(r.size, t))
            rows.append(r)
            cols.append(c + ((d + rng.integers(1, k, r.size)) % k - d) * sub)
    return (np.concatenate(ps).astype(np.int32), np.concatenate(rows).astype(np.int32),
            np.concatenate(cols).astype(np.int32))


def _check_both(meta, f, preds, rows, cols, dev):
    preds, rows, cols = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                         for a in (preds, rows, cols))
    n0 = ops.LAUNCHES["k2_check"]
    got = ops.k2_check(meta, f, preds, rows, cols)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        assert ops.LAUNCHES["k2_check"] == n0 + 1
    want = ref.k2_check_ref(meta, f.t_words, f.t_rank, f.l_words, f.ones_before,
                            f.level_start, preds, rows, cols)
    assert torch.equal(got, want)
    return got.cpu().numpy()


def _check_every_level(meta, f, cells, rng, dev):
    """Walks that stop at each level 0..H-1 and walks that find their cell,
    beside predicates out of range on both sides (wrapped once, then
    clipped) and negative or too-large coordinates, through both kernels."""
    P = len(cells)
    p, rows, cols = _near_misses(meta, cells, rng, 24)
    death = _death_levels(meta, cells, p, rows, cols)
    assert set(death.tolist()) == set(range(meta.n_levels + 1)), np.bincount(death)
    wild = 64
    wp = np.concatenate([[-1, P, -P - 3, 2 * P + 1, -P], rng.integers(-2 * P, 2 * P, wild - 5)])
    wr = rng.integers(-meta.side, 2 * meta.side, wild)
    wr[:4] = [-1, meta.side, -2**31, 2**31 - 1]
    wc = rng.integers(-meta.side, 2 * meta.side, wild)
    lanes = [np.concatenate([p, wp]), np.concatenate([rows, wr]), np.concatenate([cols, wc])]
    # both kernels: a warp a lane (batches of up to 8 warps an SM), a thread a lane
    warp_max = 8 * (ops._sm_count(dev) if dev.type == "cuda" else 132)
    reps = -(-(warp_max + 1) // lanes[0].size)
    hit = _check_both(meta, f, *(np.tile(a, reps) for a in lanes), dev)[:lanes[0].size]
    for lo in range(0, lanes[0].size, warp_max):
        part = _check_both(meta, f, *(a[lo:lo + warp_max] for a in lanes), dev)
        assert np.array_equal(part, hit[lo:lo + warp_max])
    assert np.array_equal(hit[:p.size], death == meta.n_levels)


def test_k2_check_stops_at_every_level(store, cuda):
    """The 16-predicate trees span 39 words, so walks cross from the warp
    kernel's register copy of a tree's first 32 words to memory; the
    600-predicate trees span 8, all of them in the copy."""
    st, ds = store
    assert (st.forest.t_words.shape[1] > 32) == (st.n_preds == 16)
    rng = np.random.default_rng(5)
    _check_every_level(st.meta, st.forest, _tree_cells(ds, st.n_preds), rng, cuda)


@pytest.mark.parametrize("ks", [(4, 4, 2, 2, 2), (3, 3, 3, 3, 3), (4, 4, 4, 4, 4, 2, 2)])
def test_k2_check_tree_geometries(ks, cuda):
    """Hybrid arities (k = 4, then 2), a side that is no power of two
    (k = 3: the digits take the division path), and one tree (P = 1), each
    of more than 32 words.  Columns lie in the first root column band, so
    walks can stop at level 0."""
    from repro_torch.core import k2forest, k2tree

    meta = k2tree.K2Meta(ks)
    rng = np.random.default_rng(len(ks))
    band = meta.side // ks[0]
    cells = []
    for n in (40,) if len(ks) == 7 else (3000, 40, 1, 500, 0):
        cell = rng.choice(meta.side * band, n, replace=False)
        cells.append((cell // band, cell % band))
    f, _ = k2forest.build_forest(cells, meta, cuda)
    assert f.t_words.shape[1] > 32
    _check_every_level(meta, f, cells, rng, cuda)


@pytest.mark.parametrize("q", [1, 31, 32, 33, 3584])
def test_k2_check_lane_counts(store, q, cuda):
    """Batches of 1, 31, 32, 33 lanes (a warp a lane, 1 to 4 a block) and
    3,584 (the serve step's checks of 256 S?PO lanes × 14 candidates: a
    thread a lane)."""
    st, ds = store
    rng = np.random.default_rng(q)
    rows = ds.ids[rng.integers(0, ds.n_triples, q)]
    o = rows[:, 2] - 1
    o[1::2] = rng.integers(0, st.meta.side, o[1::2].size)
    hit = _check_both(st.meta, st.forest, rows[:, 1] - 1, rows[:, 0] - 1, o, cuda)
    assert hit[::2].all()


@pytest.fixture(scope="module")
def deep_index(cuda):
    """600 predicates; subjects 1-6 hold 70, 45, 33, 32, 31 and 1 of them,
    spread over all 600 so that gaps pass 255 (a two-level DAC); subject 7
    none; 2,000 random triples of subjects 8-150 fill the rest."""
    rng = np.random.default_rng(41)
    rows = []
    for s, n in zip(range(1, 7), (70, 45, 33, 32, 31, 1)):
        preds = np.sort(rng.choice(np.arange(1, 601), n, replace=False))
        rows.append(np.stack([np.full(n, s), preds, rng.integers(1, 201, n)], 1))
    rows.append(np.stack([rng.integers(8, 151, 2000), rng.integers(1, 601, 2000),
                          rng.integers(1, 201, 2000)], 1))
    ids = np.unique(np.concatenate(rows), axis=0)
    return k2triples.from_id_triples(ids, n_so=0, n_subjects=150, n_objects=200,
                                     n_preds=600, device=cuda)


def _dac_both(st, rows, cap):
    index, pmeta = st.pred_index.select("dac")
    rows = torch.from_numpy(np.asarray(rows, np.int32)).to(index.words.device)
    n0 = ops.LAUNCHES["pred_gather_dac"]
    got = ops.pred_gather_dac(pmeta, index, rows, cap=cap)
    if rows.is_cuda:
        torch.cuda.synchronize()
        assert ops.LAUNCHES["pred_gather_dac"] == n0 + 1
    want = ref.pred_gather_dac_ref(
        rows, index.offsets, index.words, index.degs, index.flags, index.frank,
        levels=pmeta.levels, level_byte_start=pmeta.level_byte_start,
        flag_word_start=pmeta.flag_word_start, deg_width=pmeta.deg_width,
        rows_per_block=pmeta.rows_per_block, cap=cap,
    )
    _equal(got, want)
    return pmeta, got


def _all_rows(st, rng):
    """Every row of the index (degree 0, the first and last of each block,
    the index's last rows), rows past its end and below 0 (clipped as the
    reference clips them), in a shuffled order."""
    n = st.n_subjects + st.n_objects
    return rng.permutation(np.concatenate([np.arange(n), [n, n + 7, -1, -33]]))


@pytest.mark.parametrize("cap", [1, 14, 31, 32, 33, 40])
def test_pred_gather_dac_every_row(store, cap, cuda):
    st, _ = store
    pmeta, got = _dac_both(st, _all_rows(st, np.random.default_rng(cap)), cap)
    count = got[2].cpu().numpy()
    assert (count == 0).any() and (count == min(cap, pmeta.max_degree)).any()
    if st.n_preds == 600:
        assert pmeta.levels >= 2


@pytest.mark.parametrize("cap", [1, 14, 31, 32, 33, 40, 64, 70, 96])
def test_pred_gather_dac_long_rows(deep_index, cap, cuda):
    """Rows of 70, 45, 33, 32, 31, 1 and 0 predicates in a two-level DAC:
    the gap sum carries across chunks of 32 slots, and rows end or
    overflow on either side of a chunk's edge."""
    rows = _all_rows(deep_index, np.random.default_rng(cap))
    pmeta, got = _dac_both(deep_index, rows, cap)
    assert pmeta.levels >= 2 and pmeta.max_degree == 70
    count, overflow = got[2].cpu().numpy(), got[3].cpu().numpy()
    lanes = [int(np.nonzero(rows == s - 1)[0][0]) for s in range(1, 8)]
    assert count[lanes].tolist() == [min(d, cap) for d in (70, 45, 33, 32, 31, 1, 0)]
    assert overflow[lanes].tolist() == [d > cap for d in (70, 45, 33, 32, 31, 1, 0)]
