"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: the fixture below decides at run time whether a card is
present and skips otherwise, so every worker collects the same tests.  On
the card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import bitvec, engine as eng, k2triples, predindex
from repro_torch.core.query import (
    BgpQ, ExecConfig, JoinQ, SelectQ, ServeQ, TriplePatternQ,
)
from repro_torch.data import rdf
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _small_store(n_preds, dev):
    # at 600 predicates these lists hold gaps > 255: a two-level DAC
    ds = rdf.generate(2500, n_subjects=150, n_preds=n_preds, n_objects=150,
                      pred_alpha=1.0, seed=11)
    st = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
        n_preds=ds.n_preds, device=dev,
    )
    return st, ds


@pytest.fixture(scope="module", params=[16, 600])
def store(request, cuda):
    return _small_store(request.param, cuda)


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


def _select_queries(ds):
    from repro_torch.core.algebra import Cmp

    s, p, o = (int(v) for v in ds.ids[17])
    return [
        SelectQ(where=(TriplePatternQ(s, p, "?o"),),
                optional=((TriplePatternQ(s, 2, "?x"),),), order_by=("?o",), limit=16),
        SelectQ(where=(TriplePatternQ("?s", p, o), TriplePatternQ("?s", "?q", "?x"))),
        SelectQ(where=(TriplePatternQ(s, p, "?y"), TriplePatternQ("?y", "?q", "?z"))),
        SelectQ(union=((TriplePatternQ(s, p, "?o"),), (TriplePatternQ(s, "?q", "?o"),)),
                filter=(Cmp(">", "?o", 5),)),
        SelectQ(where=(TriplePatternQ(s, p, "?c"), TriplePatternQ("?e", 1, "?g")),
                order_by=("-?g",), limit=50),
        BgpQ(((s, "?p", "?y"), ("?y", None, None))),
    ]


def test_select_path_on_card_matches_cpu(store, cuda):
    """SELECT/BGP plans through the kernels (``k2_scan``, ``k2_check``,
    ``k2_range``) equal the same plans on the CPU, column for column."""
    st, ds = store
    gpu = eng.Engine(st, device=cuda)
    cpu = eng.Engine(st.to("cpu"), device="cpu")
    n0 = dict(ops.LAUNCHES)
    for q in _select_queries(ds):
        a = gpu.compile(q, ExecConfig(cap=64, device="cuda"))()
        b = cpu.compile(q, ExecConfig(cap=64, device="cpu"))()
        _same_answer(a, b)
    for k in ("k2_scan", "k2_check", "k2_range"):
        assert ops.LAUNCHES[k] > n0[k], k


def test_broker_selects_on_card_from_worker_threads(store, cuda):
    """SELECTs run in the broker's worker threads beside the serve loop;
    their tensors land on the engine's device and the answers equal the
    CPU plans'."""
    import asyncio

    from repro_torch.launch.broker import ServeBroker

    st, ds = store
    gpu = eng.Engine(st, device=cuda)
    cpu = eng.Engine(st.to("cpu"), device="cpu")
    qs = _select_queries(ds)[:4]
    lanes = [(eng.OP_CHECK, int(r[0]), int(r[1]), int(r[2])) for r in ds.ids[:64]]

    async def main():
        async with ServeBroker(gpu, ExecConfig(cap=64, device="cuda")) as b:
            futs = [b.submit_nowait("lanes", *q) for q in lanes]
            sel = [b.submit_select(f"t{i}", q) for i, q in enumerate(qs)]
            return await asyncio.gather(*futs), await asyncio.gather(*sel)

    got_lanes, got_sel = asyncio.run(main())
    assert all(got_lanes)
    for g, q in zip(got_sel, qs):
        _same_answer(g, cpu.compile(q, ExecConfig(cap=64, device="cpu"))())


# --- the dynamic store on the card -----------------------------------------

_APPENDED_SCRIPT = """
import sys
import numpy as np
import torch
sys.path.insert(0, "src")
from repro_torch.core import delta, engine as eng, k2triples
from repro_torch.core.query import ExecConfig, JoinQ, ServeQ, TriplePatternQ
from repro_torch.data import rdf

ds = rdf.generate(2500, n_subjects=150, n_preds=16, n_objects=150, seed=11)
kw = dict(n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects, n_preds=ds.n_preds)
E, P = max(ds.n_subjects, ds.n_objects), ds.n_preds
stores = [delta.DynamicStore(k2triples.from_id_triples(ds.ids, device=d, **kw))
          for d in ("cuda", "cpu")]
rng = np.random.default_rng(3)
writes = [(int(rng.integers(1, E + 9)), int(rng.integers(1, P + 3)), int(rng.integers(1, E + 9)))
          for _ in range(400)]
writes += [(E + 1, P + 1, E + 2), (E + 2, P + 2, 3), (5, P + 1, E + 8)]
for st in stores:
    for t in writes:
        st.insert(*t)
    for t in ds.ids[::7][:100].tolist():
        st.delete(*t)
gpu, cpu = (eng.Engine(st, device=st.device) for st in stores)
n = 512
lanes = np.stack([rng.integers(-1, 6, n), rng.integers(-3, E + 12, n), rng.integers(-2, P + 5, n),
                  rng.integers(-3, E + 12, n)]).astype(np.int32)
for cap in (1, 8, 1024):
    a = gpu.compile(ServeQ(), ExecConfig(cap=cap, device="cuda"))(eng.ServeBatch(*lanes))
    b = cpu.compile(ServeQ(), ExecConfig(cap=cap, device="cpu"))(eng.ServeBatch(*lanes))
    for f in eng.RESULT_FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f))), f
pairs = {"p": np.arange(0, P + 4)}
q = TriplePatternQ("?s", 1, "?o")
a = gpu.compile(q, ExecConfig(cap=4096, device="cuda"))(pairs)
b = cpu.compile(q, ExecConfig(cap=4096, device="cpu"))(pairs)
assert all(np.array_equal(x, y) for x, y in zip(a, b)) and len(a[P + 1]) > 0
for q in (TriplePatternQ("?s", "?p", "?o"), TriplePatternQ(E + 1, None, None),
          JoinQ("C", "s", "o", c1=E + 2, c2=3), JoinQ("F", "o", "s", c1=E + 1)):
    a = gpu.compile(q, ExecConfig(cap=4096, device="cuda"))()
    b = cpu.compile(q, ExecConfig(cap=4096, device="cpu"))()
    assert repr(a) == repr(b), q
torch.cuda.synchronize()
print("ok")
"""


def test_appended_range_lanes_no_fault(cuda):
    """Lanes whose ids lie past the static extents (appended entities and
    predicates, negatives too) through every serve op at caps 1, 8 and
    1024, the pair enumeration with delta-only predicates and the dump,
    in a process with ``CUDA_LAUNCH_BLOCKING=1``: no fault, and every
    merged answer equals the CPU engine's on the same dynamic state."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_LAUNCH_BLOCKING="1")
    r = subprocess.run([sys.executable, "-c", _APPENDED_SCRIPT], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-4000:]


def _churned_pair(cuda, seed):
    from repro_torch.core import delta

    ds = rdf.generate(3000, n_subjects=160, n_preds=16, n_objects=160, seed=seed)
    kw = dict(n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
              n_preds=ds.n_preds)
    stores = [delta.DynamicStore(k2triples.from_id_triples(ds.ids, device=d, **kw))
              for d in (cuda, "cpu")]
    rng = np.random.default_rng(seed)
    ext = max(ds.n_subjects, ds.n_objects)
    dels = ds.ids[rng.permutation(ds.ids.shape[0])[:300]].tolist()
    ins = [(int(rng.integers(1, ext + 5)), int(rng.integers(1, ds.n_preds + 2)),
            int(rng.integers(1, ext + 5))) for _ in range(300)]
    for st in stores:
        for t in dels:
            st.delete(*t)
        for t in ins:
            st.insert(*t)
    return stores, ds


def test_cuda_compaction_matches_cpu(cuda):
    """``compact`` of a card store rebuilds on the card and gives the CPU
    compaction's arenas, report and epoch."""
    from repro_torch.core import compaction

    (gpu, cpu), _ = _churned_pair(cuda, 21)
    r_gpu, r_cpu = compaction.compact(gpu), compaction.compact(cpu)
    assert gpu.static.device == cuda and cpu.static.device.type == "cpu"
    fields = ("epoch", "n_triples", "delta_merged", "tombstones_applied")
    assert [getattr(r_gpu, f) for f in fields] == [getattr(r_cpu, f) for f in fields]
    assert "dump_device_ms" in r_gpu.split_ms
    assert gpu.epoch == cpu.epoch == 1
    a, b = gpu.static.forest.numpy(), cpu.static.forest.numpy()
    assert all(np.array_equal(a[k], b[k]) for k in a)
    for layout in ("dac", "fixed"):
        a = gpu.static.pred_index.select(layout)[0].numpy()
        b = cpu.static.pred_index.select(layout)[0].numpy()
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_broker_compaction_from_worker_thread(cuda):
    """Writes through the broker trip a compaction that rebuilds in a
    worker thread on the engine's card while the serve loop keeps reading;
    every read equals the CPU engine's on the same writes."""
    import asyncio

    from repro_torch.core import compaction
    from repro_torch.launch.broker import CoalescePolicy, ServeBroker

    (gpu_st, cpu_st), ds = _churned_pair(cuda, 22)
    gpu, cpu = eng.Engine(gpu_st, device=cuda), eng.Engine(cpu_st, device="cpu")
    rng = np.random.default_rng(5)
    cpu_plan = cpu.compile(ServeQ(), ExecConfig(cap=256, device="cpu"))

    async def main():
        async with ServeBroker(gpu, ExecConfig(cap=256, device=str(cuda)),
                               coalesce=CoalescePolicy(max_batch=64, max_delay_s=1e-3),
                               compaction=compaction.CompactionPolicy(max_delta=700)) as b:
            for rnd in range(12):
                for t in ds.ids[rng.integers(0, ds.ids.shape[0], 20)].tolist():
                    b.submit_insert_nowait("w", t[0], t[1] % 17 + 1, t[2])
                    cpu_st.insert(t[0], t[1] % 17 + 1, t[2])
                rows = ds.ids[rng.integers(0, ds.ids.shape[0], 64)]
                lanes = np.stack([rng.integers(0, 6, 64), rows[:, 0], rows[:, 1], rows[:, 2]]
                                 ).astype(np.int32)
                lanes[2][lanes[0] >= 3] = 0
                got = await asyncio.gather(*(b.submit_nowait("r", *map(int, lanes[:, i]))
                                             for i in range(64)))
                want = eng.host_result(cpu_plan(eng.ServeBatch(*lanes)))
                for i, g in enumerate(got):
                    w = eng.decode_lane(int(lanes[0, i]), want, i)
                    assert repr(_plain(g)) == repr(_plain(w)), (rnd, i)
            await b._compaction_task
            return b.stats()

    st = asyncio.run(main())
    assert st["compactions"] == 1 and st["compaction_errors"] == 0
    assert gpu_st.epoch == 1 and gpu_st.static.device == cuda


def _plain(a):
    if isinstance(a, dict):
        return {int(k): np.asarray(v).tolist() for k, v in a.items()}
    if isinstance(a, (bool, np.bool_)):
        return bool(a)
    return np.asarray(a).tolist()


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


SENTINEL = 2**31 - 1


def _random_intersect(rng, ca, cb):
    """Sorted unique A of members and non-members, SENTINEL-padded to ca,
    in a sorted B of cb ids with a run of repeated values."""
    span = 4 * cb + 100_000
    b = np.sort(rng.choice(span, cb, replace=False) - span // 2).astype(np.int32)
    b[cb // 2:cb // 2 + min(cb // 4, 9)] = b[cb // 2]  # repeated values
    a = np.concatenate([rng.choice(b, ca // 4), rng.integers(-span, span, ca // 2)])
    a = np.unique(a).astype(np.int32)
    return np.concatenate([a, np.full(ca - a.size, SENTINEL, np.int32)]), b


def _spread(rng, ca, cb, span):
    """ca sorted ids over all of a sorted B of cb ids in [0, span), half of
    them members: sparse A in dense B."""
    b = np.sort(rng.choice(span, cb, replace=False)).astype(np.int32)
    a = np.sort(np.concatenate([rng.choice(b, ca // 2), rng.integers(0, span, ca - ca // 2)]))
    return a.astype(np.int32), b


TILE = 1024  # ops.INTERSECT_TILE: A lanes a block of the tile kernel
BIG = 2**18  # A lanes past 1024 an SM: the tile kernel


def _runs(rng):
    """B of 16,000 values, each repeated 20 times; 160 tiles of sorted A
    lanes that start and end on members 100 values apart, so that each
    block's span of B starts and ends in a run and fits the window."""
    vals = np.sort(rng.choice(10**7, 16_000, replace=False))
    ends = vals[::100]
    tiles = []
    for lo, hi in zip(ends, np.append(ends[1:], vals[-1])):
        inner = np.concatenate([rng.choice(vals[(vals > lo) & (vals < hi)], TILE // 2 - 1),
                                rng.integers(lo + 1, hi, TILE // 2 - 1)])
        tiles.append(np.concatenate([[lo], np.sort(inner), [hi]]))
    a = np.concatenate(tiles)
    return np.concatenate([a, np.full(-a.size % 2048, SENTINEL)]).astype(np.int32), \
        np.repeat(vals, 20).astype(np.int32)


def _shuffled(rng, ab):
    return rng.permutation(ab[0]), ab[1]


def _sentinel_blocks(rng):
    """2^18 lanes of which tiles in the middle and at the end hold only
    SENTINEL, in a windowed B."""
    a, b = _random_intersect(rng, BIG, BIG)
    a = np.sort(a[a != SENTINEL][:BIG // 2])
    return np.concatenate([a[:8 * TILE], np.full(2 * TILE, SENTINEL), a[8 * TILE:],
                           np.full(BIG // 2 - 2 * TILE, SENTINEL)]).astype(np.int32), b


def _clustered(rng):
    """2^18 sorted lanes: all but the last tile's in the first 1/64 of a B
    of 2^18 ids, the last tile's 1024 spread over all of it (that block's
    span of B exceeds the window; the shape alone does not tell)."""
    b = np.sort(rng.choice(2**24, BIG, replace=False)).astype(np.int32)
    a = np.concatenate([np.sort(rng.choice(b[:BIG // 64], BIG - TILE)),
                        np.sort(rng.choice(2**24, TILE))])
    return a.astype(np.int32), b


def _int_min(rng, ca, cb):
    a, b = _random_intersect(rng, ca, cb)
    b[0], a[0], a[1] = -2**31, -2**31, -2**31 + 1
    return np.sort(a), b


def _pow2_b1(rng, ca, cb):
    """cb a power of two, A holding b[0], b[1] and b[1] + 1."""
    b = np.sort(rng.choice(10 * cb, cb, replace=False)).astype(np.int32)
    a = np.sort(np.concatenate([b[:2], b[1:2] + 1, rng.integers(0, 10 * cb, ca - 3)]))
    return a.astype(np.int32), b


INTERSECT_CASES = {
    # name: (A lanes and B ids from a seed, the path ops._intersect_plan and
    # the data take on a card of 132 SMs: a thread a lane ("lane"); tiles
    # staging all of B ("whole"), a span of B within the window ("window"),
    # or over it ("global"))
    "2048 in 1": (lambda rng: _random_intersect(rng, 2048, 1), "lane"),
    "2048 in 3": (lambda rng: _random_intersect(rng, 2048, 3), "lane"),
    "4096 in 1024": (lambda rng: _random_intersect(rng, 4096, 1024), "lane"),
    "8192 in 262144": (lambda rng: _random_intersect(rng, 8192, 262144), "lane"),
    "2^18 in 1024": (lambda rng: _random_intersect(rng, BIG, 1024), "whole"),
    "2^18 in 2^18": (lambda rng: _random_intersect(rng, BIG, BIG), "window"),
    "fallback: 2048 spread over 2^20": (lambda rng: _spread(rng, 2048, 2**20, 10**8), "lane"),
    "2^18 spread over 2^21": (lambda rng: _spread(rng, BIG, 2**21, 10**8), "lane"),
    "unsorted A, windowed B": (lambda rng: _shuffled(rng, _random_intersect(rng, BIG, BIG)),
                               "global"),
    "unsorted A, whole B": (lambda rng: _shuffled(rng, _random_intersect(rng, BIG, 1024)),
                            "whole"),
    "unsorted A, a thread a lane": (
        lambda rng: _shuffled(rng, _random_intersect(rng, 2048, 2**19)), "lane"),
    "clustered A, one tile over the window": (_clustered, "global"),
    "all-SENTINEL tiles": (_sentinel_blocks, "window"),
    "empty window": (lambda rng: (np.arange(2**24, 2**24 + BIG, dtype=np.int32),
                                  np.sort(rng.choice(2**23, 2**16, replace=False))
                                  .astype(np.int32)), "window"),
    "runs across the window's ends": (_runs, "window"),
    "a = -2^31, windowed B": (lambda rng: _int_min(rng, BIG, BIG), "window"),
    "a = -2^31, whole B": (lambda rng: _int_min(rng, BIG, 1000), "whole"),
    "a = -2^31, a thread a lane": (lambda rng: _int_min(rng, 2048, 2**20), "lane"),
    "cb 2^18, a == b[1]": (lambda rng: _pow2_b1(rng, BIG, 2**18), "window"),
    "cb 2^20, a == b[1]": (lambda rng: _pow2_b1(rng, 1024, 2**20), "lane"),
    "cb 1024, a == b[1]": (lambda rng: _pow2_b1(rng, BIG, 1024), "whole"),
    "ca 100, below one block": (lambda rng: _random_intersect(rng, 100, 5000), "lane"),
    "ca 1001, a tail block": (lambda rng: _random_intersect(rng, 1001, 500_000), "lane"),
}


def _spans(a, b, tile):
    """The span of B each tile's non-SENTINEL lanes fall in, and the tiles."""
    tiles = np.array_split(a, np.arange(tile, a.size, tile))
    live = [t[t != SENTINEL] for t in tiles]
    return [int(np.searchsorted(b, t.max() + 1) - np.searchsorted(b, t.min()))
            for t in live if t.size], tiles


@pytest.mark.parametrize("case", list(INTERSECT_CASES))
def test_sorted_intersect_mask_kernel(case, cuda):
    make, path = INTERSECT_CASES[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    a, b = make(rng)
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    want = ref.sorted_intersect_mask_ref(ta, tb)
    n0 = ops.LAUNCHES["sorted_intersect_mask"]
    got = ops.sorted_intersect_mask(ta, tb)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sorted_intersect_mask"] == n0 + 1
    _equal((got,), (want,))
    assert np.array_equal(got.cpu().numpy(), np.isin(a, b) & (a != SENTINEL))
    # the path the case is named for, that of a card of 132 SMs
    plan = ops._intersect_plan(a.size, b.size, 132)
    kernel, threads, _, window = plan
    assert kernel == (1 if path == "lane" else 0)
    if path == "whole":
        assert b.size <= window
    elif path in ("window", "global"):
        spans, tiles = _spans(a, b, 4 * threads)
        assert b.size > window and (max(spans) > window) == (path == "global")
        if "SENTINEL" in case:
            assert len(spans) < len(tiles)
    if plan != ops._intersect_plan(a.size, b.size, ops._sm_count(cuda)):
        # another card took another path through the wrapper: take this one too
        named = torch.empty_like(got)
        ops._launch("sorted_intersect_mask", cuda, ta.data_ptr(), a.size, tb.data_ptr(), b.size,
                    named.data_ptr(), *plan)
        _equal((named,), (want,))


@pytest.mark.parametrize("ca", [1, 1001, 150_001])
def test_sorted_intersect_any_ca_either_kernel(ca, cuda):
    """Both kernels launched directly with ca past the wrapper's contract:
    a tail tile, a tail quad, a tail block of lanes, and A and B views one
    id into their tensors (no 16-byte loads), windowed and whole B."""
    rng = np.random.default_rng(ca)
    for cb in (3000, 300_001):
        a, b = _random_intersect(rng, ca + 1, cb + 1)
        ta, tb = torch.from_numpy(a).to(cuda)[1:], torch.from_numpy(b).to(cuda)[1:]
        want = ref.sorted_intersect_mask_ref(ta, tb)
        for plan in ((0, 256, -(-ca // 1024), min(cb, ops.INTERSECT_WINDOW)),
                     (1, 256, -(-ca // 256), 0)):
            got = torch.empty(ca, dtype=torch.bool, device=cuda)
            ops._launch("sorted_intersect_mask", cuda, ta.data_ptr(), ca, tb.data_ptr(), cb,
                        got.data_ptr(), *plan)
            _equal((got,), (want,))


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


@pytest.fixture(scope="module", params=[16, 600, "4-byte"])
def fixed_index(request, cuda):
    """(index, meta) of a fixed layout: the 16- and 600-predicate stores'
    (1- and 2-byte ids), and a CSR of 4-byte ids built here, since
    ``predindex.build`` picks 4 bytes only above 65,535 predicates: 300 rows
    of 0-100 ids over all 32 bits, rows 1-7 holding 70, 45, 33, 32, 31, 1
    and 0."""
    if request.param != "4-byte":
        return _small_store(request.param, cuda)[0].pred_index.select("fixed")
    rng = np.random.default_rng(43)
    deg = rng.integers(0, 101, 300)
    deg[1:8] = (70, 45, 33, 32, 31, 1, 0)
    offsets = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ids = np.concatenate([np.sort(rng.integers(0, 2**32, d, dtype=np.uint64)) for d in deg])
    none = np.zeros(1, np.uint32)
    index = predindex.index_from_numpy(dict(
        offsets=offsets, words=ids.astype(np.uint32), degs=none, flags=none,
        frank=np.zeros(1, np.int32)), cuda)
    return index, predindex.PredIndexMeta(n_subjects=150, n_objects=150, n_preds=2**32,
                                          bytes_per_pred=4, max_degree=int(deg.max()))


@pytest.mark.parametrize("cap", [1, 14, 31, 32, 33, 40, 64, 70])
def test_pred_gather_every_row(fixed_index, cap, cuda):
    """Every row of a fixed-layout index, and rows past its end and below 0
    (the kernel clips them to the index), in a shuffled order, at caps on
    both sides of a 32-slot chunk: the kernel against its plain version on
    the clipped rows."""
    index, pmeta = fixed_index
    n = index.offsets.shape[0] - 1
    rng = np.random.default_rng(cap)
    rows = rng.permutation(np.concatenate([np.arange(n), [n, n + 7, -1, -33]]))
    rows = torch.from_numpy(rows.astype(np.int32)).to(cuda)
    n0 = ops.LAUNCHES["pred_gather"]
    got = ops.pred_gather(pmeta, index, rows, cap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["pred_gather"] == n0 + 1
    want = ref.pred_gather_ref(rows.clamp(0, n - 1), index.offsets, index.words,
                               bytes_per_pred=pmeta.bytes_per_pred, cap=cap)
    _equal(got, want)
    count = got[2].cpu().numpy()
    assert (count == min(cap, pmeta.max_degree)).any()
    if pmeta.bytes_per_pred == 4:
        assert (count == 0).any()
        assert (got[0][got[1]] < 0).any() and (got[0][got[1]] > 65535).any()


# ---------------------------------------------------------------------------
# predicate-sharded serving on meshes that repeat the card
# ---------------------------------------------------------------------------


def _serve_mix(ds, b, seed):
    rng = np.random.default_rng(seed)
    ops_ = rng.integers(0, 6, b).astype(np.int32)
    rows = ds.ids[rng.integers(0, ds.n_triples, b)]
    p = np.where(ops_ >= 3, 0, rows[:, 1]).astype(np.int32)
    return eng.ServeBatch(ops_, rows[:, 0].astype(np.int32), p, rows[:, 2].astype(np.int32))


def _host_equal(got, want):
    for name in eng.RESULT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), name


@pytest.mark.parametrize("shape, layout", [((2, 4), "dac"), ((2, 4), "fixed"), ((1, 3), "dac")])
def test_sharded_serve_on_the_card_matches_the_cpu(shape, layout, cuda):
    """A mesh of the card (16 trees; over 3 shards they pad to 18) against
    the sharded plan of the same store on the CPU and the unsharded plan
    on the card, every field; the fixed layout runs the pred_gather
    kernel under the mesh."""
    from repro_torch.launch import mesh as meshlib

    st, ds = _small_store(16, cuda)
    cpu_st = k2triples.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                       n_objects=ds.n_objects, n_preds=ds.n_preds, device="cpu")
    n = shape[0] * shape[1]
    cfg = ExecConfig(cap=128, pred_index_layout=layout)
    qb = _serve_mix(ds, 64 * shape[0], seed=n)
    gather = "pred_gather" if layout == "fixed" else "pred_gather_dac"
    before = dict(ops.LAUNCHES)
    e = eng.Engine(st, device=cuda)
    got = eng.host_result(e.compile(ServeQ(), cfg.replace(
        device=str(cuda), mesh=meshlib.make_mesh(shape, ("data", "model"), [cuda] * n)))(qb))
    # each data slice gathers once; each shard checks and scans twice
    assert ops.LAUNCHES[gather] - before[gather] >= shape[0]
    assert ops.LAUNCHES["k2_scan"] - before["k2_scan"] >= 2 * n
    cpu_e = eng.Engine(cpu_st, device="cpu")
    want = cpu_e.compile(ServeQ(), cfg.replace(
        device="cpu", mesh=meshlib.make_mesh(shape, ("data", "model"), ["cpu"] * n)))(qb)
    _host_equal(got, eng.host_result(want))
    _host_equal(got, eng.host_result(e.compile(ServeQ(), cfg.replace(device=str(cuda)))(qb)))


def test_sharded_pattern_and_sweep_on_the_card(cuda):
    from repro_torch.launch import mesh as meshlib

    st, ds = _small_store(16, cuda)
    mesh = meshlib.make_mesh((1, 3), ("data", "model"), [cuda] * 3)
    e = eng.Engine(st, device=cuda)
    cfg = ExecConfig(cap=128, device=str(cuda))
    rows = ds.ids[:9]
    for q, batch in ((TriplePatternQ(1, "?p", "?o"), {"s": rows[:, 0]}),
                     (TriplePatternQ("?s", "?p", 1), {"o": rows[:, 2]}),
                     (TriplePatternQ(1, 1, "?o"), {"s": rows[:, 0], "p": rows[:, 1]})):
        got, want = e.compile(q, cfg.replace(mesh=mesh))(batch), e.compile(q, cfg)(batch)
        for g, w in zip(got, want):
            if isinstance(w, dict):
                assert {k: v.tolist() for k, v in g.items()} == {k: v.tolist() for k, v in w.items()}
            else:
                assert np.array_equal(g, w)
    shards = eng.shard_forest(eng.pad_preds(st.forest, 3), mesh)
    keys = torch.as_tensor(rows[:, 0], dtype=torch.int32)
    axes = torch.zeros(9, dtype=torch.int32)
    ids, valid, count = eng.make_sharded_unbounded_scan(st.meta, mesh, 64)(shards, keys, axes)
    r = eng.k2forest.row_scan_all_preds(st.meta, st.forest, int(rows[0, 0]) - 1, 64)
    assert ids.shape == (9, 18, 64) and not valid[:, 16:].any()
    assert torch.equal(ids[0, :16], torch.where(r.valid, r.ids + 1, 0))
    assert torch.equal(count[0, :16], r.count)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_sharded_serve_over_distinct_cards(shape, cuda):
    """A mesh over distinct cards (copies of the shards and the index on
    each, the partials summed on the lead by peer copies) against the same
    plan on a mesh of the lead card alone and the unsharded plan; skips
    where fewer cards are visible than the mesh needs."""
    from repro_torch.launch import mesh as meshlib

    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, {torch.cuda.device_count()} visible")
    lead = torch.device("cuda", 0)
    st, ds = _small_store(16, lead)
    e = eng.Engine(st, device=lead)
    cfg = ExecConfig(cap=128, device=str(lead))
    qb = _serve_mix(ds, 64 * shape[0], seed=7 * n)
    spread = meshlib.make_mesh(shape, ("data", "model"))
    assert len(set(spread.devices)) == n
    got = e.compile(ServeQ(), cfg.replace(mesh=spread))(qb)
    assert got.ids.device == lead
    got = eng.host_result(got)
    one = meshlib.make_mesh(shape, ("data", "model"), [lead] * n)
    _host_equal(got, eng.host_result(e.compile(ServeQ(), cfg.replace(mesh=one))(qb)))
    _host_equal(got, eng.host_result(e.compile(ServeQ(), cfg)(qb)))
    shards = e._shards(e._static(), cfg.replace(mesh=spread))
    assert {str(f.t_words.device) for f in shards} == {str(d) for d in spread.devices}
    # the functional sweep over the spread mesh
    f_sh = eng.shard_forest(eng.pad_preds(st.forest, shape[1]), spread)
    keys = torch.as_tensor(ds.ids[:4 * shape[0], 0], dtype=torch.int32)
    ids, valid, count = eng.make_sharded_unbounded_scan(st.meta, spread, 64)(
        f_sh, keys, torch.zeros_like(keys))
    ids1, valid1, count1 = eng.make_sharded_unbounded_scan(st.meta, one, 64)(
        eng.shard_forest(eng.pad_preds(st.forest, shape[1]), one), keys,
        torch.zeros_like(keys))
    assert torch.equal(ids, ids1) and torch.equal(valid, valid1) and torch.equal(count, count1)


def test_sharded_broker_over_distinct_cards(cuda):
    """The broker over a (2, 2) mesh of four cards against direct plans."""
    import asyncio

    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.broker import CoalescePolicy, ServeBroker

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA cards, {torch.cuda.device_count()} visible")
    lead = torch.device("cuda", 0)
    st, ds = _small_store(16, lead)
    e = eng.Engine(st, device=lead)
    cfg = ExecConfig(cap=128, device=str(lead))
    qb = _serve_mix(ds, 40, seed=3)
    queries = [tuple(int(a[i]) for a in qb) for i in range(40)]

    async def main():
        async with ServeBroker(e, cfg.replace(mesh=meshlib.make_mesh((2, 2), ("data", "model"))),
                               coalesce=CoalescePolicy(max_batch=16, max_delay_s=0.002)) as b:
            return await asyncio.gather(*(b.submit_nowait("t0", *q) for q in queries))

    got = asyncio.run(main())
    want = eng.host_result(e.compile(ServeQ(), cfg)(qb))
    for i, (g, q) in enumerate(zip(got, queries)):
        w = eng.decode_lane(q[0], want, i)
        if isinstance(w, dict):
            assert {k: v.tolist() for k, v in g.items()} == {k: v.tolist() for k, v in w.items()}
        else:
            assert np.array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# the single-tree API and the registry's programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ks, n", [((4,), 1), ((4,), 16), ((4, 4, 4), 0),
                                   ((3, 3, 3), 80), ((4, 4, 4, 4, 4, 2, 2), 3000)])
def test_k2tree_api_on_the_card(ks, n, cuda):
    """``k2tree.check`` (through ``ops.k2_check_tree``), ``row_scan`` /
    ``col_scan`` at caps below, at and past the root arity, and
    ``range_scan`` past the level-0 cap, on the card against the same
    tree on the CPU (the plain versions): H = 1 trees, an empty tree, a
    3-ary one and a hybrid one; keys negative, in range and past the
    side."""
    from repro_torch.core import k2tree

    meta = k2tree.K2Meta(ks)
    side = meta.side
    rng = np.random.default_rng(n)
    rows, cols = rng.integers(0, side, n), rng.integers(0, side, n)
    cpu_t = k2tree.build(rows, cols, meta, device="cpu")
    card_t = k2tree.build(rows, cols, meta, device=cuda)
    before = dict(ops.LAUNCHES)
    for q in (1, 33, 5000):
        qr = rng.integers(-3, side + 3, q).astype(np.int32)
        qc = rng.integers(-3, side + 3, q).astype(np.int32)
        got = k2tree.check(meta, card_t, torch.from_numpy(qr).to(cuda),
                           torch.from_numpy(qc).to(cuda))
        want = k2tree.check(meta, cpu_t, torch.from_numpy(qr), torch.from_numpy(qc))
        assert torch.equal(got.cpu(), want)
    keys = sorted({-(2**31), -1, 0, int(rows[0]) if n else 1, side - 1, side, 2**20})
    for cap in (1, 3, 64, 1024):
        for key in keys:
            for fn in (k2tree.row_scan, k2tree.col_scan):
                _equal([a.cpu() for a in fn(meta, card_t, key, cap)], fn(meta, cpu_t, key, cap))
    for cap in (1, 17, 4096):
        _equal([a.cpu() for a in k2tree.range_scan(meta, card_t, cap)],
               k2tree.range_scan(meta, cpu_t, cap))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["k2_check"] - before["k2_check"] == 3
    assert ops.LAUNCHES["k2_scan"] - before["k2_scan"] == 8 * len(keys)
    assert ops.LAUNCHES["k2_range"] - before["k2_range"] == 3


@pytest.mark.parametrize("shape", ["serve_64k", "unbounded_4k"])
def test_registry_smoke_programs_on_the_card(shape, cuda):
    """The ``k2triples`` smoke cells on (1, 1) and (2, 4) meshes of the
    card against the same program on a (1, 1) mesh of the CPU."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as meshlib, programs

    cfg = ARCHS["k2triples"].smoke_cfg
    ds = rdf.generate(cfg.n_triples, n_subjects=cfg.n_subjects, n_preds=cfg.n_preds,
                      n_objects=cfg.n_objects, seed=0)
    stores = {d: k2triples.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                           n_objects=ds.n_objects, n_preds=ds.n_preds,
                                           device=d) for d in ("cpu", cuda)}
    if shape == "serve_64k":
        batch = _serve_mix(ds, 256, seed=7)
    else:
        rows = ds.ids[np.random.default_rng(7).integers(0, ds.n_triples, 256)]
        axes = (np.arange(256) % 2).astype(np.int32)
        batch = (np.where(axes == 1, rows[:, 2], rows[:, 0]).astype(np.int32), axes)
    cpu_mesh = meshlib.make_mesh((1, 1), ("data", "model"), ["cpu"])
    prog = programs.build("k2triples", shape, cpu_mesh, smoke=True)
    want = prog.fn(*programs.inputs(prog, stores["cpu"], cpu_mesh, batch))
    for mshape in ((1, 1), (2, 4)):
        mesh = meshlib.make_mesh(mshape, ("data", "model"), [cuda] * (mshape[0] * mshape[1]))
        prog = programs.build("k2triples", shape, mesh, smoke=True)
        before = ops.LAUNCHES["k2_scan"]
        got = prog.fn(*programs.inputs(prog, stores[cuda], mesh, batch))
        assert ops.LAUNCHES["k2_scan"] - before >= mshape[0] * mshape[1]
        if shape == "serve_64k":
            _host_equal(eng.host_result(got), eng.host_result(want))
        else:
            _equal([a.cpu() for a in got], want)


# ---------------------------------------------------------------------------
# the transformer LM's serving path (no kernel of its own: torch products)
# ---------------------------------------------------------------------------

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def _rel_l2(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_serve_on_the_card_matches_the_cpu(arch, cuda):
    """A smoke config's prefill of 2 x 24 tokens and 4 decode steps, the
    same seeded weights on the card and the CPU, held layer by layer on
    identical inputs (the CPU's layer input and cache): each layer's output
    and k / v within 1e-2 relative L2 (~2.5 bf16 steps; value by value a
    residual sum that cancels keeps the rounding of its larger terms), the
    logits of the same final hidden states within 1e-4.  Free-running
    logits are not held: with random weights one bf16 rounding that lands
    the other way grows through the layers."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as L, transformer as tfm

    spec = ARCHS[arch]
    cfg = spec.smoke_cfg
    dt = torch.bfloat16 if spec.param_dtype == "bfloat16" else torch.float32
    params = tfm.init(cfg, torch.Generator().manual_seed(1), device="cpu", dtype=dt)
    card = _to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (2, 24)).astype(np.int32))

    def logits(p, x):
        return tfm.unembed_logits(cfg, p, L.rms_norm(x[:, -1:], p["final_norm"]))[:, 0]

    def held(x):
        np.testing.assert_allclose(logits(card, x.to(cuda)).cpu().numpy(),
                                   logits(params, x).numpy(), rtol=1e-4, atol=1e-4)

    x = tfm._embed(params, toks)
    positions = torch.arange(24, dtype=torch.int32).expand(2, 24)
    ks, vs = [], []
    for i, is_local in enumerate(tfm.local_flags(cfg)):
        y, kv = tfm._layer(cfg, _to(tfm._layer_params(params, i), cuda), x.to(cuda),
                           positions.to(cuda), is_local)
        x, (k, v) = tfm._layer(cfg, tfm._layer_params(params, i), x, positions, is_local)
        for a, b in ((y, x), (kv[0], k), (kv[1], v)):
            assert _rel_l2(a, b) <= 1e-2
        ks.append(k)
        vs.append(v)
    held(x)
    cache = {"k": torch.nn.functional.pad(torch.stack(ks), (0, 0, 0, 0, 0, 4)),
             "v": torch.nn.functional.pad(torch.stack(vs), (0, 0, 0, 0, 0, 4))}
    for step in range(4):
        pos = torch.full((2,), 24 + step, dtype=torch.int32)
        x = tfm._embed(params, logits(params, x).argmax(-1))
        for i, is_local in enumerate(tfm.local_flags(cfg)):
            kc, vc = cache["k"][i], cache["v"][i]
            kc_d, vc_d = kc.to(cuda), vc.to(cuda)
            y = tfm._decode_layer(cfg, _to(tfm._layer_params(params, i), cuda), x.to(cuda),
                                  kc_d, vc_d, pos.to(cuda), is_local)
            x = tfm._decode_layer(cfg, tfm._layer_params(params, i), x, kc, vc, pos, is_local)
            for a, b in ((y, x), (kc_d, kc), (vc_d, vc)):
                assert _rel_l2(a, b) <= 1e-2
        x = x[:, None, :]
        held(x)
    # the functional entry points run on the card
    got, cache_d = tfm.prefill(cfg, card, toks.to(cuda))
    assert got.device.type == "cuda" and torch.isfinite(got).all()
    assert cache_d["k"].shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads, cfg.d_head)


def test_moe_dispatch_on_the_card_equals_the_cpu(cuda):
    """``_moe_route`` at olmoe's E = 64, K = 8 on gates with exact ties
    and with capacity overflow: idx / wslot / valid and each token's slots
    equal."""
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(4)
    for T, C, levels in ((256, 40, 0), (256, 40, 4), (1000, 20, 3), (4, 4, 0)):
        g = rng.random((T, 64)).astype(np.float32)
        if levels:
            g = np.floor(g * levels).astype(np.float32) / levels + 0.01
        g = torch.from_numpy(g / g.sum(-1, keepdims=True))
        want = tfm._moe_route(g, 64, 8, C)
        got = tfm._moe_route(g.to(cuda), 64, 8, C)
        _equal([x.cpu() for x in got], want)


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_lm_registry_smoke_programs_on_the_card(shape, cuda):
    """``programs.build`` + ``lm_inputs`` on the card: the smoke program of
    olmoe, its parameters moved to the CPU, against the CPU run."""
    from repro_torch.launch import mesh as meshlib, programs

    mesh = meshlib.make_mesh((1, 1), ("data", "model"), [cuda])
    prog = programs.build("olmoe-1b-7b", shape, mesh, smoke=True)
    args = programs.lm_inputs(prog, cuda, seed=5, seq_len=32)
    cpu_args = [_to(a, "cpu") if isinstance(a, dict) else a.cpu() for a in args]
    want, _ = prog.fn(*cpu_args)
    got, _ = prog.fn(*args)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=5e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# the LM serving programs on a mesh (dist/, models/transformer_mesh.py)
# ---------------------------------------------------------------------------


def _mesh(shape, devices):
    from repro_torch.launch import mesh as meshlib

    return meshlib.make_mesh(shape, ("data", "model"), devices)


def _gathered(out):
    from repro_torch.dist.sharding import Sharded

    logits, cache = out
    return [logits] + [cache[k].unshard() if isinstance(cache[k], Sharded) else cache[k]
                       for k in ("k", "v")]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_mesh_programs_on_the_card(arch, cuda):
    """The three smoke serving programs on a (2, 4) mesh of the card
    against the same on a (2, 4) mesh of the CPU, the same inputs: layer 0's
    k / v within 1e-2 relative L2 (bf16 products on the card), the rest
    within 5e-2 and the logits within 0.1 (tests/test_torch_lm_mesh.py's
    whole-model bounds); every parameter shard a view of its tensor."""
    from repro_torch.launch import programs
    from repro_torch.tree import tree_map

    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        card = programs.build(arch, shape, _mesh((2, 4), [cuda] * 8), smoke=True)
        host = programs.build(arch, shape, _mesh((2, 4), ["cpu"] * 8), smoke=True)
        args = programs.lm_inputs(card, cuda, seed=8, seq_len=32)
        for _, s in programs.tfm._leaves(args[0]):
            assert len({p.untyped_storage().data_ptr() for p in s.parts}) == 1
            assert all(p.device == cuda for p in s.parts)
        cpu_args = [tree_map(lambda t: t.unshard().cpu(), a) if isinstance(a, dict)
                    else a.unshard().cpu() for a in args]
        got = _gathered(card.fn(*args))
        want = _gathered(host.fn(*cpu_args))
        assert got[0].device == cuda
        for i in range(got[1].shape[0]):
            for a, b in ((got[1], want[1]), (got[2], want[2])):
                assert _rel_l2(a[i], b[i]) <= (1e-2 if i == 0 else 5e-2), (shape, i)
        assert _rel_l2(got[0], want[0]) <= 0.1, shape


def test_lm_mesh_over_distinct_cards(cuda):
    """tinyllama's smoke prefill and decode on a (1, 4) mesh over four
    cards against the same mesh of the lead card: each shard on its own
    card, the same values (the same kernels, the partials summed on the
    lead in the same order); skips with fewer than four cards."""
    from repro_torch.launch import programs
    from repro_torch.tree import tree_map

    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA cards, {torch.cuda.device_count()} visible")
    cards = [torch.device("cuda", i) for i in range(4)]
    for shape in ("prefill_32k", "decode_32k"):
        spread = programs.build("tinyllama-1.1b", shape, _mesh((1, 4), cards), smoke=True)
        one = programs.build("tinyllama-1.1b", shape, _mesh((1, 4), [cards[0]] * 4), smoke=True)
        args = programs.lm_inputs(one, cards[0], seed=9)
        base = [tree_map(lambda t: t.unshard(), a) if isinstance(a, dict) else a.unshard()
                for a in args]
        placed = programs.lm_place(spread, base)
        assert [p.device for p in placed[0]["layers"]["wq"].parts] == cards
        got, want = _gathered(spread.fn(*placed)), _gathered(one.fn(*args))
        for a, b in zip(got, want):
            assert a.device == cards[0]
            np.testing.assert_allclose(a.float().cpu().numpy(), b.float().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_compress_on_the_card(cuda):
    """The int8 error-feedback mean on an (8,) mesh of the card against the
    CPU over three calls: the residual exact, the mean within 1e-6."""
    from repro_torch.dist import compress
    from repro_torch.launch import mesh as meshlib

    g = np.random.default_rng(3).standard_normal((8, 1000)).astype(np.float32)
    out = {}
    for name, dev in (("card", cuda), ("cpu", torch.device("cpu"))):
        mesh = meshlib.make_mesh((8,), ("data",), [dev] * 8)
        gs = tuple(torch.from_numpy(g[i]).to(dev) for i in range(8))
        errs = tuple(torch.zeros(1000, device=dev) for _ in range(8))
        for _ in range(3):
            mean, errs = compress.compress_decompress_psum(gs, errs, mesh, "data")
        out[name] = (mean[0].cpu(), [e.cpu() for e in errs])
    assert all(torch.equal(a, b) for a, b in zip(out["card"][1], out["cpu"][1]))
    np.testing.assert_allclose(out["card"][0].numpy(), out["cpu"][0].numpy(), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the transformer LM's training path (no kernel of its own: torch products)
# ---------------------------------------------------------------------------


# card against CPU, one smoke train step from the same inputs (chip_smoke.py's STEP_TOL and
# its measurements): loss, grad_norm relative; optimizer state relative L2 a leaf; AdamW's new
# parameters: the share of elements off (each within 2.02·lr); f32 Adafactor: the update's
# relative L2; bf16 parameters: the share a bf16 step apart.  gemma2's smoke config amplifies
# roundings most (a 1e-6 relative nudge of its parameters moves its grad_norm by up to 21% on
# the CPU alone).
TRAIN_STEP_TOL = dict(loss=1e-3, grad_norm=2e-2, state=1e-1, share=2e-2, update=1e-1, bf16=1e-1)
TRAIN_STEP_TOL_OF = {"gemma2-27b": dict(TRAIN_STEP_TOL, grad_norm=1e-1, state=5e-1, share=1e-1)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_train_step_on_the_card_matches_the_cpu(arch, cuda):
    """One step of the smoke ``train_4k`` program on the card and the CPU,
    the same ``lm_inputs``, within ``TRAIN_STEP_TOL``."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as meshlib, programs
    from repro_torch.tree import leaves, tree_map

    tol = TRAIN_STEP_TOL_OF.get(arch, TRAIN_STEP_TOL)
    mesh = meshlib.make_mesh((1, 1), ("data", "model"), [cuda])
    prog = programs.build(arch, "train_4k", mesh, smoke=True)
    params, state, batch = programs.lm_inputs(prog, "cpu", seed=6)
    p0 = tree_map(torch.clone, params)  # the steps update in place
    card = [tree_map(lambda t: t.to(cuda, copy=True), x) for x in (params, state, batch)]
    _, _, want = prog.fn(params, state, batch)
    _, _, got = prog.fn(*card)
    assert got["loss"].device.type == "cuda"
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=tol[key])
    for (path, a), (_, b) in zip(leaves(card[1]), leaves(state)):
        if path == ("step",):
            assert int(a) == int(b) == 1
        elif float(b.norm()):
            assert _rel_l2(a, b) <= tol["state"], path
    spec = ARCHS[arch]
    lr = 1e-3 if spec.optimizer == "adafactor" else 3e-4
    for (path, a), (_, b), (_, a0) in zip(leaves(card[0]), leaves(params), leaves(p0)):
        a, b, a0 = a.float().cpu(), b.float(), a0.float()
        off = (a - b).abs()
        if spec.optimizer == "adamw":
            assert float(off.max()) <= 2.02 * lr, path
            assert float((off > 1e-6 + 1e-6 * b.abs()).float().mean()) <= tol["share"], path
        elif spec.param_dtype == "float32":  # (an unused leaf does not move)
            assert torch.equal(a, b) or _rel_l2(a - a0, b - a0) <= tol["update"], path
        else:
            assert float(off.max()) <= 2.0 ** -7 * float(b.abs().max()), path
            assert float((off > 0).float().mean()) <= tol["bf16"], path


def test_flash_gradients_on_the_card_match_the_cpu(cuda):
    """``chunked_attention``'s gradients (the ``_Flash`` backward) at
    B 2 × S 300, GQA 8 / 2, dh 64, chunks 64 / 128 (short last chunks), a
    window and a softcap, on the card against the CPU: relative L2 1e-2
    (bf16 results of f32 sums in another order)."""
    from repro_torch.models import layers as L

    rng = np.random.default_rng(7)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 300, 8, 64), (2, 300, 2, 64), (2, 300, 2, 64), (2, 300, 8, 64)))
    for kw in (dict(causal=True), dict(causal=True, window=100, attn_softcap=30.0),
               dict(causal=False)):
        grads = []
        for dev in ("cpu", cuda):
            ins = [t.to(dev).bfloat16().requires_grad_() for t in (q, k, v)]
            out = L.chunked_attention(*ins, chunk_q=64, chunk_kv=128, **kw)
            (out.float() * w.to(dev)).sum().backward()
            grads.append([t.grad for t in ins])
        for got, want in zip(grads[1], grads[0]):
            assert got.dtype == torch.bfloat16 and _rel_l2(got, want) <= 1e-2, kw


# ---------------------------------------------------------------------------
# training on a mesh, and the xDeepFM recsys family (no kernel of their own: torch products)
# ---------------------------------------------------------------------------


def _distinct_devices(shape, cuda):
    """``shape``'s positions on distinct devices: four cards (model shard m
    on card m) when visible, else the card and the CPU alternated."""
    n = shape[0] * shape[1]
    if torch.cuda.device_count() >= 4:
        return [torch.device("cuda", i % 4) for i in range(n)]
    return [cuda if i % 2 == 0 else torch.device("cpu") for i in range(n)]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_mesh_train_step_over_distinct_devices(arch, cuda):
    """One smoke ``train_4k`` step on a (2, 4) mesh over distinct devices
    (no memoisation: each copy of a replicated block gets its own share of
    the gradient, the trainer sums a block's holders) against the (2, 4)
    mesh of the card, the same inputs, within ``TRAIN_STEP_TOL`` (an f32
    Adafactor update within 0.15, chip_smoke.py's measured bound); every
    holder of a block the same new value, up to its device's roundings of
    the same update (relative L2 1e-6)."""
    from repro_torch.dist.sharding import holders
    from repro_torch.launch import programs
    from repro_torch.tree import leaves, tree_map

    tol = TRAIN_STEP_TOL_OF.get(arch, dict(TRAIN_STEP_TOL, update=0.15))
    card = programs.build(arch, "train_4k", _mesh((2, 4), [cuda] * 8), smoke=True)
    spread = programs.build(arch, "train_4k", _mesh((2, 4), _distinct_devices((2, 4), cuda)),
                            smoke=True)
    base = programs.lm_inputs(programs.build(arch, "train_4k", _mesh((1, 1), [cuda]), smoke=True),
                              "cpu", seed=10)
    out = []
    for prog in (card, spread):
        args = programs.lm_place(prog, tuple(tree_map(lambda t: t.to(cuda, copy=True), a)
                                             for a in base))
        p, s, m = prog.fn(*args)
        assert m["loss"].device == cuda
        out.append((p, s, m))
    (p1, s1, m1), (p2, s2, m2) = out
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]), rtol=tol[key])
    for (path, a), (_, b) in zip(leaves(s2), leaves(s1)):
        if path[-1] != "step" and float(b.unshard().norm()):
            assert _rel_l2(a.unshard(), b.unshard()) <= tol["state"], path
    for (path, a), (_, b) in zip(leaves(p2), leaves(p1)):
        for held in holders(a).values():
            assert all(_rel_l2(t, held[0]) <= 1e-6 for t in held[1:]), path
        off = (a.unshard().float().cpu() - b.unshard().float().cpu()).abs()
        lr = 1e-3 if programs.cb.get(arch).optimizer == "adafactor" else 3e-4
        assert float(off.max()) <= max(2.02 * lr, 2.0 ** -7 * float(b.unshard().abs().max())), path


def test_gradient_combine_over_distinct_devices(cuda):
    """The combine rule on distinct devices, in f32: a split and a
    replicated leaf read at every position of a (2, 4) mesh through a
    ``psum`` and a detached ``pmax``, the loss read once a data slice: the
    gradients equal one device's within 1e-5."""
    from repro_torch.dist import collectives as col, sharding as shd
    from repro_torch.train import trainer

    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)).to(cuda)
    r = torch.from_numpy(rng.standard_normal((8,)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((6, 8)).astype(np.float32)).to(cuda)
    mesh = _mesh((2, 4), _distinct_devices((2, 4), cuda))

    def one(p, x):
        h = (x * p["r"]) @ p["w"]
        return torch.sum(torch.tanh(h - h.detach().amax(-1, keepdim=True)) ** 2) / 3.0

    def sharded(p, xs):
        h = col.per_position(lambda x, w, r: (x * r) @ w, mesh, xs.parts, p["w"].parts,
                             p["r"].parts)
        m = col.pmax(col.per_position(lambda h: h.detach().amax(-1, keepdim=True), mesh, h),
                     mesh, ("model",))
        s = col.psum(col.per_position(lambda h, m: torch.sum(torch.tanh(h - m) ** 2, dim=-1),
                                      mesh, h, m), mesh, ("model",))
        return col.sum_in_order([s[q].sum().to(mesh.lead) for q in
                                 (row[0] for row in mesh.grid())]) / 3.0

    loss1, g1 = trainer.value_and_grad(one, {"w": w, "r": r}, x)
    params = {"w": shd.shard(w, mesh, (None, "model")), "r": shd.shard(r, mesh, (None,))}
    loss, g = trainer.value_and_grad(sharded, params, shd.shard(x, mesh, ("data", None)))
    assert len(shd.distinct(params["r"])) == len(set(mesh.devices))  # one copy a device
    np.testing.assert_allclose(float(loss), float(loss1), rtol=1e-5)
    for k in ("w", "r"):
        np.testing.assert_allclose(g[k].unshard().cpu().numpy(), g1[k].cpu().numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_xdeepfm_full_serve_bulk_within_memory(cuda):
    """``xdeepfm:serve_bulk`` at the full config (B = 262,144; 39 x 10^6
    rows x 10) on the card: finite logits, and the peak within 8 GiB of the
    inputs (chip_smoke.py's ``BULK_GROWTH``: one unchunked [B, 200, 39,
    10] CIN intermediate alone would be 81.8 GB); the first 512 rows equal
    ``serve_p99``'s program on them."""
    from repro_torch.launch import programs

    prog = programs.build("xdeepfm", "serve_bulk", _mesh((1, 1), [cuda]))
    params, ids = programs.recsys_inputs(prog, cuda, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    resident = torch.cuda.memory_allocated(cuda)
    with torch.no_grad():
        logits = prog.fn(params, ids)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda) - resident <= 8 << 30
    assert logits.shape == (262_144,) and torch.isfinite(logits).all()
    p99 = programs.build("xdeepfm", "serve_p99", _mesh((1, 1), [cuda]))
    with torch.no_grad():
        head = p99.fn(params, ids[:512])
    assert _rel_l2(head, logits[:512]) <= 1e-6


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"])
def test_xdeepfm_mesh_matches_single_on_the_card(shape, cuda):
    """The smoke program on a (1, 4) mesh of the card against (1, 1), the
    same ``recsys_inputs``: forward and retrieval equal within 1e-6 (the
    lookups' psum has one nonzero term), a train step's loss within 1e-6
    and its parameters within 1e-5; the same forward program against the
    CPU within 1e-4."""
    from repro_torch.launch import programs
    from repro_torch.tree import leaves, tree_map

    single = programs.build("xdeepfm", shape, _mesh((1, 1), [cuda]), smoke=True)
    mesh = programs.build("xdeepfm", shape, _mesh((1, 4), [cuda] * 4), smoke=True)
    got = mesh.fn(*programs.recsys_inputs(mesh, cuda, seed=2))
    args = programs.recsys_inputs(single, cuda, seed=2)
    host_args = [tree_map(lambda t: t.cpu(), a) for a in args]
    want = single.fn(*args)
    if shape == "train_batch":
        np.testing.assert_allclose(float(got[2]["loss"]), float(want[2]["loss"]), rtol=1e-6)
        for (path, a), (_, b) in zip(leaves(got[0]), leaves(want[0])):
            assert _rel_l2(a.unshard(), b) <= 1e-5, path
        return
    assert got.device == cuda and _rel_l2(got, want) <= 1e-6
    host = programs.build("xdeepfm", shape, _mesh((1, 1), ["cpu"]), smoke=True)
    assert _rel_l2(want, host.fn(*host_args)) <= 1e-4


GNN_ARCHS = ("mace", "graphcast", "egnn", "equiformer-v2")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# one smoke GNN step, card against CPU: the card's segment sums add with atomics in an order
# of their own; GraphCast's bf16 states carry that difference through the layers
GNN_STEP_TOL = dict(loss=1e-4, grad_norm=1e-3, state=1e-3)
GNN_STEP_TOL_OF = {"graphcast": dict(loss=2e-2, grad_norm=5e-2, state=1e-1)}


@pytest.mark.parametrize("shape", GNN_SHAPES)
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_smoke_step_on_the_card_matches_the_cpu(arch, shape, cuda):
    """One step of each smoke GNN program on the card and the CPU from the
    same ``gnn_inputs``: loss and ``grad_norm`` within ``GNN_STEP_TOL``,
    AdamW's first moments (0.1 x the gradient) within its ``state``
    relative L2, the new parameters within 2.02·lr."""
    from repro_torch.launch import programs
    from repro_torch.tree import leaves, tree_map

    tol = GNN_STEP_TOL_OF.get(arch, GNN_STEP_TOL)
    prog = programs.build(arch, shape, _mesh((1, 1), [cuda]), smoke=True)
    params, state, batch = programs.gnn_inputs(prog, "cpu", seed=4)
    card = [tree_map(lambda t: t.to(cuda, copy=True), x) for x in (params, state)]
    card_batch = batch.to(cuda)
    _, _, want = prog.fn(params, state, batch)
    _, _, got = prog.fn(*card, card_batch)
    assert got["loss"].device.type == "cuda"
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=tol[key])
    for (path, a), (_, b) in zip(leaves(card[1]["mu"]), leaves(state["mu"])):
        if float(b.norm()) > 1e-6 * float(want["grad_norm"]):
            assert _rel_l2(a, b) <= tol["state"], path
    for (path, a), (_, b) in zip(leaves(card[0]), leaves(params)):
        assert float((a.cpu() - b).abs().max()) <= 2.02 * 3e-4, path


def test_equiformer_chunked_gradients_on_the_card(cuda):
    """EquiformerV2's chunked online softmax (``edge_chunks=3``, the
    autograd function that recomputes each chunk in its backward) against
    the one-chunk path on the card: loss within 1e-5, every gradient leaf
    within 1e-4 relative L2 (a leaf zero but for rounding by 1e-6 of the
    whole gradient's norm); rotating the positions moves no output."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data import graphs as G
    from repro_torch.models.gnn import equiformer_v2 as eq
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import leaves

    cfg = ARCHS["equiformer-v2"].smoke_cfg
    params = eq.init(cfg, torch.Generator(device=cuda).manual_seed(3), device=cuda)
    g = G.molecule_batch(8, 30, 64, seed=5).to(cuda)
    runs = [value_and_grad(lambda p, b, c=c: eq.loss_fn(dataclasses.replace(cfg, edge_chunks=c),
                                                        p, b), params, g) for c in (1, 3)]
    np.testing.assert_allclose(float(runs[1][0]), float(runs[0][0]), rtol=1e-5)
    total = float(torch.sqrt(sum((b ** 2).sum() for _, b in leaves(runs[0][1]))))
    for (path, a), (_, b) in zip(leaves(runs[1][1]), leaves(runs[0][1])):
        err = float((a - b).norm())
        assert err <= 1e-4 * float(b.norm()) or err <= 1e-6 * total, path
    c, s = np.cos(0.7), np.sin(0.7)
    rot = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32, device=cuda)
    with torch.no_grad():
        a = eq.forward(cfg, params, g)
        b = eq.forward(cfg, params, g._replace(positions=g.positions @ rot.T))
    torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
