"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``: the fixture below decides at run time whether a card is
present and skips otherwise, so every worker collects the same tests.  On
the card: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng, k2triples
from repro_torch.core.query import ExecConfig, ServeQ
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
