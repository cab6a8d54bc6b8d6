"""Package rules of ``repro_torch``.

* No file of the package, nor ``chip_smoke.py`` or ``kernel_variants.py``,
  imports ``jax`` or the JAX package ``repro`` (an AST scan of every import).
* Every entry point defaults to ``device="cuda"``, and asking for CUDA
  without a card raises instead of running on the CPU (the LM's ``init``,
  ``params_from_arrays``, ``KVCache.zeros``, ``programs.lm_inputs`` and
  the train driver included).
* ``ExecConfig`` resolves without reading the environment.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import bitvec, convert, engine as eng, k2tree, k2triples
from repro_torch.core import query
from repro_torch.core.query import ExecConfig, resolve_device
from repro_torch.launch import broker, serve, train
from repro_torch.launch import mesh as meshlib, programs
from repro_torch.models import transformer as tfm

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_variants.py"]


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    roots = _imported_roots(path)
    assert "jax" not in roots and "jaxlib" not in roots, path
    assert "repro" not in roots, path


def test_entry_points_default_to_cuda():
    assert ExecConfig().device == "cuda"
    for fn in (eng.Engine.__init__, k2triples.from_id_triples,
               k2triples.from_string_triples, serve.run_bench, k2tree.build,
               bitvec.bitvec_from_bits, convert.tree_from_arrays, tfm.init,
               tfm.params_from_arrays, tfm.KVCache.zeros, programs.lm_inputs):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert serve.parse_args([]).device == "cuda"
    assert train.parse_args(["--arch", "tinyllama-1.1b"]).device == "cuda"
    # a mesh defaults to the visible CUDA cards
    assert inspect.signature(meshlib.make_mesh).parameters["devices"].default is None
    assert inspect.signature(programs.build).parameters["mesh"].default is None


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    ids = np.array([[1, 1, 1], [2, 1, 2]], np.int64)
    kw = dict(n_so=0, n_subjects=2, n_objects=2, n_preds=1)
    with pytest.raises(RuntimeError):
        k2triples.from_id_triples(ids, **kw)
    with pytest.raises(RuntimeError):
        k2triples.from_string_triples([("a", "p", "b")])
    with pytest.raises(RuntimeError):
        k2tree.build(ids[:, 0], ids[:, 2], k2tree.K2Meta((4,)))
    st = k2triples.from_id_triples(ids, device="cpu", **kw)
    with pytest.raises(RuntimeError):
        eng.Engine(st)
    with pytest.raises(RuntimeError):
        serve.run_bench(n_triples=100, quiet=True)
    with pytest.raises(ValueError, match="CUDA"):
        meshlib.make_mesh((1, 1), ("data", "model"))
    with pytest.raises(RuntimeError):
        meshlib.make_mesh((1, 1), ("data", "model"), ["cuda"])
    cfg = tfm.TransformerCfg(name="t", n_layers=1, d_model=8, n_heads=2, n_kv_heads=1,
                             d_head=4, d_ff=8, vocab=16)
    with pytest.raises(RuntimeError):
        tfm.init(cfg, torch.Generator())
    params = tfm.init(cfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError):
        tfm.params_from_arrays(cfg, {k: v.numpy() if k != "layers" else
                                     {n: w.numpy() for n, w in v.items()}
                                     for k, v in params.items()})
    with pytest.raises(RuntimeError):
        tfm.KVCache.zeros(cfg, 1, 4)
    with pytest.raises(ValueError):  # an LM program's default mesh is a card
        programs.build("tinyllama-1.1b", "decode_32k")
    with pytest.raises(ValueError):
        programs.build("tinyllama-1.1b", "train_4k")
    with pytest.raises(RuntimeError, match="no CUDA card"):  # the train driver
        train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])
    e = eng.Engine(st, device="cpu")
    # a broker follows its engine's device; a cuda config is refused
    assert broker.ServeBroker(e).config.device == "cpu"
    with pytest.raises(RuntimeError):
        e.compile(query.ServeQ(), ExecConfig())


def test_exec_config_reads_no_environment(monkeypatch):
    for var in ("REPRO_SCAN_BACKEND", "REPRO_PALLAS_INTERPRET", "REPRO_PRED_INDEX_LAYOUT"):
        monkeypatch.setenv(var, "garbage")
    cfg = ExecConfig()
    assert cfg == ExecConfig(cap=4096, cap_y=256, device="cuda")
    assert cfg.pred_index_layout == "dac"
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            ExecConfig(u_width_quantile=bad)
    assert ExecConfig(u_width_quantile=0.5).u_width_quantile == 0.5
    with pytest.raises(ValueError):
        ExecConfig(pred_index_layout="csr")


def test_fixed_layout_wrapper_checks_inputs_and_runs_plain_on_cpu():
    from repro_torch.kernels import ops, ref

    ids = np.array([[1, 1, 1], [1, 2, 2], [2, 2, 1], [2, 3, 2]], np.int64)
    st = k2triples.from_id_triples(ids, device="cpu", n_so=0, n_subjects=2,
                                   n_objects=2, n_preds=3)
    dev, pmeta = st.pred_index.select("fixed")
    rows = torch.arange(4, dtype=torch.int32)
    n0 = ops.LAUNCHES["pred_gather"]
    got = ops.pred_gather(pmeta, dev, rows, cap=2)
    want = ref.pred_gather_ref(rows, dev.offsets, dev.words, bytes_per_pred=1, cap=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[0][0].tolist() == [0, 1] and ops.LAUNCHES["pred_gather"] == n0
    with pytest.raises(TypeError):
        ops.pred_gather(pmeta, dev, rows.to(torch.int64), cap=2)
    with pytest.raises(ValueError):
        ops.pred_gather(pmeta, dev, rows, cap=0)
    with pytest.raises(ValueError):
        ops.pred_gather(st.pred_index.meta, dev, rows, cap=2)  # a DAC meta
    with pytest.raises(ValueError):
        ops.pred_gather(pmeta, dev, rows.to("meta"), cap=2)  # not the index's device
