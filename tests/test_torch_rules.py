"""Package rules of ``repro_torch``.

* No file of the package, nor ``chip_smoke.py``, imports ``jax`` or the JAX
  package ``repro`` (an AST scan of every import).
* Every entry point defaults to ``device="cuda"``, and asking for CUDA
  without a card raises instead of running on the CPU.
* ``ExecConfig`` resolves without reading the environment.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine as eng, k2triples
from repro_torch.core import query
from repro_torch.core.query import ExecConfig, resolve_device
from repro_torch.launch import broker, serve

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
    for fn in (eng.Engine.__init__, k2triples.from_id_triples, serve.run_bench):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert serve.parse_args([]).device == "cuda"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    ids = np.array([[1, 1, 1], [2, 1, 2]], np.int64)
    kw = dict(n_so=0, n_subjects=2, n_objects=2, n_preds=1)
    with pytest.raises(RuntimeError):
        k2triples.from_id_triples(ids, **kw)
    st = k2triples.from_id_triples(ids, device="cpu", **kw)
    with pytest.raises(RuntimeError):
        eng.Engine(st)
    with pytest.raises(RuntimeError):
        serve.run_bench(n_triples=100, quiet=True)
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
    with pytest.raises(NotImplementedError):
        ExecConfig(u_width_quantile=0.9)
    with pytest.raises(ValueError):
        ExecConfig(pred_index_layout="csr")


def test_fixed_layout_has_no_cuda_kernel_yet():
    from repro_torch.kernels import ops

    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(NotImplementedError, match="Queue 2"):
        ops.pred_gather(None, None, rows, cap=4)
