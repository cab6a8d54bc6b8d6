"""The PyTorch port's examples (``examples/torch_*.py``), run in process on
the CPU (``--device cpu``) at small sizes: the quickstart's answers, the
serving loop's trace answered, an LM and a GNN trained (finite losses, a
checkpoint written and resumed)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    out = example("torch_quickstart").main(["--device", "cpu"])
    ex = "http://ex/"
    assert out["alice knows"] == [ex + "bob", ex + "carol"]
    assert out["batched"] == [[ex + "bob", ex + "carol"], [ex + "acme"]]
    assert out["works at acme"] == [ex + "bob", ex + "carol"]
    assert out["about alice"] == {ex + "knows": [ex + "bob", ex + "carol"]}
    assert out["join A"] == [ex + "bob", ex + "carol"]
    assert "store: 6 triples, 3 predicates" in capsys.readouterr().out


def test_serve_sparql(capsys):
    example("torch_serve_sparql").main(["--device", "cpu", "--triples", "3000", "--preds", "8",
                                        "--queries", "64", "--batch", "64", "--cap", "64"])
    out = capsys.readouterr().out
    assert "cpu: 64 queries" in out and "queries/s sustained" in out and "0 shed" in out


def test_train_lm_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    hist = example("torch_train_lm").main(argv)
    assert [h["step"] for h in hist] == [1, 2] and all(np.isfinite(h["loss"]) for h in hist)
    again = example("torch_train_lm").main(argv)
    assert [h["step"] for h in again] == [3, 4]
    assert "resumed at step 2" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["egnn", "mace"])
def test_gnn_molecules(arch, tmp_path, capsys):
    hist = example("torch_gnn_molecules").main(["--device", "cpu", "--arch", arch, "--steps", "3",
                                                "--ckpt-dir", str(tmp_path)])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "energy MSE" in capsys.readouterr().out
