"""Train an equivariant GNN (EGNN or MACE) on batched molecule graphs on
the PyTorch port, on an NVIDIA card by default (``--device cpu`` trains on
the host).

    PYTHONPATH=src python examples/torch_gnn_molecules.py --arch egnn --steps 50

Shows the GNN substrate end to end: point clouds -> kNN graphs ->
segment-sum message passing -> per-graph energy regression, with the same
Trainer (checkpoints, watchdog) as the LM path.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.core.query import resolve_device  # noqa: E402
from repro_torch.data import graphs as G  # noqa: E402
from repro_torch.launch.programs import GNN_MODULES  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="egnn", choices=sorted(GNN_MODULES))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="ckpt/torch_gnn_mol")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mod = GNN_MODULES[args.arch]
    cfg = get(args.arch).smoke_cfg
    if hasattr(cfg, "in_dim"):
        cfg = dataclasses.replace(cfg, in_dim=8, out_dim=1)

    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"{cfg.name}: {sum(t.numel() for _, t in leaves(params))/1e3:.1f}K params, on {dev}")

    i = [0]

    def batches():
        while True:
            b = G.molecule_batch(args.batch, 8, 16, seed=i[0])
            i[0] += 1
            yield b.to(dev)

    tr = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10),
        lambda p, b: mod.loss_fn(cfg, p, b),
        optim.adamw(3e-3),
        params,
    )
    hist = tr.run(batches(), args.steps)
    print(f"energy MSE: {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    return hist


if __name__ == "__main__":
    main()
