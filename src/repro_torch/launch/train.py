"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

Trains an LM, GNN or recsys arch for real (parameters allocated on the
device; LM batches streamed from ``TokenStream``, a GNN arch the full
batch of one 512-node, 4,096-edge random graph with 32 features and 7
classes, recsys batches a ``ctr_batch`` of ``--batch`` rows from seed
``i`` at step ``i``) with the
full fault-tolerance loop of :class:`repro_torch.train.trainer.Trainer`:
auto-resume, periodic atomic checkpoints, the straggler watchdog.  The
flags are the JAX package's (``repro.launch.train``) plus ``--device``
(default ``cuda``; ``cpu`` runs the plain torch path, e.g. ``--smoke
--device cpu --steps 3``).  Parameters come from a ``torch.Generator``
seeded 0; the optimizer is the arch's (Adafactor or AdamW) at ``--lr``.
"""

from __future__ import annotations

import argparse
import dataclasses
from functools import partial


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, help="defaults to the arch's train shape")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Runs the driver; returns the trainer's history (step, loss, dt)."""
    args = parse_args(argv)

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core.query import resolve_device
    from repro_torch.data import graphs as G, recsys as R
    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.programs import GNN_MODULES
    from repro_torch.models import transformer as tfm
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.arch not in ARCHS:
        raise SystemExit(f"{args.arch!r} is not registered")
    arch = ARCHS[args.arch]
    if arch.family not in ("lm", "gnn", "recsys"):
        raise SystemExit(f"train driver does not apply to family {arch.family!r}")
    dev = resolve_device(args.device)
    cfg = arch.smoke_cfg if args.smoke else arch.cfg
    opt = optim.adafactor(args.lr) if arch.optimizer == "adafactor" else optim.adamw(args.lr)
    gen = torch.Generator(device=dev).manual_seed(0)
    if arch.family == "lm":
        params = tfm.init(cfg, gen, device=dev)
        ts = TokenStream(cfg.vocab, args.seq, seed=0)

        def batches():
            while True:
                yield {k: torch.from_numpy(v).to(dev) for k, v in ts.batch(args.batch).items()}

        loss_fn = partial(tfm.loss_fn, cfg)
    elif arch.family == "gnn":
        mod = GNN_MODULES[args.arch]
        n_classes = 7
        cfg = dataclasses.replace(cfg, out_dim=n_classes, **(
            {"in_dim": 32} if hasattr(cfg, "in_dim") else {}))
        params = mod.init(cfg, gen, device=dev)
        graph = G.to_batch(G.random_graph(512, 4096, 32, n_classes=n_classes, seed=0),
                           n_classes).to(dev)

        def batches():
            while True:
                yield graph

        loss_fn = partial(mod.loss_fn, cfg)
    else:
        params = xdeepfm.init(cfg, gen, device=dev)

        def batches():
            i = 0
            while True:
                b = R.ctr_batch(args.batch, cfg.n_fields, cfg.rows_per_field, seed=i)
                i += 1
                yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}

        loss_fn = partial(xdeepfm.loss_fn, cfg)
    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every)
    tr = Trainer(tc, loss_fn, opt, params, donate=False)
    if tr.try_resume():
        print(f"resumed from step {tr.step_num}")
    hist = tr.run(batches(), args.steps)
    print(f"done: {len(hist)} steps, loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
          f"stragglers flagged: {len(tr.watchdog.flagged)}")
    return hist


if __name__ == "__main__":
    main()
