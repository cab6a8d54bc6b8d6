"""End-to-end training driver: ``python -m repro_torch.launch.train --arch <id>``.

Trains an LM arch for real (parameters allocated on the device, batches
streamed from ``TokenStream``) with the full fault-tolerance loop of
:class:`repro_torch.train.trainer.Trainer`: auto-resume, periodic atomic
checkpoints, the straggler watchdog.  The flags are the JAX package's
(``repro.launch.train``) plus ``--device`` (default ``cuda``; ``cpu``
runs the plain torch path, e.g. ``--smoke --device cpu --steps 3``).
Parameters come from a ``torch.Generator`` seeded 0; the optimizer is
the arch's (Adafactor or AdamW) at ``--lr``.  The GNN and recsys archs
are not ported (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import argparse


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
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optim
    from repro_torch.train.trainer import Trainer, TrainerConfig

    if args.arch not in ARCHS:
        raise SystemExit(f"{args.arch!r} is not registered: the GNN and recsys archs are not "
                         "ported (ROADMAP Queue 1 item 3)")
    arch = ARCHS[args.arch]
    if arch.family != "lm":
        raise SystemExit(f"train driver does not apply to family {arch.family!r}")
    dev = resolve_device(args.device)
    cfg = arch.smoke_cfg if args.smoke else arch.cfg
    opt = optim.adafactor(args.lr) if arch.optimizer == "adafactor" else optim.adamw(args.lr)
    params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ts = TokenStream(cfg.vocab, args.seq, seed=0)

    def batches():
        while True:
            yield {k: torch.from_numpy(v).to(dev) for k, v in ts.batch(args.batch).items()}

    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                       log_every=args.log_every)
    tr = Trainer(tc, lambda p, b: tfm.loss_fn(cfg, p, b), opt, params, donate=False)
    if tr.try_resume():
        print(f"resumed from step {tr.step_num}")
    hist = tr.run(batches(), args.steps)
    print(f"done: {len(hist)} steps, loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; "
          f"stragglers flagged: {len(tr.watchdog.flagged)}")
    return hist


if __name__ == "__main__":
    main()
