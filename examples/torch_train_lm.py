"""LM training with fault tolerance on the PyTorch port, on an NVIDIA
card by default (``--device cpu`` trains on the host).

Small by default; ``--arch tinyllama-1.1b --full`` is the 1.1 B-parameter
config.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

Shows the data pipeline -> loss and gradient -> optimizer -> atomic
checkpoints -> kill and resume (run it twice: the second run resumes from
the checkpoint).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.core.query import resolve_device  # noqa: E402
from repro_torch.data.tokens import TokenStream  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.train import optim  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--full", action="store_true", help="the arch's full config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="ckpt/torch_train_lm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = get(args.arch)
    cfg = spec.cfg if args.full else spec.smoke_cfg
    params = tfm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for _, t in leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, vocab {cfg.vocab}, on {dev}")

    ts = TokenStream(cfg.vocab, args.seq, seed=0)

    def batches():
        while True:
            yield {k: torch.from_numpy(v).to(dev) for k, v in ts.batch(args.batch).items()}

    tr = Trainer(
        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50, log_every=10),
        lambda p, b: tfm.loss_fn(cfg, p, b),
        optim.adamw(1e-3),
        params,
        on_straggler=lambda step, dt: print(f"  [watchdog] slow step {step}: {dt*1e3:.0f} ms"),
    )
    if tr.try_resume():
        print(f"resumed at step {tr.step_num}")
    hist = tr.run(batches(), args.steps)
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")
    return hist


if __name__ == "__main__":
    main()
