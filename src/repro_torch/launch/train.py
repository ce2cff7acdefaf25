"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port of ``repro.launch.train``: the reduced smoke config end to end
(the real optimizer, data pipeline and checkpoints), or with
``--full-config`` the production config.  ``--device`` defaults to
``cuda`` and raises without a card; ``--device cpu`` runs the plain
PyTorch versions of the kernels.

    python -m repro_torch.launch.train --arch codeqwen1.5-7b --steps 20 --device cpu
"""
from __future__ import annotations

import argparse

from ..configs import get_config, list_archs, smoke_config
from ..training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description="LifeRaft-PyTorch trainer")
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full-config", action="store_true",
                    help="use the production config (requires accelerators)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full_config else smoke_config(args.arch)
    tcfg = TrainerConfig(
        steps=args.steps,
        checkpoint_dir=args.ckpt_dir,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        lr=args.lr,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    history = trainer.run()
    if history:
        print(f"[train] final loss {history[-1]['loss']:.4f} "
              f"after {history[-1]['step']} steps")


if __name__ == "__main__":
    main()
