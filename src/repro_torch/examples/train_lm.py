"""End-to-end training driver: data pipeline -> train step -> checkpoints.

The port of ``examples/train_lm.py``.  Trains a reduced codeqwen-family
decoder on the synthetic Markov stream and demonstrates checkpoint/restart
(kill it mid-run; rerun resumes).  Use ``--big`` for a ~100M-parameter
config (slow on CPU — sized for a real chip).  ``--device`` defaults to
``cuda``; the checkpoints go to ``liferaft_train_ckpt`` in the temporary
directory unless ``--ckpt-dir`` says otherwise.

    python -m repro_torch.examples.train_lm --steps 40 --device cpu
"""
import argparse
import dataclasses
import os
import tempfile

import numpy as np

from ..configs import smoke_config
from ..training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "liferaft_train_ckpt"))
    ap.add_argument("--big", action="store_true",
                    help="~100M params (intended for accelerator runs)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; needs a card) or cpu")
    args = ap.parse_args(argv)

    cfg = smoke_config("codeqwen1.5-7b")
    if args.big:
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, d_ff=3072, n_heads=12,
            n_kv_heads=12, head_dim=64, vocab_size=32768,
        )
    print(f"arch={cfg.name} (reduced) params~"
          f"{cfg.param_count() / 1e6:.1f}M optimizer={cfg.optimizer}")
    tcfg = TrainerConfig(
        steps=args.steps,
        checkpoint_every=50,
        checkpoint_dir=args.ckpt_dir,
        log_every=20,
        lr=1e-3,
        global_batch=8,
        seq_len=128,
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    history = trainer.run()
    losses = [h["loss"] for h in history]
    if len(losses) >= 20:
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        print(f"loss {first:.3f} -> {last:.3f} "
              f"({'improved' if last < first else 'NOT improving'})")


if __name__ == "__main__":
    main()
