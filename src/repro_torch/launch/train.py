"""End-to-end training launcher, the counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --steps 20 --device cpu

``--smoke`` uses the reduced config (CPU-friendly); omit it on the card to
train the full architecture.  ``--device`` is ``cuda`` by default, which
raises without a card.  The reference's ``--mesh`` comes with the port of
``distribution/``.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--block-style", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--corpus", default=None, help="path to a text file")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduce_config
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    if args.block_style:
        cfg = cfg.with_(block_style=args.block_style)
        cfg.validate_style()

    tc = TrainerConfig(steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       lr=args.lr, warmup=args.warmup,
                       grad_accum=args.grad_accum, optimizer=args.optimizer,
                       seed=args.seed)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq_len,
                    seed=args.seed)
    trainer = Trainer(cfg, tc, dc, corpus_path=args.corpus,
                      device=args.device)
    print(f"training {cfg.name} [{cfg.block_style}] on {trainer.device} "
          f"from step {trainer.start_step} to {tc.steps}", flush=True)
    metrics = trainer.run()
    print("final:", metrics, flush=True)


if __name__ == "__main__":
    main()
