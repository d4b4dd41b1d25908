"""End-to-end training launcher, the counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --smoke --steps 20 --device cpu

``--smoke`` uses the reduced config (CPU-friendly); omit it on the card to
train the full architecture.  ``--device`` is ``cuda`` by default, which
raises without a card.  ``--mesh DxM`` trains on a data x model device
mesh, one process per rank, under ``torchrun`` (whose environment gives
the process group: NCCL on the cards, gloo with ``--device cpu``):

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3.2-1b --smoke --steps 20 --mesh 2x2 --device cpu

On the cards each rank takes ``cuda:<LOCAL_RANK>``.  Rank 0 alone writes
the checkpoints and prints the metrics.
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
    ap.add_argument("--mesh", default=None, help="DxM mesh, e.g. 2x2 "
                    "(under torchrun)")
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

    device, mesh = args.device, None
    if args.mesh:
        import os

        import torch.distributed as dist

        from repro_torch._device import resolve_device
        from repro_torch.launch.mesh import make_mesh

        d, m = (int(x) for x in args.mesh.split("x"))
        dev = resolve_device(device)
        if dev.type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            import torch
            torch.cuda.set_device(torch.device(device))
        if not dist.is_initialized():  # torchrun's environment
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_mesh((d, m), ("data", "model"), device_type=dev.type)

    tc = TrainerConfig(steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       lr=args.lr, warmup=args.warmup,
                       grad_accum=args.grad_accum, optimizer=args.optimizer,
                       seed=args.seed)
    dc = DataConfig(global_batch=args.batch, seq_len=args.seq_len,
                    seed=args.seed)
    trainer = Trainer(cfg, tc, dc, corpus_path=args.corpus, device=device,
                      mesh=mesh)
    where = trainer.device if mesh is None else f"{args.mesh} {mesh}"
    say = print if trainer.writer else (lambda *a, **k: None)
    say(f"training {cfg.name} [{cfg.block_style}] on {where} "
        f"from step {trainer.start_step} to {tc.steps}", flush=True)
    metrics = trainer.run()
    say("final:", metrics, flush=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
