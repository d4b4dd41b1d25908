"""Serving launcher: batched greedy generation on the dense cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \
      --smoke --merged-from-skipless --requests 4 --max-new 8

With ``--merged-from-skipless`` the launcher builds a skipless model, runs
the paper's QP-removal merge, and serves the merged weights, reporting the
parameters removed next to the generated tokens.  ``--device`` defaults to
``cuda`` (the hand-written kernels); ``--device cpu`` serves through the
plain PyTorch versions.  Per-request stats (prompt length, time to first
token, decode tok/s) come from ``Engine.generate``'s RequestResults.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--block-style", default=None)
    ap.add_argument("--merged-from-skipless", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--cache", default="dense", choices=("dense",))
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import merge_skipless
    from repro_torch.models import count_params, init_params
    from repro_torch.serving import Engine, ServeConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_config(cfg)
    if args.merged_from_skipless:
        cfg = cfg.with_(block_style="skipless")
    elif args.block_style:
        cfg = cfg.with_(block_style=args.block_style)
    cfg.validate_style()

    params = init_params(cfg, args.seed, device=args.device)
    n0 = count_params(params)
    if args.merged_from_skipless:
        params, cfg = merge_skipless(params, cfg, "qp")
        n1 = count_params(params)
        print(f"QP removal: {n0:,d} -> {n1:,d} params "
              f"({100 * (n0 - n1) / n0:.1f}% removed)", flush=True)

    sc = ServeConfig(n_slots=args.slots, max_len=args.max_len,
                     temperature=args.temperature)
    impl = "cuda" if args.device.startswith("cuda") else "torch"
    eng = Engine(cfg, params, sc, impl=impl, cache=args.cache,
                 device=args.device)
    rng = np.random.RandomState(args.seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=(args.prompt_len,))
               for _ in range(args.requests)]
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=args.max_new)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o) for o in outs)
    ttfts = [o.ttft_s for o in outs]
    print(f"served {args.requests} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s); "
          f"TTFT mean {np.mean(ttfts):.3f}s / max {np.max(ttfts):.3f}s "
          f"on {eng.device}", flush=True)
    for i, o in enumerate(outs[:4]):
        rate = "n/a" if o.decode_tok_s is None else f"{o.decode_tok_s:.1f}"
        print(f"  req{i}: {list(o[:12])}{'…' if len(o) > 12 else ''} "
              f"(ttft {o.ttft_s:.3f}s, {rate} tok/s decode)")
    return outs


if __name__ == "__main__":
    main()
