"""Serving launcher: batched generation on the dense cache, the paged pool
or the int8 paged pool, greedy or (``--temperature`` > 0) sampled from
per-request streams seeded by ``--seed``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-7b \
      --smoke --merged-from-skipless --requests 4 --max-new 8 \
      [--cache paged|paged_q8 --block-size 16 --n-blocks 0]

``--arch`` is one of the port's configs: the dense stacks mistral-7b,
llama3.2-1b, phi3-medium-14b, qwen2.5-32b, chatglm3-6b and pythia-6.9b
(parallel blocks: no merge, serve it as the source), the MoE stacks
phi3.5-moe-42b-a6.6b and moonshot-v1-16b-a3b (the merge folds P into the
router and every expert), hymba-1.5b (hybrid:
attention beside SSM heads) or mamba2-2.7b (attention-free, standard
style; dense cache only, as for the hybrid).  With
``--merged-from-skipless`` the launcher builds a skipless model, runs the
paper's qp merge (QP removal; on the hybrid Q removal, P stays), and
serves the merged weights, reporting the parameters removed next to the
generated tokens.  ``--device`` defaults to
``cuda`` (the hand-written kernels); ``--device cpu`` serves through the
plain PyTorch versions.  Per-request stats (prompt length, time to first
token, decode tok/s) come from ``Engine.generate``'s RequestResults.
``--n-blocks 0`` sizes the paged pool like the dense cache
(slots x max_len / block size pages).  The paged pools print their
occupancy counters, and the int8 pool its resident bytes (int8 pages and
their scales).
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
    ap.add_argument("--cache", default="dense",
                    choices=("dense", "paged", "paged_q8"))
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0)
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
        what = "Q" if cfg.family == "hybrid" else "QP"
        print(f"{what} removal: {n0:,d} -> {n1:,d} params "
              f"({100 * (n0 - n1) / n0:.1f}% removed)", flush=True)

    sc = ServeConfig(n_slots=args.slots, max_len=args.max_len,
                     temperature=args.temperature, seed=args.seed,
                     block_size=args.block_size, n_blocks=args.n_blocks)
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
          f"on {eng.device}, {args.cache} cache; {eng.stats}", flush=True)
    if eng.paged:
        a = eng.pm.allocator
        print(f"  paged pool: {a.n_blocks} pages, peak used {a.peak_used}, "
              f"shared {a.n_shared_hits}, cow {a.n_cow}, recycled "
              f"{a.n_recycled}", flush=True)
    if args.cache == "paged_q8":
        print(f"  q8 pool: {eng.pm.pool_bytes:,d} bytes resident (int8 "
              f"pages + scales)", flush=True)
    for i, o in enumerate(outs[:4]):
        rate = "n/a" if o.decode_tok_s is None else f"{o.decode_tok_s:.1f}"
        print(f"  req{i}: {list(o[:12])}{'…' if len(o) > 12 else ''} "
              f"(ttft {o.ttft_s:.3f}s, {rate} tok/s decode)")
    return outs


if __name__ == "__main__":
    main()
