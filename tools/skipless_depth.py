"""Numerics of a random skipless SwiGLU stack in depth, through the port.

For each depth: build a skipless Mistral-7B-shaped model from seed 0,
rescale each layer's w_down so its output RMS on a seeded 64-token
calibration prompt is 1 (as ``chip_smoke.py`` does), merge it exactly
(qp), then run four other prompts (16, 37, 100, 250 tokens) and report
  * the range of per-layer activation RMS over those prompts, and
  * the max relative difference between the source's and the merged
    model's float32 logits (mathematically identical models).

    PYTHONPATH=src python tools/skipless_depth.py --device cpu \
        --d-model 1024 --n-heads 8 --n-kv-heads 2 --d-ff 3584 --layers 2 4 8 32

Defaults are Mistral-7B's width on the card.  The numbers are numerics of
the model, not device metrics, and do not depend on where they run beyond
float32 rounding.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4, 8, 32])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=4096)
    ap.add_argument("--n-heads", type=int, default=32)
    ap.add_argument("--n-kv-heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=14336)
    ap.add_argument("--vocab", type=int, default=4096)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import merge_skipless
    from repro_torch.models import forward_seq, init_params
    from repro_torch.models.transformer import (apply_block_seq,
                                                embed_inputs, layer_params)

    impl = "cuda" if args.device.startswith("cuda") else "torch"
    dev = torch.device(args.device)

    def layer_rms(params, cfg, toks):
        pos = torch.arange(toks.shape[1], device=dev)[None]
        h = embed_inputs(params, cfg, toks)
        out = []
        for i in range(cfg.n_layers):
            h, _, _, _ = apply_block_seq(layer_params(params, i), cfg, h,
                                         {"positions": pos, "impl": impl})
            out.append(float(h.pow(2).mean().sqrt()))
        return out

    print(f"d_model {args.d_model}, heads {args.n_heads}/{args.n_kv_heads},"
          f" d_ff {args.d_ff}, vocab {args.vocab}, {args.device}")
    print("layers  prompt  rms_min     rms_max     logits_finite  "
          "max_rel_diff_merged_vs_source")
    for L in args.layers:
        cfg = get_config("mistral-7b").with_(
            block_style="skipless", dtype="float32", n_layers=L,
            d_model=args.d_model, n_heads=args.n_heads,
            n_kv_heads=args.n_kv_heads, d_head=args.d_model // args.n_heads,
            d_ff=args.d_ff, vocab_size=args.vocab)
        params = init_params(cfg, seed=0, device=dev)
        rng = np.random.default_rng(1)
        calib = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 64)),
                                device=dev)
        with torch.no_grad():
            pos = torch.arange(64, device=dev)[None]
            h = embed_inputs(params, cfg, calib)
            for i in range(L):
                out, _, _, _ = apply_block_seq(
                    layer_params(params, i), cfg, h,
                    {"positions": pos, "impl": impl})
                r = out.pow(2).mean().sqrt()
                params["layers"]["ffn"]["w_down"][i] /= r
                h = out / r
            mparams, mcfg = merge_skipless(params, cfg, "qp")
            rng = np.random.default_rng(0)
            for n in (16, 37, 100, 250):
                toks = torch.as_tensor(
                    rng.integers(0, cfg.vocab_size, (1, n)), device=dev)
                rms = layer_rms(params, cfg, toks)
                a = forward_seq(params, cfg, toks, impl=impl)[0]
                b = forward_seq(mparams, mcfg, toks, impl=impl)[0]
                finite = bool(torch.isfinite(a).all())
                rel = float((a - b).abs().max() / a.abs().max()) \
                    if finite and float(a.abs().max()) > 0 else float("nan")
                print(f"{L:6d}  {n:6d}  {min(rms):10.3e}  {max(rms):10.3e}  "
                      f"{str(finite):13s}  {rel:.3e}", flush=True)


if __name__ == "__main__":
    main()
