#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the four dense attention kernels from ``src/repro_torch/kernels/
   csrc`` (one nvcc per source, in parallel) and prints the build time;
3. kernel phase: holds each kernel against its plain PyTorch version at the
   main path's shapes (Hq=32, Hkv=8, D=128) in bfloat16 and float32, and
   times kernel, plain version and — as a yardstick the port never calls —
   ``scaled_dot_product_attention``, beside the least time the card could
   take (bound);
4. path phase: builds a skipless Mistral-7B at full width on the card from
   a seeded generator, merges it exactly (``merge_skipless(..., "qp")``)
   and serves 4 prompts (16, 37, 100, 250 tokens; 16 new tokens each)
   through ``Engine(cache="dense")``, merged and source, in float32:
   - at 4 layers, calibrated so activations stay O(1) (see ``build``), the
     greedy streams must be identical and the merged prefill logits must
     agree with the plain PyTorch forward.  A random skipless GLU stack
     amplifies float32 rounding roughly 2x per layer and has no well-scaled
     regime at depth (``tools/skipless_depth.py``), so this is the depth at which float32 can hold two
     mathematically identical models token-identical;
   - at the full 32 layers the launch counters must show that the merged
     engine ran only the merged kernels (32 flash launches per prompt, 32
     decode launches per step) and the source only the generic ones; the
     merged model then serves in bfloat16, and tok/s, TTFT and a profile of
     its decode steps are printed beside the card's name;
5. prints one JSON line of per-kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises (non-zero exit, no result lines).  Without a CUDA card,
or without the repository's ``src/`` beside it, the script exits non-zero
before printing anything else.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {"torch.bfloat16": 989e12,  # dense tensor-core bf16
              "torch.float32": 67e12}  # float32 outside the tensor cores
TOL_F32 = 5e-5
BF16_EPS = 2.0 ** -7  # spacing of bfloat16 numbers in [1, 2)
TOL_BF16_MAX = 2e-2  # flash rows: O(1) outputs, one ulp near 2 is 7.8e-3
Hq, Hkv, D = 32, 8, 128  # Mistral-7B's attention shape
L2_BYTES = 50e6

KERNELS = {
    "flash_attention_bhsd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:121"),
    "flash_attention_merged_bsd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:185"),
    "decode_attention_bhsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:112"),
    "decode_attention_merged_bsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:172"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, n_sets: int, iters: int = 30) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls cycling through
    ``n_sets`` input sets (enough sets that the L2 cache is cold for each
    call, as it is for the real caller), by CUDA events after a warm-up."""
    import torch
    for i in range(3):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tolerance(want, dtype) -> float:
    """Max abs error allowed against the plain version: 5e-5 in float32;
    in bfloat16 two ulps at the reference's largest magnitude, capped at
    2e-2, so a kernel whose outputs are small (decode: |out| ~ 0.1) is
    held to a few of its own ulps rather than to the flash rows' O(1)."""
    import torch
    if dtype == torch.float32:
        return TOL_F32
    return min(TOL_BF16_MAX, 2 * BF16_EPS * float(want.float().abs().max()))


def n_sets_for(nbytes: int) -> int:
    return max(2, min(32, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def bound_ms(nbytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the flops over the dtype's peak; both are kept."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype)] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_ms=t_bytes, ops_ms=t_ops)


def ring_positions(rng, S, q_pos, hole_frac):
    """kv positions of a ring cache of S slots after positions 0..q_pos
    were written: slot s holds the latest p = s (mod S) not beyond q_pos,
    -1 if none; a fraction of the slots is emptied."""
    import numpy as np
    s = np.arange(S)[None, :]
    qp = np.asarray(q_pos)[:, None]
    pos = np.where(s <= qp, s + S * ((qp - s) // S), -1)
    pos = np.where(rng.random(pos.shape) < hole_frac, -1, pos)
    return pos.astype(np.int32)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def decode_phase(rng, rows):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk, ref

    B, S = 4, 512
    G = Hq // Hkv
    dev = torch.device("cuda")
    cases = [("window 64, empty slots", 64, [40, 300, 511, 1000], 0.1),
             ("no window, full ring", 0, [511, 600, 777, 1000], 0.0)]
    for dtype in (torch.bfloat16, torch.float32):
        for label, window, q_pos, holes in cases:
            kvp_np = ring_positions(rng, S, q_pos, holes)
            qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
            kvp = torch.from_numpy(kvp_np).to(dev)
            ok = (kvp >= 0) & (kvp <= qp[:, None])
            if window:
                ok &= qp[:, None] - kvp < window
            n_att = int(ok.sum())
            el = torch.tensor([], dtype=dtype).element_size()
            set_bytes = 2 * B * S * Hkv * D * el
            n_sets = n_sets_for(set_bytes)

            def rand(*shape):
                return torch.from_numpy(rng.standard_normal(
                    shape, np.float32)).to(dev, dtype)

            us = [rand(B, Hq, D) for _ in range(n_sets)]
            ks = [rand(B, S, Hkv, D) for _ in range(n_sets)]
            vs = [rand(B, S, Hkv, D) for _ in range(n_sets)]
            khs = [k.transpose(1, 2).contiguous() for k in ks]
            vhs = [v.transpose(1, 2).contiguous() for v in vs]
            nbytes = (2 * n_att * Hkv * D * el + 2 * B * Hq * D * el
                      + B * S * 4 + B * 4)
            flops = 4 * D * Hq * n_att
            bound = bound_ms(nbytes, flops, dtype)
            mask = ok[:, None, None, :]  # (B, 1, 1, S)

            def sdpa(i):
                return F.scaled_dot_product_attention(
                    us[i].reshape(B, Hq, 1, D), khs[i], vhs[i],
                    attn_mask=mask, enable_gqa=True)

            for name in ("decode_attention_merged_bsd",
                         "decode_attention_bhsd"):
                if name == "decode_attention_merged_bsd":
                    def kern(i):
                        return dk.decode_attention_merged_bsd(
                            us[i], ks[i], vs[i], kvp, qp,
                            sliding_window=window)

                    def plain(i):
                        return ref.ref_decode_attention_merged(
                            us[i], ks[i], vs[i], kvp, qp,
                            sliding_window=window)
                else:
                    def kern(i):
                        return dk.decode_attention_bhsd(
                            us[i].reshape(B, Hkv, G, D), khs[i], vhs[i],
                            kvp, qp, sliding_window=window).reshape(B, Hq, D)

                    def plain(i):
                        return ref.ref_decode_attention(
                            us[i].reshape(B, Hkv, G, D), khs[i], vhs[i],
                            kvp, qp, sliding_window=window).reshape(B, Hq, D)
                got, want = kern(0), plain(0)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                tol = tolerance(want, dtype)
                if not err <= tol:
                    raise AssertionError(
                        f"{name} {dtype} {label}: max abs err {err} > {tol}")
                rows.append(dict(
                    name=name, dtype=str(dtype), case=f"B={B} S={S} {label}",
                    max_abs_err=err, tol=tol, ms=cuda_ms(kern, n_sets),
                    plain_ms=cuda_ms(plain, n_sets), **bound,
                    library_ms=cuda_ms(sdpa, n_sets),
                    timed=(label.startswith("no window")
                           and dtype == torch.bfloat16)))
            del us, ks, vs, khs, vhs


def flash_phase(rng, rows):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk, ref

    B = 1
    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()
        for S in (16, 37, 250, 512):
            for window in (0, 64):
                nbytes = B * S * (2 * Hq + 2 * Hkv) * D * el  # q, k, v, out
                n_sets = n_sets_for(nbytes)

                def rand(*shape):
                    return torch.from_numpy(rng.standard_normal(
                        shape, np.float32)).to(dev, dtype)

                us = [rand(B, S, Hq, D) for _ in range(n_sets)]
                ks = [rand(B, S, Hkv, D) for _ in range(n_sets)]
                vs = [rand(B, S, Hkv, D) for _ in range(n_sets)]
                qh = [u.transpose(1, 2).contiguous() for u in us]
                kh = [k.transpose(1, 2).contiguous() for k in ks]
                vh = [v.transpose(1, 2).contiguous() for v in vs]
                i_ = torch.arange(S, device=dev)
                ok = i_[None, :] <= i_[:, None]
                if window:
                    ok &= i_[:, None] - i_[None, :] < window
                pairs = int(ok.sum())
                flops = 4 * D * Hq * B * pairs
                bound = bound_ms(nbytes, flops, dtype)

                def sdpa(i):
                    if window:
                        return F.scaled_dot_product_attention(
                            qh[i], kh[i], vh[i], attn_mask=ok,
                            enable_gqa=True)
                    return F.scaled_dot_product_attention(
                        qh[i], kh[i], vh[i], is_causal=True, enable_gqa=True)

                for name in ("flash_attention_merged_bsd",
                             "flash_attention_bhsd"):
                    if name == "flash_attention_merged_bsd":
                        def kern(i):
                            return fk.flash_attention_merged_bsd(
                                us[i], ks[i], vs[i], sliding_window=window)

                        def plain(i):
                            return ref.ref_flash_attention_merged(
                                us[i], ks[i], vs[i], sliding_window=window)
                    else:
                        def kern(i):
                            return fk.flash_attention_bhsd(
                                qh[i], kh[i], vh[i], sliding_window=window)

                        def plain(i):
                            return ref.ref_attention(
                                qh[i], kh[i], vh[i], sliding_window=window)
                    got, want = kern(0), plain(0)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    tol = tolerance(want, dtype)
                    if not err <= tol:
                        raise AssertionError(
                            f"{name} {dtype} S={S} window={window}: max abs "
                            f"err {err} > {tol}")
                    rows.append(dict(
                        name=name, dtype=str(dtype),
                        case=f"B={B} Sq=Sk={S} causal window={window}",
                        max_abs_err=err, tol=tol, ms=cuda_ms(kern, n_sets),
                        plain_ms=cuda_ms(plain, n_sets), **bound,
                        library_ms=cuda_ms(sdpa, n_sets),
                        timed=(S == 250 and window == 0
                               and dtype == torch.bfloat16)))
                del us, ks, vs, qh, kh, vh


# ---------------------------------------------------------------------------
# path phase
# ---------------------------------------------------------------------------

def serve(cfg, params, prompts, max_new):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import Engine, ServeConfig
    import torch

    eng = Engine(cfg, params, ServeConfig(n_slots=4, max_len=512),
                 impl="cuda", cache="dense", device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()  # counts cover exactly this serve
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, outs, launch_counts(), wall


def check_counts(tag, counts, eng, n_layers, n_prompts, merged):
    flash_k = "flash_attention_merged_bsd" if merged else "flash_attention_bhsd"
    dec_k = "decode_attention_merged_bsd" if merged else "decode_attention_bhsd"
    want = {k: 0 for k in KERNELS}
    want[flash_k] = n_layers * n_prompts
    want[dec_k] = n_layers * eng.stats["n_steps"]
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts} != {want}")
    log(f"  {tag}: launches {counts} ({eng.stats['n_steps']} decode steps)")


def first_mismatch(cfg, params, prompts, a, b):
    """(prompt, position, top-2 margin of the source logits there)."""
    import numpy as np
    import torch
    from repro_torch.models import forward_seq
    for i, (x, y) in enumerate(zip(a, b)):
        if list(x) == list(y):
            continue
        j = next(t for t in range(len(x)) if x[t] != y[t])
        toks = np.concatenate([prompts[i], np.asarray(x[:j], np.int64)])
        with torch.no_grad():
            lg, _, _ = forward_seq(params, cfg, torch.as_tensor(
                toks, device="cuda")[None], impl="cuda")
        top = torch.topk(lg[0, -1, :cfg.vocab_size].float(), 2).values
        return i, j, float(top[0] - top[1])
    return None


EQ_LAYERS = 4  # depth of the float32 merged-vs-source identity check


def build(n_layers, calibrate):
    """A skipless Mistral-7B of ``n_layers`` at full width on the card, and
    its exact qp merge.

    A random skipless GLU stack maps its signal scale roughly as
    s -> c * s**2, an unstable fixed point: uncalibrated, the signal
    underflows to exactly zero within a few layers (all logits 0).
    ``calibrate`` rescales each layer's w_down so that its output RMS on a
    seeded calibration prompt is 1 (deterministic from the seed, applied
    before the merge, which is exact for any weights).  That keeps other
    prompts O(1) for a few layers only: by 8 layers their scale wanders by
    orders of magnitude, and by 32 it overflows."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import merge_skipless, removed_weight_count
    from repro_torch.models import init_params
    from repro_torch.models.transformer import (apply_block_seq,
                                                embed_inputs, layer_params)

    cfg = get_config("mistral-7b").with_(block_style="skipless",
                                         dtype="float32", n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    calib = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 64)), device="cuda")
    pos = torch.arange(64, device="cuda")[None]
    with torch.no_grad():
        h = embed_inputs(params, cfg, calib)
        for i in range(n_layers if calibrate else 0):
            out, _ = apply_block_seq(layer_params(params, i), cfg, h,
                                     {"positions": pos, "impl": "cuda"})
            r = out.pow(2).mean().sqrt()
            params["layers"]["ffn"]["w_down"][i] /= r
            h = out / r
    torch.cuda.synchronize()
    log(f"init {cfg.name} skipless ({n_layers} layers, d_model {cfg.d_model},"
        f" d_ff {cfg.d_ff}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, vocab "
        f"{cfg.vocab_size}) on the card"
        f"{', calibrated' if calibrate else ''}: "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    torch.cuda.synchronize()
    log(f"merge qp (float64, layer by layer, on the card): "
        f"{time.perf_counter() - t0:.1f} s; removed "
        f"{removed_weight_count(params, mparams):,d} weights")
    return cfg, params, mcfg, mparams


def path_phase(summary):
    import numpy as np
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.models import DensePrefillDest, forward_prefill

    rng = np.random.default_rng(0)
    lens = (16, 37, 100, 250)
    prompts = [rng.integers(0, 32000, n) for n in lens]
    max_new, n = 16, len(lens)

    with torch.no_grad():
        # 1. float32 at a depth float32 can hold merged == source exactly
        cfg, params, mcfg, mparams = build(EQ_LAYERS, calibrate=True)
        src, src_out, counts, _ = serve(cfg, params, prompts, max_new)
        check_counts("source (generic) float32", counts, src, EQ_LAYERS, n,
                     merged=False)
        mrg, mrg_out, counts, _ = serve(mcfg, mparams, prompts, max_new)
        check_counts("merged float32", counts, mrg, EQ_LAYERS, n, merged=True)
        if [list(o) for o in src_out] != [list(o) for o in mrg_out]:
            bad = first_mismatch(cfg, params, prompts, src_out, mrg_out)
            raise AssertionError(
                f"merged and source greedy streams differ: prompt {bad[0]}, "
                f"position {bad[1]}, source top-2 logit margin {bad[2]:.3g}")
        log(f"  greedy streams identical (merged vs source, float32, "
            f"{EQ_LAYERS} layers): {[list(o[:6]) for o in mrg_out]} …")
        # the kernels' path against the plain PyTorch forward on one prompt
        x = torch.as_tensor(prompts[1], device="cuda")[None]
        lg_k, _ = forward_prefill(mparams, mcfg, x, DensePrefillDest(512),
                                  impl="cuda")
        lg_p, _ = forward_prefill(mparams, mcfg, x, DensePrefillDest(512),
                                  impl="torch")
        scale = float(lg_p.abs().max())
        diff = float((lg_k - lg_p).abs().max())
        if not (torch.isfinite(lg_k).all() and lg_k.shape == lg_p.shape
                and 0 < scale and diff <= 1e-4 * scale):
            raise AssertionError(f"merged prefill logits vs plain forward: "
                                 f"max diff {diff} (scale {scale})")
        log(f"  merged prefill logits vs plain PyTorch forward (37 tokens):"
            f" max |diff| {diff:.3g} at logit scale {scale:.3g}")
        del src, mrg, params, mparams
        torch.cuda.empty_cache()

        # 2. the full 32-layer model, uncalibrated (its activations decay to
        # exact zeros, which costs the kernels and matmuls the same work):
        # launch counts on the main path, and speed
        cfg, params, mcfg, mparams = build(32, calibrate=False)
        L = cfg.n_layers
        src, _, src_counts, _ = serve(cfg, params, prompts, max_new)
        check_counts("source (generic) float32", src_counts, src, L, n,
                     merged=False)
        mrg, _, mrg_counts, _ = serve(mcfg, mparams, prompts, max_new)
        check_counts("merged float32", mrg_counts, mrg, L, n, merged=True)
        summary["launches"] = {k: src_counts[k] + mrg_counts[k]
                               for k in KERNELS}
        lg, _ = forward_prefill(mparams, mcfg, x, DensePrefillDest(512),
                                impl="cuda")
        if not torch.isfinite(lg).all():
            raise AssertionError(f"{L}-layer merged logits are not finite")
        log(f"  {L} layers, uncalibrated: logits finite, max |logit| "
            f"{float(lg.abs().max()):.3g}")
        for tag, c, p in (("source", cfg, params),
                          ("merged", mcfg, mparams)):
            eng, outs, _, wall = serve(c, p, prompts, max_new)
            summary[f"{tag}_f32"] = report(f"{tag} float32 ({L} layers)",
                                           outs, wall)
        del eng, src, mrg, params, p
        torch.cuda.empty_cache()
        bcfg = mcfg.with_(dtype="bfloat16", param_dtype="bfloat16")
        bparams = tree_map(lambda t: t.to(torch.bfloat16), mparams)
        del mparams
        torch.cuda.empty_cache()
        serve(bcfg, bparams, prompts, max_new)  # warm-up
        eng, outs, counts, wall = serve(bcfg, bparams, prompts, max_new)
        check_counts("merged bfloat16", counts, eng, L, n, merged=True)
        if not all(0 <= t < bcfg.vocab_size for o in outs for t in o):
            raise AssertionError("bfloat16 serve emitted out-of-vocab ids")
        summary["merged_bf16"] = report(f"merged bfloat16 ({L} layers)",
                                        outs, wall)
        summary["decode_profile_bf16"] = profile_decode(bcfg, bparams,
                                                        prompts)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")


def profile_decode(cfg, params, prompts, steps=5):
    """torch.profiler over ``steps`` batched decode steps of the 4-slot
    engine (prompts prefilled first): device time by kernel name and the
    device busy share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import Engine, Request, ServeConfig

    eng = Engine(cfg, params, ServeConfig(n_slots=4, max_len=512),
                 impl="cuda", device="cuda")
    for p in prompts:
        eng.submit(Request(prompt=p, max_new_tokens=steps + 2))
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side rows only: a CPU op's row (aten::mm) also carries the
    # device time of the kernels it launched, which have rows of their own
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
           "device_ms_per_step": busy / steps * 1e3,
           "device_busy_share": busy / wall,
           "kernels_per_step": sum(r[2] for r in rows) // steps,
           "top": [[k, us / steps / 1e3, n // steps] for us, k, n in rows[:8]]}
    log(f"  decode profile, {cfg.dtype} ({cfg.n_layers} layers, 4 slots, "
        f"{steps} steps): {out['wall_ms_per_step']:.2f} ms/step wall, "
        f"{out['device_ms_per_step']:.2f} ms/step of kernels "
        f"({100 * out['device_busy_share']:.0f}% busy), "
        f"{out['kernels_per_step']} kernel launches/step")
    for k, ms, n in out["top"]:
        log(f"    {ms:8.3f} ms/step  {n:4d} calls/step  {k[:90]}")
    if not rows:
        log("    (the profiler recorded no device time)")
    return out


def report(tag, outs, wall):
    import numpy as np
    n = sum(len(o) for o in outs)
    ttft = [o.ttft_s for o in outs]
    dec = [o.decode_tok_s for o in outs if o.decode_tok_s]
    r = {"tok_s": n / wall, "ttft_mean_s": float(np.mean(ttft)),
         "ttft_max_s": float(np.max(ttft)),
         "decode_tok_s_mean": float(np.mean(dec)), "tokens": n,
         "wall_s": wall}
    log(f"  {tag}: {n} tokens in {wall:.3f} s = {r['tok_s']:.1f} tok/s; "
        f"TTFT mean {r['ttft_mean_s'] * 1e3:.1f} ms / max "
        f"{r['ttft_max_s'] * 1e3:.1f} ms; per-request decode "
        f"{r['decode_tok_s_mean']:.1f} tok/s")
    return r


# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = f"{smi}"
    print(card, flush=True)

    t0 = time.perf_counter()
    _build.build_all()
    log(f"built {len(_build.SOURCES)} CUDA sources with nvcc in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, out in _build.build_logs.items():
        regs = [ln.split(":", 1)[1].strip() for ln in out.splitlines()
                if "Used" in ln]
        log(f"  {name}: ptxas {'; '.join(sorted(set(regs)))}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    rows = []
    decode_phase(rng, rows)
    flash_phase(rng, rows)
    log(f"kernel phase ({card}; times in ms, L2 cold; bound = the larger "
        f"of the bytes at 3.35 TB/s and the flops at the dtype's peak):")
    for r in rows:
        log(f"  {r['name']:28s} {r['dtype']:15s} {r['case']:34s} err "
            f"{r['max_abs_err']:.2e} (tol {r['tol']:.1e})  kernel "
            f"{r['ms']:.4f}  plain {r['plain_ms']:.4f}  sdpa "
            f"{r['library_ms']:.4f}  bound {r['bound_ms']:.5f} "
            f"({r['bound_by']}; bytes {r['bytes_ms']:.5f}, flops "
            f"{r['ops_ms']:.5f})")

    summary = {}
    path_phase(summary)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        mine = [r for r in rows if r["name"] == name]
        t = next(r for r in mine if r["timed"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": summary["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    log(f"serving summary ({card}): "
        f"{json.dumps({k: v for k, v in summary.items() if k != 'launches'})}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
