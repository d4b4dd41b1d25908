#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA card.  Run from the repository root:

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the ten kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and prints the build time, each source's
   ptxas register counts and the decode kernel's occupancy per
   instantiation (``decode_occupancy``: Mistral's 32 clusters of 8 splits
   at B=4 must be resident at once);
3. quantize check: the int8 quantization (``kernels.quant``: pages, a
   masked sequence, decode appends that enter fresh pages and grow
   scales) gives the same ints and scales on the card as on the CPU;
4. kernel phase: holds each kernel against its plain PyTorch version at the
   main paths' shapes in bfloat16 and float32 — the attention kernels at
   Mistral-7B's (Hq=32, Hkv=8, D=128): dense caches, page pools behind
   permuted block tables with -1 holes, a shared page and a wrapped ring,
   the same tables over int8 pools whose unmapped pages have NaN scales,
   and int8 prompt K*/V*; the flash kernels also at long prompts in
   bf16 (2048 and 4096 tokens causal, 2048 with window 512, q8 at 2048)
   and at 2048 in float32; the generic flash and decode kernels also at
   Hymba-1.5B's (Hq=25, Hkv=5, D=64; flash also at 2048 with its window of
   1024); the decode kernels (rows 4-9) also at ChatGLM3-6B's (Hq=32,
   Hkv=2, D=128: 16 query heads per kv head, two parts of the group) and
   rows 4-5 at G 12 (Hq=24, Hkv=2: a part that is not full); row 1
   non-causal at the VLM's cross prefill (Sq 250 over Sk 1600 vision
   tokens, Hq 32, Hkv 8, D 128) and at HuBERT's layer (B 4, Sq = Sk =
   1000, MHA 16 of D 80), row 4 at the VLM's cross decode step (B 4, 1600
   vision tokens, the cache read in place) (``cross_phase``); the SSD scan
   at Hymba's (H 50, P 64,
   N 16; 250, 512 and 2048 tokens) and Mamba2-2.7B's (H 80, P 64, N 128;
   256, 512 and 2048), after printing its occupancy per instantiation
   (``ssd_occupancy``: a whole wave of clusters must cover every SM) —
   and times kernel, plain
   version and, as a yardstick the port never calls,
   ``scaled_dot_product_attention`` (for the paged kernels: on the cache
   already gathered, the gather not timed; for the int8 kernels: on the
   K/V already dequantized, the dequant not timed; the SSD scan has no
   such call), beside the least time the card could take (bound).  Times
   come from CUDA graphs of 30 calls (``cuda_ms``), three timed replays
   each.  First, ``torch.profiler`` counts the device kernels per call
   of each of the six decode wrappers (rows 4-9, at Mistral's and at
   ChatGLM3's shapes) and of the SSD scan (row 10) on bf16 inputs of the
   main path's shapes, which must be one.  Rows
   6-9 also run with one batch row SHIELDED (``shielded_phase``: its table
   all -1 at a length > 0, as the scheduler ships a slot mid-chunked-
   prefill): that row must be exactly zero, the others the plain
   versions'; and rows 4-9 in the partial-state mode over the boxes of
   model axes 2 and 4 (``split_k_phase``): combined, the whole kernel;
5. path phase, Mistral-7B: builds a skipless Mistral-7B at full width on
   the card from a seeded generator, merges it exactly
   (``merge_skipless(..., "qp")``) and serves 4 prompts (16, 37, 100, 250
   tokens; 16 new tokens each), merged and source, in float32:
   - at 4 layers, calibrated so activations stay O(1) (see ``build``), the
     greedy streams through ``Engine(cache="dense")`` must be identical,
     the merged prefill logits must agree with the plain PyTorch forward,
     and ``Engine(cache="paged")`` must give the dense streams: on a
     dense-sized pool, on a pool too small for all four (deferral,
     preemption and resume), with a repeated prompt (shared pages,
     copy-on-write), and with the window cut to 64 so the ring wraps (ring
     recycling).  A random skipless GLU stack amplifies float32 rounding
     roughly 2x per layer and has no well-scaled regime at depth
     (``tools/skipless_depth.py``), so this is the depth at which float32
     can hold two mathematically identical models token-identical.
     ``Engine(cache="paged_q8")`` then serves both models on the int8 pool:
     the same deferral and preemption, a copy-on-write that moves a page's
     scale rows with its ints, and a ring recycle whose page scale is reset
     at offset 0 are asserted; how far its streams agree with the fp
     pool's and merged with source, how many pool ints the two models'
     250-token prefills store differently, and the q8 prefill's logit
     error against the fp pool's are printed (int8 rounding boundaries
     fall differently under float drift, so these are findings, not
     gates);
   - at the full 32 layers the launch counters must show that each engine
     ran only its own kernels (32 flash launches per prompt, 32 decode
     launches per step): merged dense the merged dense pair, source the
     generic pair, on the paged pool the paged decode kernels, and on the
     int8 pool the q8 decode kernels with the q8 flash kernel (merged) or
     the fp flash kernel (source); the merged model then serves in
     bfloat16 on all three caches, and tok/s, TTFT, a profile of its
     decode steps on each cache, profiles of its dense prefill of 250 and
     2048 tokens (with the flash kernels' share of the device time), and
     the peak concurrent streams of the fp and int8 pools at one byte
     budget (prefix retention off) are printed beside the card's name;
   - the scheduled path (``ScheduledEngine``: chunks of 64 tokens, 256
     tokens a step, the four prompts and a repeat of the 250-token one):
     at 4 calibrated layers in float32 its greedy streams equal the
     synchronous engine's on the dense cache and the paged pool, merged
     equal source, a warm prefix hit equals the cold stream, and a starved
     pool (deferral and preemption counted) equals the roomy one; the
     int8 pool's agreement and chunked prefill logit error (gate 10%) are
     printed.  At 32 layers every scheduled engine launches its decode
     kernel exactly once per layer and decode step and no flash kernel
     (a chunk's attention is the eager positions-based core, as in the
     reference); in bfloat16 its iterations, chunks, tok/s, TTFT and a
     profile of one 64-token chunk step (device ms, launches, and the
     eager chunk attention's share) are printed;
   - sampling (temperature 0.8, top-k 50, merged, paged, 4 calibrated
     layers): a stream alone == beside others, a preempting pool == a
     roomy one, scheduled == synchronous, top_k=1 == greedy, and the
     launches per sampled decode step beside the greedy step's;
6. path phase, Hymba-1.5B (``hybrid_path``): skipless at full width and
   its qp merge (Q removed, P kept) on the dense cache, prompts of 16, 37,
   250 and 512 tokens (512: SSM state carried across two 256-token
   chunks), 16 new tokens each: at 4 calibrated layers in float32 merged
   == source and the kernels' prefill logits against the plain forward;
   at 32 layers the launch counts (per prompt 32 flash and 32 SSD
   launches, per decode step 32 decode launches, nothing else), and bf16
   merged and source tok/s, TTFT, and decode and 512-token prefill
   profiles of the merged model; at 4 layers the ``ScheduledEngine``
   (monolithic jobs: SSM state has no mid-prompt checkpoint) gives the
   synchronous engine's streams and flash and SSD launches;
7. path phase, Mamba2-2.7B (``mamba2_path``): 64 layers at full width,
   standard style, the same prompts: kernels vs plain prefill logits in
   float32, the launch counts (64 SSD launches per prompt, nothing else),
   the ``ScheduledEngine``'s monolithic jobs (the synchronous streams and
   SSD launches), bf16 tok/s, TTFT, and decode and 512-token prefill
   profiles (each profile also gives the SSD kernel's device ms);
8. the five other dense configs (``dense_configs_path``): Llama-3.2-1B,
   Phi-3-medium-14B, Qwen2.5-32B, Pythia-6.9B (source only: its parallel
   blocks make the merge raise) and ChatGLM3-6B at full width, the Mistral
   path's prompts: at 4 calibrated layers in float32 merged == source,
   paged == dense and scheduled == synchronous greedy streams, exact
   launch counts and the kernels' prefill logits against the plain
   forward; then in bfloat16 at full depth (Qwen2.5-32B at 32 of its 64
   layers, so that the source and its merge fit together) exact launch
   counts on the three caches and the scheduler (``n_layers`` decode
   launches per decode step, G 16 included), tok/s and TTFT;
9. the two MoE configs (``moe_path``): Phi-3.5-MoE (GQA 32/8, 16 experts
   top-2) and Moonshot-v1-16B-A3B (MHA 16/16, 64 experts top-6, vocab
   163,840) at full width, the same prompts: at 4 calibrated layers in
   float32 at the no-drop capacity (``capacity_factor = n_experts``)
   merged == source, paged == dense and scheduled == synchronous streams,
   exact launch counts and the kernels' prefill logits against the plain
   forward; at the configs' capacity 1.25 merged == source, the merge's
   removed weights == ``weight_table``'s, the pairs dropped per prefill
   and the scheduled (dropless chunks) agreement printed; then bf16 at
   ``MOE_DEPTH`` layers (Phi 6 of 32, Moonshot 12 of 48: the source and
   its merge fit together, and the script keeps its time margin) exact
   launch counts on the three caches and
   the scheduler, tok/s, TTFT, peak memory, and a decode profile with the
   MoE blocks' share of the device time beside ``decode_speedup``;
10. the VLM (``vlm_path``): Llama-3.2-Vision-11B at full width, skipless
   and its qp merge, the four prompts each with a seeded (1600, 4096)
   vision array, the dense cache: at 10 calibrated float32 layers (two
   groups; 5 if merged != source there, the mismatch printed) merged ==
   source, exact launch counts, kernels vs plain prefill logits, and the
   refusals of ``ScheduledEngine`` and the paged pool; then bf16 at all
   40 layers, exact launch counts (per prefill 40 generic flash launches,
   8 non-causal; per decode step 32 merged + 8 generic decode launches,
   or 40 generic for the source), merged tok/s, TTFT, decode profiles of
   both, peak memory;
11. the audio encoder (``audio_path``): HuBERT-XLarge at full width, at 4
   calibrated float32 layers its qp, kp and vp merges and the kernels
   against the source's plain forward (``AUDIO_TOL`` of the logit scale),
   then bf16 at 48 layers on B 4 x 1000 frames: 48 flash launches per
   forward (non-causal, D 80) and profiles of the source's and the
   merge's forward;
12. training (``train_path``; the train step runs the plain PyTorch
   forward and its autograd backward, none of the kernels): (a)
   Llama-3.2-1B whole (16 layers, full width) in the Q/P-free
   ``residual_qpfree`` style, bf16 compute over float32 params, AdamW,
   remat, B 8 x S 1024, 30 ``Trainer`` steps: the loss falls by more
   than 0.02; step time, tokens/s, model FLOPs share, peak memory, the
   final checkpoint's size and write time, and a profiled step with
   remat True, False and "dots" (B 4 where B 8 does not fit); (b) a
   skipless Mistral-7B at full width and 4 calibrated float32 layers
   trained 20 steps, saved and restored bit for bit through
   ``training.checkpoint``, merged and served with its source through the
   kernels: identical greedy streams and exact launch counts (else the
   first mismatch, the per-block RMS, and 2 layers); (c) one train step
   of every arch at ``reduce_config`` in every style it admits (and
   ``grad_accum=2``) on the card against the CPU;
13. the mesh phase: a (1, 1) mesh over NCCL (``mesh_path``);
14. the obs phase (``obs_path``, after every timed phase: it turns on
   PyTorch's GPU trace hooks to count host syncs): merged bf16 Mistral-7B at 8 layers on the
   paged pool, roomy and tight, through ``Engine`` and
   ``ScheduledEngine`` with ``ServeConfig(obs=True)``: one terminal event
   per request, a valid Perfetto export, histograms counting the
   requests, pool gauges equal to the allocator's counters, and the
   streams, launch counts and host syncs of the obs-off run; obs-on and
   obs-off tok/s side by side;
15. the model-axis phase: a model axis of 2 in two processes over gloo
   (``model_axis_path``: the kernel route's split-K decode and head-split
   prefill, streams and per-rank launches against the unmeshed engine),
   and meanwhile, in this process, the lint phase (``lint_path``, after
   the obs phase, whose trace hooks
   it reuses): ``python -m repro_torch.lint --device cuda`` (the sweep of
   the 36 registered combos, the "cuda" ones traced on the card through
   the kernels, and the aliasing, submit-path and retention audits on
   CUDA engines) and the registered builders on full-width Mistral-7B
   cut to 2 layers (18 kernel targets), all CLEAN, each kernel target
   one kernel node and one launch per attention layer; a paged and an
   int8 paged decode step make no host sync;
16. prints one JSON line of per-kernel numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Everything printed to stdout is also written to ``build/chip_smoke.log``
beside the script (``build/`` is gitignored), since a remote run may
return only the end of the output.

Any failure raises (non-zero exit, no result lines).  Without a CUDA card,
or without the repository's ``src/`` beside it, the script exits non-zero
before printing anything else.
"""
from __future__ import annotations

import contextlib
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
Hq, Hkv, D = MISTRAL_ATTN = (32, 8, 128)  # Mistral-7B's attention shape
HYMBA_ATTN = (25, 5, 64)  # Hymba-1.5B's (Hq, Hkv, D)
CHATGLM_ATTN = (32, 2, 128)  # ChatGLM3-6B's: 16 query heads per kv head
G12_ATTN = (24, 2, 128)  # G 12: the second part of the group not full
SSD_TOL_REL = 3e-5  # SSD rows: max |err| <= this x the plain version's max
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
    "decode_attention_paged_bhsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:263"),
    "decode_attention_paged_merged_bsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:336"),
    "flash_attention_merged_q8_bsd": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:271"),
    "decode_attention_paged_q8_bhsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:432"),
    "decode_attention_paged_q8_merged_bsd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:510"),
    "ssd_chunk_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:73"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Tee:
    """A stdout that also writes every line to an open file."""

    def __init__(self, stream, file):
        self.stream, self.file = stream, file

    def write(self, s: str) -> None:
        self.stream.write(s)
        self.file.write(s)

    def flush(self) -> None:
        self.stream.flush()
        self.file.flush()


def cuda_ms(fn, n_sets: int, iters: int = 30, runs: int = 3):
    """Device time of one call of ``fn(i)``, cycling through ``n_sets``
    input sets (enough that the L2 cache is cold for each call, as it is
    for the real caller): ``iters`` calls are captured in one CUDA graph
    and the replay is timed with CUDA events, ``runs`` times.  A replay
    runs only the captured kernels, so the host work of the calls (Python
    checks, allocation, the ctypes launch) cannot land between them in
    the timed interval.  Returns (median ms per call, the runs' ms)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for i in range(3):
            fn(i % n_sets)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_sets)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(times)[len(times) // 2], times


def eager_ms(fn, n_sets: int, iters: int = 30) -> float:
    """The timer used before ``cuda_ms``: CUDA events around ``iters``
    eager calls, so host gaps between launches count.  Printed beside the
    graph time to show how much of a row's time was the host."""
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


def device_kernels_per_call(fn, calls: int = 3) -> float:
    """Device kernels ``torch.profiler`` records per call of ``fn(0)``,
    over ``calls`` calls after a warm-up call.  A profile that recorded
    fewer kernels than kernel-launch API calls lost a record (it happens
    now and then after earlier profiles and CUDA graphs in the process)
    and is taken again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(0)
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sum(e.count for e in events
                      if e.device_type == DeviceType.CUDA)
        api = sum(e.count for e in events if e.device_type == DeviceType.CPU
                  and "LaunchKernel" in e.key)
        if kernels >= api:
            break
    return kernels / calls


def kernel_row(name, dtype, case, kern, plain, library, n_sets, bound,
               timed, tol_fn=None) -> dict:
    """One kernel-phase row: the kernel against its plain version on input
    set 0 (raises beyond ``tolerance``, or ``tol_fn(want, dtype)``; a
    kernel with several outputs returns a tuple, each held to its own
    tolerance), then the kernel, plain and library times (``library``
    None: no single PyTorch call computes the function)."""
    import torch
    got, want = kern(0), plain(0)
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    err, tol = 0.0, 0.0
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max())
        t = (tol_fn or tolerance)(w, dtype)
        if not e <= t:
            raise AssertionError(f"{name} {dtype} {case}: max abs err {e} > "
                                 f"{t}")
        err, tol = max(err, e), max(tol, t)
    ms, runs = cuda_ms(kern, n_sets)
    return dict(name=name, dtype=str(dtype), case=case, max_abs_err=err,
                tol=tol, **bound, ms=ms, ms_runs=runs,
                eager_ms=eager_ms(kern, n_sets),
                plain_ms=cuda_ms(plain, n_sets)[0],
                library_ms=None if library is None
                else cuda_ms(library, n_sets)[0], timed=timed)


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

def decode_phase(rng, rows, hymba=False, attn=None):
    """Rows 4 and 5 at Mistral-7B's attention shape; with ``hymba`` row 4
    (the hybrid's decode kernel) at Hymba-1.5B's (Hq 25, Hkv 5, D 64);
    with ``attn`` (Hq, Hkv, D) rows 4 and 5 at that shape (ChatGLM3-6B's
    G 16, or G 12); the last two untimed in the JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk, ref

    Hq, Hkv, D = attn or (HYMBA_ATTN if hymba else MISTRAL_ATTN)
    B, S = 4, 512
    G = Hq // Hkv
    dev = torch.device("cuda")
    cases = [("window 64, empty slots", 64, [40, 300, 511, 1000], 0.1),
             ("no window, full ring", 0, [511, 600, 777, 1000], 0.0)]
    names = ("decode_attention_bhsd",) if hymba else \
        ("decode_attention_merged_bsd", "decode_attention_bhsd")
    geom = f" Hq={Hq} Hkv={Hkv} D={D}" if hymba or attn else ""
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

            for name in names:
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
                rows.append(kernel_row(
                    name, dtype, f"B={B} S={S} {label}{geom}", kern, plain,
                    sdpa, n_sets, bound, timed=(
                        label.startswith("no window") and not geom
                        and dtype == torch.bfloat16)))
            del us, ks, vs, khs, vhs


def decode_occupancy(card):
    """Residency of each instantiation of the decode kernel (query dtype,
    head dim, cache kind) for clusters of 8 splits, one tile a split (one
    ring stage, Mistral's B=4 S=512 plan) and several (two stages):
    blocks per SM and clusters resident at once, as the CUDA occupancy
    calls give them.  Mistral's 256 blocks at B=4 (32 clusters) must fit
    at once, with one ring stage (S=512) or two (longer caches)."""
    import torch
    from repro_torch.kernels import decode_attention as dk

    log(f"decode kernel occupancy ({card}; clusters of {dk.MAX_SPLIT} "
        f"blocks of 128 threads):")
    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 128):
            for kind in ("dense", "paged", "paged_q8"):
                cells = []
                for chunk in (64, 512):
                    bps, clusters, smem = dk.occupancy(
                        dtype, D, kind, dk.MAX_SPLIT, chunk)
                    cells.append(f"chunk {chunk}: {bps} blocks/SM, "
                                 f"{clusters} clusters at once, "
                                 f"{smem} B dynamic shared memory")
                    if clusters * dk.MAX_SPLIT < 256:
                        raise AssertionError(
                            f"decode {dtype} D={D} {kind} chunk {chunk}: "
                            f"{clusters} resident clusters cannot hold "
                            f"B=4 x Hkv=8 x 8 splits at once")
                log(f"  {str(dtype)[6:]:8s} D={D:3d} {kind:8s} "
                    + "; ".join(cells))


def decode_kernels_per_call(rng, attn=None) -> dict:
    """Device kernels per call of each of the six decode wrappers, counted
    by ``torch.profiler`` (``device_kernels_per_call``) before any other
    kernel row runs, on bf16 inputs of the main path's shapes: Mistral's
    (or ``attn``'s (Hq, Hkv, D)) dense cache at B=4, S=512 full, and its
    pools behind the absolute table of ``paged_tables``.  Keyed by wrapper
    name."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk, quant

    Hq, Hkv, D = attn or MISTRAL_ATTN
    dev = torch.device("cuda")
    B, S, G = 4, 512, Hq // Hkv

    def rand(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev, dt)

    u = rand(B, Hq, D)
    k, v = rand(B, S, Hkv, D), rand(B, S, Hkv, D)
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    q_pos = [511, 600, 777, 1000]
    kvp = torch.from_numpy(ring_positions(rng, S, q_pos, 0.0)).to(dev)
    qp = torch.tensor(q_pos, dtype=torch.int32, device=dev)
    _, _, bt_np, qp_np = paged_tables()[0]
    bt = torch.from_numpy(bt_np).to(dev)
    pqp = torch.from_numpy(qp_np).to(dev)
    kp, vp = rand(NB_POOL, PAGE, Hkv, D), rand(NB_POOL, PAGE, Hkv, D)
    (k8, ks), (v8, vs) = (quant.q8_quantize_pages(p.float()) for p in (kp, vp))
    ug = u.reshape(B, Hkv, G, D)
    calls = {
        "decode_attention_merged_bsd": (u, k, v, kvp, qp),
        "decode_attention_bhsd": (ug, kh, vh, kvp, qp),
        "decode_attention_paged_merged_bsd": (u, kp, vp, bt, pqp),
        "decode_attention_paged_bhsd": (ug, kp, vp, bt, pqp),
        "decode_attention_paged_q8_merged_bsd": (u, k8, v8, ks, vs, bt, pqp),
        "decode_attention_paged_q8_bhsd": (ug, k8, v8, ks, vs, bt, pqp)}
    out = {name: device_kernels_per_call(
        lambda i, f=getattr(dk, name), args=args: f(*args))
        for name, args in calls.items()}
    log(f"device kernels per decode wrapper call (torch.profiler, 3 calls, "
        f"bf16, Hq {Hq} Hkv {Hkv} D {D}): "
        + ", ".join(f"{n} {c:g}" for n, c in out.items()))
    return out


def flash_cases(hymba=False):
    """The flash rows' (dtype, S, window, kernels): the main path's
    prompt lengths (16-512) in both dtypes, then long prompts in bf16
    (Mistral: 2048 and 4096 causal and 2048 with window 512; Hymba: 2048
    with its window of 1024) and one float32 row at 2048."""
    import torch
    bf16, f32 = torch.bfloat16, torch.float32
    names = ("flash_attention_bhsd",) if hymba else \
        ("flash_attention_merged_bsd", "flash_attention_bhsd")
    cases = [(dtype, S, window, names) for dtype in (bf16, f32)
             for S in (16, 37, 250, 512)
             for window in ((0,) if hymba else (0, 64))]
    if hymba:
        return cases + [(bf16, 2048, 1024, names)]
    return cases + [(bf16, 2048, 0, names), (bf16, 4096, 0, names),
                    (bf16, 2048, 512, names),
                    (f32, 2048, 0, ("flash_attention_merged_bsd",))]


def flash_phase(rng, rows, hymba=False, cases=None):
    """Rows 1 and 2 at Mistral-7B's attention shape; with ``hymba`` row 1
    (the hybrid's prefill kernel) at Hymba-1.5B's (Hq 25, Hkv 5, D 64;
    its window of 1024 exceeds the prompts up to 512, so those rows take
    window 0), untimed in the JSON line; ``cases`` (default
    ``flash_cases(hymba)``) picks the rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk, ref

    Hq, Hkv, D = HYMBA_ATTN if hymba else MISTRAL_ATTN
    B = 1
    dev = torch.device("cuda")
    geom = f" Hq={Hq} Hkv={Hkv} D={D}" if hymba else ""
    for dtype, S, window, names in cases or flash_cases(hymba):
        el = torch.tensor([], dtype=dtype).element_size()
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
                    qh[i], kh[i], vh[i], attn_mask=ok, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qh[i], kh[i], vh[i], is_causal=True, enable_gqa=True)

        for name in names:
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
            rows.append(kernel_row(
                name, dtype, f"B={B} Sq=Sk={S} causal window={window}{geom}",
                kern, plain, sdpa, n_sets, bound,
                timed=(S == 250 and window == 0 and not hymba
                       and dtype == torch.bfloat16)))
        del us, ks, vs, qh, kh, vh, ok
        torch.cuda.empty_cache()


PAGE, NB_POOL = 16, 128  # paged kernel rows: page size, pages in the pool
FILLS = (16, 37, 100, 250 + 15)  # tokens in each slot of the absolute table
RING_WINDOW, RING_QPOS = 64, (37, 130, 351, 1000)  # the ring table's rows


def paged_tables():
    """The paged kernel rows' tables, on pages drawn from a seeded
    permutation of the pool (so the gather is not contiguous):

    * absolute: max_len 512 (MB = 32), slots filled to ``FILLS`` tokens
      (q_position = fill - 1), -1 beyond; slot 1's first block is slot 0's
      page (a shared page);
    * ring: window 64 (MB = R = 5 slots), q_positions ``RING_QPOS``: row 0
      has not wrapped (slots of blocks < 0 are -1), the others have, the
      last past 4 * R * bs; row 3's slot of its oldest block is -1 (a hole).
    Returns [(label, window, table, q_position)] as numpy int32."""
    import numpy as np
    from repro_torch.kernels.paging import paged_ring_blocks

    rng = np.random.default_rng(13)
    perm = iter(rng.permutation(NB_POOL).tolist())
    mb = 512 // PAGE
    absolute = np.full((len(FILLS), mb), -1, np.int32)
    for b, n in enumerate(FILLS):
        for j in range(-(-n // PAGE)):
            absolute[b, j] = next(perm)
    absolute[1, 0] = absolute[0, 0]
    R = paged_ring_blocks(RING_WINDOW, PAGE)
    ring = np.full((len(RING_QPOS), R), -1, np.int32)
    for b, qp in enumerate(RING_QPOS):
        lb = qp // PAGE
        for j in range(R):
            if lb - (lb + R - j) % R >= 0:
                ring[b, j] = next(perm)
    ring[3, (RING_QPOS[3] // PAGE + 1) % R] = -1
    return [("absolute MB=32, shared page", 0, absolute,
             np.asarray(FILLS, np.int32) - 1),
            (f"ring R={R} window {RING_WINDOW}, wrapped", RING_WINDOW, ring,
             np.asarray(RING_QPOS, np.int32))]


def paged_phase(rng, rows, q8, attn=None):
    """Rows 6 and 7 (``q8`` False) or 8 and 9 (``q8`` True): the paged
    decode kernels on ``paged_tables``, over float pools or over int8
    pools quantized from seeded float pages whose unmapped pages' scale
    rows are NaN in the kernels' inputs (the plain versions get the clean
    scales: a kernel that read such a scale would disagree).  At
    Mistral-7B's attention shape, or at ``attn`` (Hq, Hkv, D), untimed in
    the JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk, quant, ref
    from repro_torch.kernels.paging import paged_ring_active

    Hq, Hkv, D = attn or MISTRAL_ATTN
    geom = f" Hq={Hq} Hkv={Hkv} D={D}" if attn else ""
    G = Hq // Hkv
    dev = torch.device("cuda")
    kind = "paged_q8" if q8 else "paged"
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()
        kv_el = 1 if q8 else el
        for label, window, bt_np, qp_np in paged_tables():
            B, MB = bt_np.shape
            bt = torch.from_numpy(bt_np).to(dev)
            qp = torch.from_numpy(qp_np).to(dev)
            ring = paged_ring_active(window, PAGE, MB)
            kvp = ref.ref_paged_positions(bt, PAGE, qp, ring)
            ok = (kvp >= 0) & (kvp <= qp[:, None])
            if window:
                ok &= qp[:, None] - kvp < window
            n_att = int(ok.sum())
            n_sets = n_sets_for(2 * NB_POOL * PAGE * Hkv * D * kv_el)
            unmapped = torch.ones(NB_POOL, dtype=torch.bool, device=dev)
            unmapped[bt[bt >= 0].long()] = False

            def rand(*shape, dt=dtype):
                return torch.from_numpy(rng.standard_normal(
                    shape, np.float32)).to(dev, dt)

            def pool():
                """(pool the kernel reads, as the plain version reads it,
                as dense rows of ``dtype`` for the yardstick)"""
                if not q8:
                    p = rand(NB_POOL, PAGE, Hkv, D)
                    return (p,), (p,), p
                ints, sc = quant.q8_quantize_pages(
                    rand(NB_POOL, PAGE, Hkv, D, dt=torch.float32))
                nan = torch.where(unmapped[:, None], float("nan"), sc)
                return ((ints, nan), (ints, sc),
                        ref.ref_q8_dequant_pool(ints, sc).to(dtype))

            us = [rand(B, Hq, D) for _ in range(n_sets)]
            kps = [pool() for _ in range(n_sets)]
            vps = [pool() for _ in range(n_sets)]
            # the yardstick's dense K/V, gathered (and dequantized) here,
            # outside its timing
            khs, vhs = ([ref.ref_paged_gather(p[2], bt).transpose(1, 2)
                         .contiguous() for p in pools] for pools in (kps, vps))
            # each pool row some slot attends to is read once, though two
            # slots may map its page (the shared page); int8 rows are one
            # byte each, plus both scales of every (page, kv head) with an
            # attendable row
            row = (bt.long().repeat_interleave(PAGE, dim=1) * PAGE
                   + torch.arange(MB * PAGE, device=dev) % PAGE)[ok].unique()
            n_rows = int(row.numel())
            n_pages = int((row // PAGE).unique().numel()) if q8 else 0
            nbytes = (2 * n_rows * Hkv * D * kv_el + 2 * n_pages * Hkv * 4
                      + 2 * B * Hq * D * el + B * MB * 4 + B * 4)
            bound = bound_ms(nbytes, 4 * D * Hq * n_att, dtype)
            mask = ok[:, None, None, :]

            def sdpa(i):
                return F.scaled_dot_product_attention(
                    us[i].reshape(B, Hq, 1, D), khs[i], vhs[i],
                    attn_mask=mask, enable_gqa=True)

            def args(i, which):  # which 0: the kernel's, 1: the plain's
                k, v = kps[i][which], vps[i][which]
                return (k[0], v[0], *k[1:], *v[1:], bt, qp)

            kw = dict(sliding_window=window, ring_blocks=ring)
            infix = "_q8" if q8 else ""
            for merged in (True, False):
                name = f"decode_attention_paged{infix}_" + \
                    ("merged_bsd" if merged else "bhsd")
                fn = getattr(dk, name)
                oracle = getattr(ref, f"ref_decode_attention_paged{infix}"
                                 + ("_merged" if merged else ""))

                def query(i, merged=merged):
                    return us[i] if merged else us[i].reshape(B, Hkv, G, D)

                def kern(i, fn=fn, query=query):
                    return fn(query(i), *args(i, 0), **kw).reshape(B, Hq, D)

                def plain(i, oracle=oracle, query=query):
                    return oracle(query(i), *args(i, 1),
                                  **kw).reshape(B, Hq, D)

                rows.append(kernel_row(
                    name, dtype, f"B={B} bs={PAGE} {kind} {label}{geom}",
                    kern, plain, sdpa, n_sets, bound,
                    timed=(window == 0 and dtype == torch.bfloat16
                           and not attn)))
            del us, kps, vps, khs, vhs


MODEL_AXES = (2, 4)  # model axes whose split-K the partial-state mode serves
SPLIT_QPOS = (40, 300, 777, 1000)  # the split phase's dense rows; row 3 idle


def model_boxes(n, m):
    """(offset, size) of each rank's shard of a dim of ``n`` split over a
    model axis of ``m``, as ``distribution.placed.shard_box`` gives it for
    a DTensor's ``Shard``: ceil(n / m) per rank, the last ones shorter
    (or empty) where m does not divide n."""
    size = -(-n // m)
    return [(min(r * size, n), max(0, min(size, n - r * size)))
            for r in range(m)]


def split_k_phase(rng, out, attn=None):
    """The decode kernel's partial-state mode (rows 4-9) at the path
    phase's shapes: Mistral-7B's attention (or ``attn``: ChatGLM3-6B's
    G 16), B 4, bfloat16 and float32, the dense cache of 512 slots (no
    window; window 64) with row 0 early (its keys in the first box) and
    row 3 idle (every position -1), and ``paged_tables``' absolute and
    ring tables with row 3's table made all -1 (idle).  For model axes 2
    and 4 the cache (its sequence) or the pool (its pages, with their
    int8 scale rows) is cut into ``model_boxes``; each box runs the
    partial-state kernel (a box's table: the global table's width with
    other boxes' pages -1, ``placed.own_pages``).  Each box's (m, l, o)
    must equal the plain version's on the same box (5e-5 of the largest,
    or absolute), and the states, stacked and combined
    (``placed.combine_softmax``), the whole kernel's output within
    ``tolerance``, the idle row exactly 0.  At Mistral's shape, no window
    and the absolute table, the box with the most attended keys is timed
    (``cuda_ms``) beside the whole kernel, with its bound: its attended
    K/V rows, the query, the positions or table and the three float32
    state outputs over 3.35 TB/s.  Appends one record per (row, dtype,
    case, axis) to ``out``."""
    import numpy as np
    import torch
    from repro_torch.distribution.placed import combine_softmax, own_pages
    from repro_torch.kernels import decode_attention as dk, quant, ref
    from repro_torch.kernels.paging import paged_ring_active

    Hq, Hkv, D = attn or MISTRAL_ATTN
    G, B, S = Hq // Hkv, 4, 512
    dev = torch.device("cuda")
    geom = f" Hq={Hq} Hkv={Hkv} D={D}" if attn else ""
    plain_of = {"decode_attention_bhsd": ref.ref_decode_states,
                "decode_attention_merged_bsd": ref.ref_decode_states_merged,
                "decode_attention_paged_bhsd": ref.ref_decode_states_paged,
                "decode_attention_paged_merged_bsd":
                    ref.ref_decode_states_paged_merged,
                "decode_attention_paged_q8_bhsd":
                    ref.ref_decode_states_paged_q8,
                "decode_attention_paged_q8_merged_bsd":
                    ref.ref_decode_states_paged_q8_merged}

    def rand(*shape, dt):
        return torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev, dt)

    def check(name, dtype, case, q, whole_args, box_args, n_att, kw, el,
              timed):
        """``box_args(lo, n)``: the kernel's operands over box [lo, lo+n)
        and its attended keys; ``whole_args``: the whole kernel's."""
        whole = getattr(dk, name)(q, *whole_args, **kw)
        for m in MODEL_AXES:
            boxes = model_boxes(n_att[1], m)
            states, n_keys = [], []
            for lo, n in boxes:
                args, keys = box_args(lo, n)
                got = dk.decode_states(name, q, *args, **kw)
                want = plain_of[name](q, *args, **kw)
                for a, b in zip(got, want):
                    tol = 5e-5 * max(1.0, float(b.abs().max()))
                    err = float((a - b).abs().max())
                    if not err <= tol:
                        raise AssertionError(
                            f"{name} {dtype} {case} axis {m} box {lo}: "
                            f"states err {err} > {tol}")
                states.append(got)
                n_keys.append(keys)
            comb = combine_softmax(*(torch.stack(x) for x in zip(*states)))
            comb = comb.to(dtype).reshape(whole.shape)
            err = float((comb.float() - whole.float()).abs().max())
            tol = tolerance(whole, dtype)
            if not err <= tol or not torch.equal(
                    comb[3], torch.zeros_like(comb[3])):
                raise AssertionError(f"{name} {dtype} {case} axis {m}: "
                                     f"combined err {err} > {tol} or the "
                                     "idle row is not 0")
            rec = dict(name=name, dtype=str(dtype), case=case, axis=m,
                       max_abs_err=err, tol=tol,
                       empty_boxes=sum(k == 0 for k in n_keys))
            if timed:
                r = int(np.argmax(n_keys))
                args, keys = box_args(*boxes[r])
                nbytes = (2 * keys * Hkv * D * el + q.numel() *
                          q.element_size() + 2 * B * Hq * 4 + B * Hq * D * 4
                          + n_att[2](boxes[r][1]))
                bound = bound_ms(nbytes, 4 * D * Hq * keys, dtype)
                rec.update(
                    box=r, box_keys=keys, whole_keys=n_att[0],
                    ms=cuda_ms(lambda i: dk.decode_states(name, q, *args,
                                                          **kw), 1)[0],
                    whole_ms=cuda_ms(lambda i: getattr(dk, name)(
                        q, *whole_args, **kw), 1)[0], **bound)
            out.append(rec)

    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()
        u = rand(B, Hq, D, dt=dtype)
        for window in (0, 64):
            case = f"dense S={S} " + (f"window {window}" if window
                                      else "no window") + geom
            pos = ring_positions(rng, S, SPLIT_QPOS, 0.0)
            pos[3] = -1
            kvp = torch.from_numpy(pos).to(dev)
            qp = torch.tensor(SPLIT_QPOS, dtype=torch.int32, device=dev)
            ok = (kvp >= 0) & (kvp <= qp[:, None])
            if window:
                ok &= qp[:, None] - kvp < window
            k, v = rand(B, S, Hkv, D, dt=dtype), rand(B, S, Hkv, D, dt=dtype)
            kh, vh = (x.transpose(1, 2).contiguous() for x in (k, v))
            kw = dict(sliding_window=window)
            for name in ("decode_attention_bhsd",
                         "decode_attention_merged_bsd"):
                merged = name.endswith("merged_bsd")

                def box_args(lo, n, merged=merged):
                    sl = slice(lo, lo + n)
                    kv = (k[:, sl].contiguous(), v[:, sl].contiguous()) \
                        if merged else (kh[:, :, sl].contiguous(),
                                        vh[:, :, sl].contiguous())
                    return (*kv, kvp[:, sl].contiguous(), qp), \
                        int(ok[:, sl].sum())

                q = u if merged else u.reshape(B, Hkv, G, D)
                whole = (k, v, kvp, qp) if merged else (kh, vh, kvp, qp)
                check(name, dtype, case, q, whole, box_args,
                      (int(ok.sum()), S, lambda n: B * n * 4 + B * 4), kw,
                      el, timed=not attn and not window)
        for q8 in (False, True):
            kind = "paged_q8" if q8 else "paged"
            kv_el = 1 if q8 else el
            for label, window, bt_np, qp_np in paged_tables():
                bt_np = bt_np.copy()
                bt_np[3] = -1
                MB = bt_np.shape[1]
                bt = torch.from_numpy(bt_np).to(dev)
                qp = torch.from_numpy(qp_np).to(dev)
                ring = paged_ring_active(window, PAGE, MB)
                kvp = ref.ref_paged_positions(bt, PAGE, qp, ring)
                ok = (kvp >= 0) & (kvp <= qp[:, None])
                if window:
                    ok &= qp[:, None] - kvp < window
                page_of = bt.long().repeat_interleave(PAGE, dim=1)
                if q8:
                    pools = [quant.q8_quantize_pages(rand(
                        NB_POOL, PAGE, Hkv, D, dt=torch.float32))
                        for _ in range(2)]
                    pools = (pools[0][0], pools[1][0], pools[0][1],
                             pools[1][1])
                else:
                    pools = tuple(rand(NB_POOL, PAGE, Hkv, D, dt=dtype)
                                  for _ in range(2))
                kw = dict(sliding_window=window, ring_blocks=ring)
                case = f"bs={PAGE} {kind} {label}{geom}"
                for merged in (True, False):
                    name = f"decode_attention_{kind}_" + \
                        ("merged_bsd" if merged else "bhsd")

                    def box_args(lo, n):
                        held = (page_of >= lo) & (page_of < lo + n)
                        return (*(p[lo:lo + n] for p in pools),
                                own_pages(bt, lo, n), qp), \
                            int((ok & held).sum())

                    q = u if merged else u.reshape(B, Hkv, G, D)
                    # the table and positions, and on the int8 pool
                    # both scales of every (page, kv head) of the box
                    check(name, dtype, case, q, (*pools, bt, qp), box_args,
                          (int(ok.sum()), NB_POOL,
                           lambda n: B * MB * 4 + B * 4
                           + (2 * n * Hkv * 4 if q8 else 0)), kw, kv_el,
                          timed=not attn and not window)


SHIELD_QPOS = (15, 64, 300, 511)  # row 1: a slot shielded at frontier 64


def shielded_phase(rng):
    """Rows 6-9 with one batch row SHIELDED, as the scheduler ships a slot
    mid-chunked-prefill: its table row all -1 and its length at its chunk
    frontier (> 0).  That row must be exactly zero (the unmapped pages'
    K/V rows and q8 scales are NaN in the kernels' inputs, so a kernel
    that read one would return NaN) and the others must equal the plain
    versions within ``tolerance``.  These launches compare and are not
    counted.  Returns the rows checked."""
    import numpy as np
    import torch
    from repro_torch.kernels import decode_attention as dk, quant, ref

    dev = torch.device("cuda")
    G = Hq // Hkv
    B, MB = len(SHIELD_QPOS), 512 // PAGE
    qp = torch.tensor(SHIELD_QPOS, dtype=torch.int32, device=dev)
    perm = iter(np.random.default_rng(29).permutation(NB_POOL).tolist())
    bt_np = np.full((B, MB), -1, np.int32)
    for b, q in enumerate(SHIELD_QPOS):
        if b != 1:
            for j in range(q // PAGE + 1):
                bt_np[b, j] = next(perm)
    bt = torch.from_numpy(bt_np).to(dev)
    mapped = torch.zeros(NB_POOL, dtype=torch.bool, device=dev)
    mapped[bt[bt >= 0].long()] = True
    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        def rand(*shape, dt=dtype):
            return torch.from_numpy(rng.standard_normal(
                shape, np.float32)).to(dev, dt)
        u = rand(B, Hq, D)
        for q8 in (False, True):
            if q8:
                pools = [quant.q8_quantize_pages(rand(NB_POOL, PAGE, Hkv, D,
                                                      dt=torch.float32))
                         for _ in range(2)]
                clean = [(i, s) for i, s in pools]
                bad = [(i, torch.where(mapped[:, None], s, float("nan")))
                       for i, s in pools]
                kernel_kv = (bad[0][0], bad[1][0], bad[0][1], bad[1][1])
                plain_kv = (clean[0][0], clean[1][0], clean[0][1],
                            clean[1][1])
            else:
                kv = [rand(NB_POOL, PAGE, Hkv, D) for _ in range(2)]
                nan = [torch.where(mapped[:, None, None, None], x,
                                   float("nan")).to(dtype) for x in kv]
                kernel_kv, plain_kv = tuple(nan), tuple(kv)
            infix = "_q8" if q8 else ""
            for merged in (True, False):
                name = f"decode_attention_paged{infix}_" + \
                    ("merged_bsd" if merged else "bhsd")
                oracle = getattr(ref, f"ref_decode_attention_paged{infix}"
                                 + ("_merged" if merged else ""))
                q = u if merged else u.reshape(B, Hkv, G, D)
                got = getattr(dk, name)(q, *kernel_kv, bt, qp,
                                        ring_blocks=0).reshape(B, Hq, D)
                want = oracle(q, *plain_kv, bt, qp,
                              ring_blocks=0).reshape(B, Hq, D)
                torch.cuda.synchronize()
                rows = [0, 2, 3]
                err = float((got[rows].float() - want[rows].float())
                            .abs().max())
                tol = tolerance(want[rows], dtype)
                zero = torch.equal(got[1], torch.zeros_like(got[1]))
                if not (zero and err <= tol):
                    raise AssertionError(
                        f"{name} {dtype} shielded row: exactly zero {zero}, "
                        f"other rows max abs err {err} (tol {tol})")
                checked.append(f"{name} {str(dtype)[6:]}: err {err:.2e}")
    log(f"shielded-row check (rows 6-9, B={B}, row 1 table all -1 at "
        f"length {SHIELD_QPOS[1]}, unmapped K/V and scales NaN): the "
        f"shielded row exactly zero, the others within tolerance: "
        f"{'; '.join(checked)}")
    return checked


def quant_check(rng):
    """The int8 quantization is plain torch on every route: on the same
    seeded float32 K/V at Mistral's shape (Hkv 8, D 128, pages of 16) the
    card's ints and scales equal the CPU's — whole pages, a sequence with
    a ``valid`` mask (padding past true_len zeroed before the absmax), and
    decode appends that enter fresh pages, grow scales and keep them."""
    import numpy as np
    import torch
    from repro_torch.kernels import quant

    dev = torch.device("cuda")
    n = 0

    def same(a, b, what):
        nonlocal n
        for x, y in zip(a, b):
            if not torch.equal(x, y.cpu()):
                raise AssertionError(f"quantize {what}: card != CPU")
            n += x.numel()

    def f32(*shape, amp=1.0):
        return torch.from_numpy(rng.standard_normal(shape, np.float32) * amp)

    for amp in (1e-3, 1.0, 300.0):
        x = f32(2, NB_POOL, PAGE, Hkv, D, amp=amp)
        same(quant.q8_quantize_pages(x), quant.q8_quantize_pages(x.to(dev)),
             f"pages x{amp}")
    kv = f32(2, 256, Hkv, D)
    kv[:, 250:] *= 50.0  # loud padding past row 0's true length
    valid = torch.arange(256)[None, :] < torch.tensor([[250], [256]])
    same(quant.q8_quantize_seq(kv, PAGE, valid),
         quant.q8_quantize_seq(kv.to(dev), PAGE, valid.to(dev)), "seq")
    pool = torch.zeros((NB_POOL, PAGE, Hkv, D), dtype=torch.int8)
    scale = torch.zeros((NB_POOL, Hkv))
    gpool, gscale = pool.to(dev), scale.to(dev)
    for t in range(40):  # two rows; row 1 enters a fresh page every 16
        tok = f32(2, Hkv, D, amp=1.0 + (t * 7) % 5)
        page = torch.tensor([3, 10 + t // PAGE])
        off = torch.tensor([t % PAGE, t % PAGE])
        quant.q8_append_token(pool, scale, tok, page, off)
        quant.q8_append_token(gpool, gscale, tok.to(dev), page.to(dev),
                              off.to(dev))
        same((pool, scale), (gpool, gscale), f"append {t}")
    log(f"quantize: card == CPU bit for bit ({n:,d} ints and scales: "
        f"pages, a masked sequence, 40 appends)")


Q8_FLASH_CASES = [(dtype, S, window) for dtype in ("bfloat16", "float32")
                  for S, window in ((16, 0), (256, 0), (512, 0), (256, 64))] \
    + [("bfloat16", 2048, 0)]


def q8_flash_phase(rng, rows, cases=Q8_FLASH_CASES):
    """Row 3: the merged q8 flash kernel over int8 K*/V* quantized from
    seeded floats at the pool's granularity (pages of 16), page-aligned
    prompt lengths, causal, and a window-64 row; a 2048-token bf16 row."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fk, quant, ref

    B = 1
    dev = torch.device("cuda")
    for dtype_name, S, window in cases:
        dtype = getattr(torch, dtype_name)
        el = torch.tensor([], dtype=dtype).element_size()
        nbytes = (B * S * 2 * Hq * D * el + B * S * 2 * Hkv * D
                  + 2 * B * (S // PAGE) * Hkv * 4)  # u, out, k, v, scales
        n_sets = n_sets_for(nbytes)

        def q8_seq():
            return quant.q8_quantize_seq(torch.from_numpy(
                rng.standard_normal((B, S, Hkv, D), np.float32)).to(dev),
                PAGE)

        us = [torch.from_numpy(rng.standard_normal(
            (B, S, Hq, D), np.float32)).to(dev, dtype)
            for _ in range(n_sets)]
        ks = [q8_seq() for _ in range(n_sets)]
        vs = [q8_seq() for _ in range(n_sets)]
        qh = [u.transpose(1, 2).contiguous() for u in us]
        kh, vh = ([quant.q8_dequant_seq(t, sc, dtype).transpose(1, 2)
                   .contiguous() for t, sc in seqs] for seqs in (ks, vs))
        i_ = torch.arange(S, device=dev)
        ok = i_[None, :] <= i_[:, None]
        if window:
            ok &= i_[:, None] - i_[None, :] < window
        bound = bound_ms(nbytes, 4 * D * Hq * B * int(ok.sum()), dtype)

        def sdpa(i):
            if window:
                return F.scaled_dot_product_attention(
                    qh[i], kh[i], vh[i], attn_mask=ok, enable_gqa=True)
            return F.scaled_dot_product_attention(
                qh[i], kh[i], vh[i], is_causal=True, enable_gqa=True)

        def kern(i):
            return fk.flash_attention_merged_q8_bsd(
                us[i], ks[i][0], vs[i][0], ks[i][1], vs[i][1],
                sliding_window=window)

        def plain(i):
            return ref.ref_flash_attention_merged_q8(
                us[i], ks[i][0], vs[i][0], ks[i][1], vs[i][1],
                sliding_window=window)

        rows.append(kernel_row(
            "flash_attention_merged_q8_bsd", dtype,
            f"B={B} Sq=Sk={S} int8 sg={PAGE} causal window={window}",
            kern, plain, sdpa, n_sets, bound,
            timed=(S == 256 and window == 0 and dtype == torch.bfloat16)))
        del us, ks, vs, qh, kh, vh
        torch.cuda.empty_cache()


SSD_CHUNK = 256  # the reference's chunk (both configs' ssm_chunk)
SSD_KERNEL_ROWS = 64  # the CUDA kernel's own chunk (LC in csrc/ssd_scan.cu)
SSD_SHAPES = {"hymba": (50, 64, 16), "mamba2": (80, 64, 128)}  # H, P, N
N_SMS = 132  # an H100 SXM's SMs


def ssd_occupancy():
    """Residency of each SSD instantiation (input dtype, Hymba's and
    Mamba2's P and N) for one-tile spans (512 tokens: 8 spans of 64 rows)
    and multi-tile spans (2048: 8 of 256), as the CUDA occupancy calls
    give them.  The main path's grid is B x H clusters of n_span blocks:
    the clusters resident at once must hold at least one block on every
    SM, so that a whole wave of them fills the card."""
    import torch
    from repro_torch.kernels import ssd_scan as sk

    log("SSD kernel occupancy (clusters of n_span blocks of 256 "
        "threads):")
    for dtype in (torch.bfloat16, torch.float32):
        for label, (H, P, N) in SSD_SHAPES.items():
            cells = []
            for S in (512, 2048):
                bps, clusters, smem, n_span, span = sk.occupancy(
                    dtype, P, N, S)
                cells.append(f"S {S} ({n_span} spans of {span}): {bps} "
                             f"blocks/SM, {clusters} clusters at once, "
                             f"{smem} B dynamic shared memory")
                if clusters * n_span < N_SMS:
                    raise AssertionError(
                        f"ssd {dtype} {label} S={S}: {clusters} resident "
                        f"clusters of {n_span} blocks leave SMs idle")
            log(f"  {str(dtype)[6:]:8s} {label:6s} P={P} N={N:3d} "
                + "; ".join(cells))


def ssd_kernels_per_call(rng) -> float:
    """Device kernels per ``ssd_chunk_scan`` call (``torch.profiler``), on
    bf16 inputs of Mamba2-2.7B's geometry at 512 tokens, B and C broadcast
    from one group as the model passes them."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ssd_scan as sk

    dev = torch.device("cuda")
    H, P, N = SSD_SHAPES["mamba2"]
    S = 512

    def rand(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(
            shape, np.float32)).to(dev, dt)

    dt = F.softplus(rand(1, S, H, dt=torch.float32))
    args = (rand(1, S, H, P), dt,
            -dt * torch.exp(0.5 * rand(H, dt=torch.float32)),
            rand(1, S, 1, N).expand(1, S, H, N),
            rand(1, S, 1, N).expand(1, S, H, N))
    out = device_kernels_per_call(
        lambda i: sk.ssd_chunk_scan(*args, chunk=SSD_CHUNK))
    log(f"device kernels per ssd_chunk_scan call (torch.profiler, 3 calls, "
        f"bf16, Mamba2 S={S}): {out:g}")
    return out


def ssd_tolerance(want, dtype) -> float:
    """SSD rows: the outputs are float32 whatever the input type (both
    sides read the same bf16 values and compute in float32), so one rule:
    3e-5 of the plain version's largest |value|, for float32 sums of up to
    64 N products taken in another order and decay sums over the kernel's
    64-row chunks rather than the reference's 256."""
    return SSD_TOL_REL * float(want.float().abs().max())


def ssd_phase(rng, rows, occupancy=True):
    """Row 10: the SSD kernel's occupancy (``ssd_occupancy``, unless
    ``occupancy`` is False), then the kernel against the plain chunked scan
    (``ref.ref_ssd_chunked``, chunk 256 as the configs set it) at
    Hymba-1.5B's geometry (H 50, P 64, N 16; S 250, 512, 2048) and
    Mamba2-2.7B's (H 80, P 64, N 128; S 256, 512, 2048), batch 1, B and C
    broadcast from one group by a zero head stride as the model passes
    them, dt = softplus(normal) and A = -exp(0.5 normal) as the reference's
    kernel test draws them.  No single PyTorch call computes the scan: the
    library column is empty.  Bound: bytes read once (x, B and C of the one
    group, dt, a) and written once (y, final state), flops of the kernel's
    own 64-row chunks, fewer than the reference's 256 needs (2 l² N +
    2 l² P + 4 l N P per chunk of l rows and head)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssd_scan as sk

    if occupancy:
        ssd_occupancy()
    dev = torch.device("cuda")
    B = 1
    cases = [("hymba", S) for S in (250, 512, 2048)] + \
        [("mamba2", S) for S in (256, 512, 2048)]
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()
        for label, S in cases:
            H, P, N = SSD_SHAPES[label]
            L = SSD_CHUNK if S % SSD_CHUNK == 0 else S
            nbytes = (B * S * H * P * el + 2 * B * S * N * el
                      + 2 * B * S * H * 4 + B * S * H * P * 4 + B * H * P * N * 4)
            flops = B * H * sum(
                2 * l * l * (N + P) + 4 * l * N * P
                for l in (min(SSD_KERNEL_ROWS, S - s0)
                          for s0 in range(0, S, SSD_KERNEL_ROWS)))
            bound = bound_ms(nbytes, flops, dtype)
            n_sets = n_sets_for(nbytes)

            def rand(*shape, dt=dtype):
                return torch.from_numpy(rng.standard_normal(
                    shape, np.float32)).to(dev, dt)

            A = -torch.exp(0.5 * rand(H, dt=torch.float32))
            sets = []
            for _ in range(n_sets):
                dt = F.softplus(rand(B, S, H, dt=torch.float32))
                bm, cm = (rand(B, S, 1, N).expand(B, S, H, N)
                          for _ in range(2))
                sets.append((rand(B, S, H, P), dt, dt * A, bm, cm))

            def kern(i):
                return sk.ssd_chunk_scan(*sets[i], chunk=SSD_CHUNK)

            def plain(i):
                return ref.ref_ssd_chunked(*sets[i], chunk=SSD_CHUNK)

            rows.append(kernel_row(
                "ssd_chunk_scan", dtype,
                f"{label} B={B} S={S} H={H} P={P} N={N} chunk {L}", kern,
                plain, None, n_sets, bound,
                timed=(label == "hymba" and S == 250
                       and dtype == torch.bfloat16),
                tol_fn=ssd_tolerance))
            del sets


# ---------------------------------------------------------------------------
# path phase
# ---------------------------------------------------------------------------

# the scheduled path: continuous batching with chunked prefill
SCHED = dict(token_budget=256, chunk_tokens=64)
# 16-token pages for the path's five requests: admissions defer and decode
# steps preempt, yet no request is left alone without a page (a trace of
# the manager's host logic, which does not depend on the weights)
SCHED_STARVED_PAGES = 28


def serve(cfg, params, prompts, max_new, cache="dense", probe=None,
          max_len=512, sched=False, vision=None, mesh=None, **serve_kw):
    """Serve ``prompts`` (a VLM: with ``vision``, one array per prompt) on
    a fresh 4-slot engine, the synchronous ``Engine`` or with ``sched``
    the ``ScheduledEngine`` (``SCHED``, or ``sched``'s ``SchedConfig``
    fields), on a device ``mesh`` if given;
    ``probe(eng)`` may wrap the engine's manager before the run.  Returns
    (engine, results, the launch counts of exactly this run, wall
    seconds)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)
    import torch

    sc = ServeConfig(n_slots=4, max_len=max_len, **serve_kw)
    kw = dict(impl="cuda", cache=cache, device="cuda", mesh=mesh)
    eng = ScheduledEngine(cfg, params, sc, SchedConfig(
        **(SCHED if sched is True else sched)), **kw) \
        if sched else Engine(cfg, params, sc, **kw)
    if probe is not None:
        probe(eng)
    torch.cuda.synchronize()
    reset_launch_counts()  # counts cover exactly this serve
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new, vision=vision)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return eng, outs, launch_counts(), wall


def check_counts(tag, counts, eng, n_layers, n_prompts, merged):
    """Each prefill (a resume after preemption is one more) launches the
    engine's flash kernel once per layer, each decode step its decode
    kernel once per layer, and no other kernel runs.  On the int8 pool the
    merged prefill runs the q8 flash kernel and the source's the fp one
    (it dequantizes upstream, as the reference routes it).  A stack with
    SSM layers also launches the SSD scan once per layer and prefill (the
    decode step's SSM update is plain torch); an attention-free one
    launches nothing else.  A VLM prefills generic, merged or not, and its
    cross layers decode through the generic decode kernel (the vision K/V
    read in place) beside the self layers' kernel."""
    cfg = eng.cfg
    q8 = eng.kv.kind == "paged_q8"
    vlm = cfg.family == "vlm"
    flash_k = "flash_attention_" + (("merged_q8_bsd" if q8 else "merged_bsd")
                                    if merged and not vlm else "bhsd")
    n_cross = n_layers // cfg.cross_attn_every if vlm else 0
    dec_k = {"dense": "decode_attention_", "paged": "decode_attention_paged_",
             "paged_q8": "decode_attention_paged_q8_"}[eng.kv.kind] \
        + ("merged_bsd" if merged else "bhsd")
    want = {k: 0 for k in KERNELS}
    prefills = n_prompts + eng.stats["n_preempted"]
    if cfg.has_attention:
        want[flash_k] = n_layers * prefills
        want[dec_k] = (n_layers - n_cross) * eng.stats["n_steps"]
        want["decode_attention_bhsd"] += n_cross * eng.stats["n_steps"]
    if cfg.ssm_state:
        want["ssd_chunk_scan"] = n_layers * prefills
    if counts != want:
        raise AssertionError(f"{tag}: launch counts {counts} != {want}")
    log(f"  {tag}: launches { {k: v for k, v in counts.items() if v} } "
        f"({eng.stats['n_steps']} decode steps)")


def streams(outs):
    return [list(o) for o in outs]


def first_mismatch(cfg, params, prompts, a, b, vision=None):
    """(prompt, position, top-2 margin of the source logits there); a VLM
    takes each prompt's ``vision``."""
    import numpy as np
    import torch
    from repro_torch.models import forward_seq
    for i, (x, y) in enumerate(zip(a, b)):
        if list(x) == list(y):
            continue
        j = next(t for t in range(len(x)) if x[t] != y[t])
        toks = np.concatenate([prompts[i], np.asarray(x[:j], np.int64)])
        vis = None if vision is None else torch.as_tensor(
            vision[i], device="cuda")[None]
        with torch.no_grad():
            lg, _, _ = forward_seq(params, cfg, torch.as_tensor(
                toks, device="cuda")[None], vision=vis, impl="cuda")
        top = torch.topk(lg[0, -1, :cfg.vocab_size].float(), 2).values
        return i, j, float(top[0] - top[1])
    return None


EQ_LAYERS = 4  # depth of the float32 merged-vs-source identity check


def build(n_layers, calibrate, arch="mistral-7b", dtype=None, **overrides):
    """A skipless ``arch`` (Mistral-7B, Hymba-1.5B, a dense or an MoE
    config; ``overrides``: more config fields) of ``n_layers`` at full
    width on the card, in float32 (or ``dtype``, for weights and
    activations), and its exact qp merge (on the hybrid: Q removed, P
    kept).  A config with QKV biases gets seeded nonzero biases
    (the merge's affine part then does work).  A parallel block (Pythia)
    has no merge: ``merge_skipless`` must raise, and the merged pair is
    returned as None.

    A random skipless GLU stack maps its signal scale roughly as
    s -> c * s**2, an unstable fixed point: uncalibrated, the signal
    underflows to exactly zero within a few layers (all logits 0).
    ``calibrate`` rescales each layer's w_down (an MoE layer's: every
    expert's) so that its output RMS on a seeded calibration prompt is 1
    (deterministic from the seed, applied before the merge, which is exact
    for any weights).  That keeps other prompts O(1) for a few layers
    only: by 8 layers their scale wanders by orders of magnitude, and by
    32 it overflows.  On a parallel block the attention output projection
    is rescaled with the FFN's, so the sum of the two branches has RMS
    1."""
    import itertools

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import merge_skipless, removed_weight_count
    from repro_torch.models import block_sequence, init_params
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import apply_block_seq, embed_inputs

    cfg = get_config(arch).with_(block_style="skipless", n_layers=n_layers,
                                 **({"dtype": "float32"} if dtype is None
                                    else {"dtype": dtype,
                                          "param_dtype": dtype}),
                                 **overrides)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    if cfg.qkv_bias:
        gen = torch.Generator("cuda").manual_seed(2)
        for name in ("bq", "bk", "bv"):
            b = params["layers"]["attn"][name]
            b.copy_(0.1 * torch.randn(b.shape, generator=gen, device="cuda"))
    crng = np.random.default_rng(1)
    if cfg.causal:
        calib = torch.as_tensor(crng.integers(0, cfg.vocab_size, (1, 64)),
                                device="cuda")
    else:  # an encoder's frames
        calib = torch.as_tensor(crng.standard_normal(
            (1, 64, cfg.d_model), np.float32), device="cuda")
    ctx = {"positions": torch.arange(64, device="cuda")[None],
           "impl": "cuda"}
    if cfg.family == "vlm":
        ctx["vision"] = torch.as_tensor(crng.standard_normal(
            (1, cfg.n_vision_tokens, cfg.d_model), np.float32),
            device="cuda").to(dtype_of(cfg.dtype))
    with torch.no_grad():
        h = embed_inputs(params, cfg, calib)
        for kind, lp, _ in itertools.islice(block_sequence(params, cfg),
                                            n_layers if calibrate else 0):
            out, _, _, _ = apply_block_seq(lp, cfg, h, ctx, kind)
            r = out.pow(2).mean().sqrt()
            ffn = lp["moe" if "moe" in lp else "ffn"]
            ffn["w_down" if "w_down" in ffn else "w_out"].div_(r)
            if cfg.parallel_block:
                lp["attn"]["wp"].div_(r)
            h = out / r
    torch.cuda.synchronize()
    ssm = (f", SSM {cfg.ssm_n_heads}x{cfg.ssm_head_dim}x{cfg.ssm_state}"
           if cfg.ssm_state else "")
    if cfg.n_experts:
        ssm += (f", {cfg.n_experts} experts top-{cfg.experts_per_token}, "
                f"capacity factor {cfg.capacity_factor:g}")
    extra = "".join(f", {k}" for k, on in (
        ("QKV biases", cfg.qkv_bias), ("tied embeddings", cfg.tie_embeddings),
        ("parallel blocks", cfg.parallel_block),
        (f"rope {cfg.rope_style} x{cfg.rope_fraction:g}",
         cfg.rope_style != "half"),
        (f"a cross-attention layer every {cfg.cross_attn_every}, "
         f"{cfg.n_vision_tokens} vision tokens", cfg.cross_attn_every),
        (f"encoder, conv_pos width {cfg.conv_pos_width}", not cfg.causal))
        if on)
    log(f"init {cfg.name} skipless ({n_layers} layers, d_model {cfg.d_model},"
        f" d_ff {cfg.d_ff}, GQA {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.d_head}{ssm}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}{extra}, {cfg.dtype}) on the card"
        f"{', calibrated' if calibrate else ''}: "
        f"{time.perf_counter() - t0:.1f} s")
    if cfg.parallel_block:
        try:
            merge_skipless(params, cfg, "qp")
        except ValueError as e:
            log(f"  merge refused, as in the reference: {e}")
            return cfg, params, None, None
        raise AssertionError(f"{cfg.name}: merge_skipless took a parallel "
                             f"block")
    t0 = time.perf_counter()
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    torch.cuda.synchronize()
    log(f"merge qp (float64, layer by layer, on the card): "
        f"{time.perf_counter() - t0:.1f} s; removed "
        f"{removed_weight_count(params, mparams):,d} weights")
    return cfg, params, mcfg, mparams


def paged_checks(tag, cfg, params, prompts, max_new, want):
    """The paged engine at 4 layers, float32, against the dense engine's
    greedy streams ``want`` on the same model: a dense-sized pool; a pool
    just above the largest request (deferral, preemption, resume; the
    prompts reordered so the longest is admitted beside a short one); a
    repeated prompt (shared pages, copy-on-write).  Returns the events."""
    n = len(prompts)
    merged = cfg.block_style == "skipless_merged"
    eng, out, counts, _ = serve(cfg, params, prompts, max_new, cache="paged")
    check_counts(f"{tag} paged float32", counts, eng, cfg.n_layers, n, merged)
    if streams(out) != streams(want):
        raise AssertionError(f"{tag}: paged streams differ from dense")
    need = max(-(-(len(p) + max_new - 1) // 16) for p in prompts)
    order = [0, 3, 1, 2]  # 16 and 250 tokens fill the pool, 37 waits
    eng, out, counts, _ = serve(cfg, params, [prompts[i] for i in order],
                                max_new, cache="paged", n_blocks=need + 1)
    check_counts(f"{tag} paged float32, {need + 1}-page pool", counts, eng,
                 cfg.n_layers, n, merged)
    ev = {"pool_pages": need + 1, "deferred": eng.stats["n_deferred"],
          "preempted_and_resumed": eng.stats["n_preempted"]}
    same = streams(out) == [list(want[i]) for i in order]
    if not (same and ev["deferred"] and ev["preempted_and_resumed"]):
        raise AssertionError(f"{tag}: small pool {ev}, streams equal {same}")
    rep = [1, 1, 2]
    eng, out, _, _ = serve(cfg, params, [prompts[i] for i in rep], max_new,
                           cache="paged")
    ev.update(shared_pages=eng.pm.allocator.n_shared_hits,
              copy_on_write=eng.pm.allocator.n_cow)
    if streams(out) != [list(want[i]) for i in rep] or \
            not ev["shared_pages"] or not ev["copy_on_write"]:
        raise AssertionError(f"{tag}: repeated prompt {ev}")
    log(f"  {tag}: paged streams == dense streams on a dense-sized pool, a "
        f"{need + 1}-page pool and with a repeated prompt; events {ev}")
    return ev


def window_checks(tag, cfg, params, prompts, max_new):
    """Mistral's window cut from 4096 to 64, so the paged ring (R = 5
    slots of 16) wraps within max_len 512: paged == dense, with at least
    one page recycled in place."""
    wcfg = cfg.with_(sliding_window=64)
    _, dense, _, _ = serve(wcfg, params, prompts, max_new)
    eng, paged, _, _ = serve(wcfg, params, prompts, max_new, cache="paged")
    recycled = eng.pm.allocator.n_recycled
    if streams(paged) != streams(dense) or not eng.pm.ring or not recycled:
        raise AssertionError(f"{tag} window 64: paged == dense "
                             f"{streams(paged) == streams(dense)}, ring "
                             f"{eng.pm.ring}, recycled {recycled}")
    log(f"  {tag}, window cut to 64: paged streams == dense streams (ring of "
        f"{eng.pm.ring} slots, {recycled} pages recycled)")
    return recycled


def agreement(a, b):
    """Per prompt, the tokens two streams share before they first differ."""
    out = []
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        out.append(n)
    return out


def cow_probe(moved):
    """Wraps the manager's copy-on-write: after each copy, record whether
    the destination page's ints AND scale rows equal the source's."""
    import torch

    def probe(eng):
        pm, copy = eng.pm, eng.pm._copy_block_device

        def checked(src, dst):
            copy(src, dst)
            moved.append(all(torch.equal(t[:, dst], t[:, src]) for t in
                             (pm.k, pm.v, pm.k_scale, pm.v_scale)))
        pm._copy_block_device = checked
    return probe


def ring_probe(resets):
    """Wraps the manager so that, for each page recycled into the ring, the
    decode write at its offset 0 is checked to have reset the page's
    scale: some (layer, kv head) scale row must come out SMALLER than the
    stale one, which the monotone merge of a live page never does."""
    def probe(eng):
        pm = eng.pm
        ensure, advance, pending = pm.ensure_appendable, pm.advance, {}

        def ensure_checked(slot):
            rs = (int(pm.lengths[slot]) // pm.bs) % pm.ring
            r0, page = pm.allocator.n_recycled, int(pm.tables[slot, rs])
            ok = ensure(slot)
            if ok and pm.allocator.n_recycled > r0 and \
                    int(pm.tables[slot, rs]) == page:  # recycled in place
                pending[slot] = (page, pm.k_scale[:, page].clone(),
                                 pm.v_scale[:, page].clone())
            return ok

        def advance_checked(slot):
            if slot in pending:  # the step wrote offset 0 of the page
                page, k_old, v_old = pending.pop(slot)
                resets.append(bool((pm.k_scale[:, page] < k_old).any() or
                                   (pm.v_scale[:, page] < v_old).any()))
            advance(slot)
        pm.ensure_appendable, pm.advance = ensure_checked, advance_checked
    return probe


def q8_checks(tag, cfg, params, prompts, max_new, fp_streams):
    """The int8 pool at 4 layers, float32, on one model: the dense-sized
    pool; an 18-page pool (deferral, preemption and resume asserted);
    a repeated prompt (shared pages and a copy-on-write that moved the
    scale rows asserted); the window cut to 64 (a ring recycle whose page
    scale was reset at offset 0 asserted).  Returns (events, streams on
    the dense-sized pool)."""
    n = len(prompts)
    merged = cfg.block_style == "skipless_merged"

    def complete(what, outs, n_req):
        """Every request was served to its last token."""
        lens = [len(o) for o in outs]
        if len(lens) != n_req or any(m != max_new for m in lens):
            raise AssertionError(f"{tag} paged_q8 {what}: stream lengths "
                                 f"{lens}, want {n_req} x {max_new}")

    eng, out, counts, _ = serve(cfg, params, prompts, max_new,
                                cache="paged_q8")
    complete("dense-sized pool", out, n)
    check_counts(f"{tag} paged_q8 float32", counts, eng, cfg.n_layers, n,
                 merged)
    need = max(-(-(len(p) + max_new - 1) // 16) for p in prompts)
    order = [0, 3, 1, 2]
    eng, small, counts, _ = serve(cfg, params, [prompts[i] for i in order],
                                  max_new, cache="paged_q8",
                                  n_blocks=need + 1)
    complete(f"{need + 1}-page pool", small, n)
    check_counts(f"{tag} paged_q8 float32, {need + 1}-page pool", counts,
                 eng, cfg.n_layers, n, merged)
    ev = {"pool_pages": need + 1, "deferred": eng.stats["n_deferred"],
          "preempted_and_resumed": eng.stats["n_preempted"]}
    moved, resets = [], []
    eng, rep, _, _ = serve(cfg, params, [prompts[i] for i in (1, 1, 2)],
                           max_new, cache="paged_q8", probe=cow_probe(moved))
    complete("repeated prompt", rep, 3)
    ev.update(shared_pages=eng.pm.allocator.n_shared_hits,
              copy_on_write=len(moved), cow_moved_scale_rows=sum(moved))
    eng, win, _, _ = serve(cfg.with_(sliding_window=64), params, prompts,
                           max_new, cache="paged_q8", probe=ring_probe(resets))
    complete("window 64", win, n)
    ev.update(ring_recycled_w64=eng.pm.allocator.n_recycled,
              recycled_scale_reset=sum(resets))
    if not (ev["deferred"] and ev["preempted_and_resumed"] and
            ev["shared_pages"] and moved and all(moved) and eng.pm.ring and
            resets and all(resets)):
        raise AssertionError(f"{tag} paged_q8 events {ev}, cow moved "
                             f"{moved}, scale resets {resets}")
    ev["agree_with_fp_paged"] = agreement(out, fp_streams)
    log(f"  {tag} paged_q8: events {ev} (tokens agreeing with the fp pool "
        f"before the first difference, per prompt: "
        f"{ev['agree_with_fp_paged']} of {max_new})")
    return ev, out


def q8_prefill_findings(cfg, params, mcfg, mparams, prompt):
    """The 250-token prompt prefilled into a fresh int8 pool by the source
    and the merged model, and into an fp pool by the merged one: the
    int8 entries the two pools hold differently, and the q8 prefill's max
    |logit| error against the fp pool's as a share of the fp max |logit|."""
    import torch
    from repro_torch.models import (PagedPrefillDest, PagedQ8PrefillDest,
                                    forward_prefill, init_paged_cache,
                                    init_paged_q8_cache)

    S = -(-len(prompt) // PAGE) * PAGE
    x = torch.zeros((1, S), dtype=torch.long, device="cuda")
    x[0, :len(prompt)] = torch.as_tensor(prompt)
    tl = torch.tensor([len(prompt)], device="cuda")
    bids = torch.arange(S // PAGE, dtype=torch.int32, device="cuda")
    pools, logits = [], []
    for c, p in ((cfg, params), (mcfg, mparams)):
        q = init_paged_q8_cache(c, S // PAGE, PAGE, 1, S, device="cuda")
        lg, _ = forward_prefill(p, c, x, PagedQ8PrefillDest(
            q.k, q.v, q.k_scale, q.v_scale, bids), impl="cuda", true_len=tl)
        pools.append(q)
        logits.append(lg)
    fp = init_paged_cache(mcfg, S // PAGE, PAGE, 1, S, device="cuda")
    lg_fp, _ = forward_prefill(mparams, mcfg, x, PagedPrefillDest(
        fp.k, fp.v, bids), impl="cuda", true_len=tl)
    a, b = pools
    n_diff = int((a.k != b.k).sum() + (a.v != b.v).sum())
    out = {"int8_entries_differing_merged_vs_source": n_diff,
           "int8_entries": 2 * a.k.numel(),
           "q8_vs_fp_prefill_max_logit_err_share": float(
               (logits[1] - lg_fp).abs().max() / lg_fp.abs().max())}
    log(f"  250-token prefill into the int8 pool: {n_diff:,d} of "
        f"{out['int8_entries']:,d} int8 entries differ between merged and "
        f"source; merged q8 vs fp pool prefill logits: max |err| = "
        f"{out['q8_vs_fp_prefill_max_logit_err_share']:.3g} of the max "
        f"|fp logit|")
    return out


def equal_budget(cfg, params):
    """The peak concurrent streams of the fp (here bfloat16) pool and the
    int8 pool given the same device bytes, on one shared traffic: 16
    requests alternating 40- and 24-token prompts (one repeated), 8 new
    tokens each, 16 slots, max_len 64 (``benchmarks/bench_paged_serving.py``
    ``_serve_quant``'s traffic, at this page size); the fp pool has the
    dense cache's 4 x 64 tokens of pages.  Prefix retention is off on both
    pools (the reference's ``_serve_quant`` keeps it on): a retained page
    is reclaimable, and with it off the cell counts only the pages live
    requests hold, as it did before the port had retention."""
    import numpy as np
    from repro_torch.serving import (Engine, PagedCacheAdapter,
                                     PagedQ8CacheAdapter, ServeConfig)

    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in [40, 24] * 8]
    prompts[1] = prompts[0].copy()
    sc = ServeConfig(n_slots=16, max_len=64)

    def engine(adapter, n_blocks):
        return Engine(cfg, params, sc, impl="cuda", device="cuda",
                      cache=adapter(block_size=PAGE, n_blocks=n_blocks,
                                    prefix_retention=False))

    n_fp = 4 * 64 // PAGE
    budget = engine(PagedCacheAdapter, n_fp).pm.pool_bytes
    n_q8 = budget // (engine(PagedQ8CacheAdapter, 2).pm.pool_bytes // 2)
    out = {"budget_bytes": budget}
    for name, adapter, nb in (("fp", PagedCacheAdapter, n_fp),
                              ("q8", PagedQ8CacheAdapter, n_q8)):
        eng = engine(adapter, nb)
        eng.generate(prompts, max_new_tokens=8)
        out[name] = {"pages": nb, "pool_bytes": eng.pm.pool_bytes,
                     "peak_streams": eng.stats["peak_active"],
                     "deferred": eng.stats["n_deferred"],
                     "preempted": eng.stats["n_preempted"]}
    if out["q8"]["pool_bytes"] > budget:
        raise AssertionError(f"q8 pool over the byte budget: {out}")
    log(f"  equal budget ({budget:,d} bytes), {cfg.dtype}, 16 requests: fp "
        f"pool {out['fp']} / int8 pool {out['q8']}")
    return out


def check_sched_counts(tag, counts, eng, merged, sync_counts=None):
    """A chunked engine launches its decode kernel once per layer and
    decode step and nothing else: no flash kernel runs on a chunk step
    (the chunk's attention is the eager positions-based core, as in the
    reference).  A monolithic one (stacks with SSM layers) launches the
    synchronous engine's flash and SSD kernels (``sync_counts``), and its
    decode kernel once per layer and step."""
    L = eng.cfg.n_layers
    want = {k: 0 for k in KERNELS}
    if eng.cfg.has_attention:
        dec = {"dense": "decode_attention_", "paged":
               "decode_attention_paged_", "paged_q8":
               "decode_attention_paged_q8_"}[eng.kv.kind] + \
            ("merged_bsd" if merged else "bhsd")
        want[dec] = L * eng.stats["n_steps"]
    if sync_counts is not None:
        for k in KERNELS:
            if k.startswith(("flash", "ssd")):
                want[k] = sync_counts[k]
    if counts != want:
        raise AssertionError(f"{tag}: scheduled launch counts {counts} != "
                             f"{want}")
    log(f"  {tag} scheduled: launches { {k: v for k, v in counts.items() if v} }"
        f" ({eng.stats['n_steps']} decode steps, {eng.n_iterations} "
        f"iterations, {eng.n_chunks_run} "
        f"{'chunks' if eng._chunked else 'monolithic jobs'})")


def chunked_q8_logit_error(cfg, params, prompt):
    """The prompt chunked (64 tokens) into an int8 pool and into an fp
    pool by ``forward_prefill_chunk``: the final chunk's max |logit| error
    of the int8 pool against the fp pool's, as a share of the max |fp
    logit| (the reference's q8 gate is 10%)."""
    import torch
    from repro_torch.models import (PagedChunkDest, PagedQ8ChunkDest,
                                    forward_prefill_chunk, init_paged_cache,
                                    init_paged_q8_cache)
    C = SCHED["chunk_tokens"]
    n = -(-len(prompt) // C) * C
    table = torch.arange(n // PAGE, dtype=torch.int32, device="cuda")[None]
    q8 = init_paged_q8_cache(cfg, n // PAGE, PAGE, 1, n, device="cuda")
    fp = init_paged_cache(cfg, n // PAGE, PAGE, 1, n, device="cuda")
    x = torch.zeros((1, n), dtype=torch.long, device="cuda")
    x[0, :len(prompt)] = torch.as_tensor(prompt)
    for start in range(0, n, C):
        bids = table[0, start // PAGE:(start + C) // PAGE]
        kw = dict(start=start, true_len=len(prompt), impl="cuda")
        lg_q8, _ = forward_prefill_chunk(params, cfg, x[:, start:start + C],
                                         PagedQ8ChunkDest(*q8[:4], table,
                                                          bids), **kw)
        lg_fp, _ = forward_prefill_chunk(params, cfg, x[:, start:start + C],
                                         PagedChunkDest(fp.k, fp.v, table,
                                                        bids), **kw)
    return float((lg_q8 - lg_fp).abs().max() / lg_fp.abs().max())


def sched_checks(cfg, params, mcfg, mparams, prompts, max_new):
    """The scheduled path at 4 calibrated layers in float32 (chunks of 64,
    256 tokens a step, max_len 512, 4 slots; the four prompts and a repeat
    of the 250-token one): on the dense cache and the paged pool the
    ``ScheduledEngine``'s greedy streams equal the synchronous engine's,
    merged equal source, a warm prefix hit (the 250-token prompt served
    again after its pages were released to the prefix cache) equals the
    cold stream, and a starved pool (deferral and preemption counted)
    equals the roomy one; the int8 pool's agreement with them and its
    chunked prefill's logit error (gate 10%) are printed.  Returns the
    findings."""
    sp = list(prompts) + [prompts[3].copy()]
    out, sync_streams = {}, {}
    for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
        merged = tag == "merged"
        _, sync, _, _ = serve(c, p, sp, max_new)
        want = streams(sync)
        sync_streams[tag] = want
        ev = {}
        for cache in ("dense", "paged"):
            eng, res, counts, _ = serve(c, p, sp, max_new, cache,
                                        sched=True)
            check_sched_counts(f"{tag} {cache} float32", counts, eng, merged)
            if streams(res) != want or not eng._chunked:
                raise AssertionError(f"{tag} {cache}: scheduled streams "
                                     f"differ from the synchronous engine's")
        # the paged engine again: the 250-token prompt once more, its pages
        # now held only by the prefix cache
        hits = eng.pm.tree.hit_tokens
        warm = eng.generate([sp[3]], max_new_tokens=max_new)
        ev["warm_hit_tokens"] = eng.pm.tree.hit_tokens - hits
        if list(warm[0]) != want[3] or not ev["warm_hit_tokens"]:
            raise AssertionError(f"{tag}: warm prefix hit {ev} differs from "
                                 f"the cold stream")
        eng, res, counts, _ = serve(c, p, sp, max_new, "paged", sched=True,
                                    n_blocks=SCHED_STARVED_PAGES)
        check_sched_counts(f"{tag} paged float32, {SCHED_STARVED_PAGES} "
                           f"pages", counts, eng, merged)
        ev.update(starved_pages=SCHED_STARVED_PAGES,
                  deferred=eng.stats["n_deferred"],
                  preempted=eng.stats["n_preempted"])
        if streams(res) != want or not (ev["deferred"] and ev["preempted"]):
            raise AssertionError(f"{tag}: starved scheduled pool {ev}, "
                                 f"streams equal {streams(res) == want}")
        eng, res, counts, _ = serve(c, p, sp, max_new, "paged_q8",
                                    sched=True)
        check_sched_counts(f"{tag} paged_q8 float32", counts, eng, merged)
        ev["q8_agree_with_fp"] = agreement(res, want)
        ev["q8_chunked_prefill_logit_err_share"] = chunked_q8_logit_error(
            c, p, sp[3])
        if not ev["q8_chunked_prefill_logit_err_share"] <= 0.10:
            raise AssertionError(f"{tag}: chunked q8 prefill logit error "
                                 f"{ev} over the 10% gate")
        log(f"  {tag} scheduled float32: streams == synchronous on dense and "
            f"paged, warm prefix hit == cold, starved pool == roomy; "
            f"{ev}")
        out[tag] = ev
    if sync_streams["merged"] != sync_streams["source"]:
        raise AssertionError("scheduled path: merged and source streams "
                             "differ")
    log(f"  scheduled merged == source (float32, {EQ_LAYERS} layers, "
        f"{len(sp)} requests)")
    return out


def sampling_checks(cfg, params, prompts, max_new):
    """Temperature 0.8, top-k 50 on the paged pool, on one model: a
    request's stream alone == beside the others; a pool that preempts ==
    a roomy one; the scheduler's streams == the synchronous engine's;
    top_k=1 == greedy.  Then device launches per decode step, sampled and
    greedy (``torch.profiler``)."""
    kw = dict(cache="paged", temperature=0.8, top_k=50, seed=7)
    _, busy, _, _ = serve(cfg, params, prompts, max_new, **kw)
    busy = streams(busy)
    _, solo, _, _ = serve(cfg, params, prompts[:1], max_new, **kw)
    # the pool of ``paged_checks`` (the prompts reordered so the longest
    # is admitted beside a short one): a request's stream depends on its
    # arrival index, so the roomy run takes the same order
    need = max(-(-(len(p) + max_new - 1) // PAGE) for p in prompts)
    reordered = [prompts[i] for i in (0, 3, 1, 2)]
    eng, tight, _, _ = serve(cfg, params, reordered, max_new,
                             n_blocks=need + 1, **kw)
    n_pre = eng.stats["n_preempted"]
    _, roomy, _, _ = serve(cfg, params, reordered, max_new, **kw)
    _, sched, _, _ = serve(cfg, params, prompts, max_new, sched=True, **kw)
    _, top1, _, _ = serve(cfg, params, prompts, max_new,
                          **{**kw, "top_k": 1})
    _, greedy, _, _ = serve(cfg, params, prompts, max_new, cache="paged")
    ok = {"solo_eq_busy": streams(solo) == busy[:1],
          "tight_eq_roomy": streams(tight) == streams(roomy),
          "tight_preempted": n_pre,
          "sched_eq_sync": streams(sched) == busy,
          "top1_eq_greedy": streams(top1) == streams(greedy),
          "sampled_differs_from_greedy": busy != streams(greedy)}
    if not all(ok.values()):
        raise AssertionError(f"sampling on the card: {ok}")
    ok["launches_per_decode_step"] = {
        tag: profile_decode(cfg, params, prompts, "paged",
                            **skw)["kernels_per_step"]
        for tag, skw in (("sampled", dict(temperature=0.8, top_k=50,
                                          seed=7)), ("greedy", {}))}
    log(f"  sampling (T 0.8, top-k 50, paged, {cfg.n_layers} layers): {ok}")
    return ok


def profile_chunk(cfg, params, prompt, cache, steps=3):
    """``profiled`` over ``steps`` runs of one 64-token chunk step (the
    third chunk of ``prompt``, tokens 128-191, against the chunks before
    it) of a 4-slot ``ScheduledEngine`` on ``cache``; then the same
    step's eager chunk-attention calls alone (recorded from the step), so
    that their share of the step's device time is read off two profiles.
    Returns the step's profile with ``attention_share``."""
    import numpy as np
    from repro_torch.models import transformer as tr
    from repro_torch.serving import SchedConfig, ScheduledEngine, ServeConfig

    C = SCHED["chunk_tokens"]
    eng = ScheduledEngine(cfg, params, ServeConfig(n_slots=4, max_len=512),
                          SchedConfig(**SCHED), impl="cuda", cache=cache,
                          device="cuda")
    toks = np.asarray(prompt, np.int32)
    eng.kv.admit_chunked(0, toks)
    for start in range(0, 2 * C, C):  # the chunks before the profiled one
        eng.kv.chunk_step(eng.params, 0, eng.host_to_device(
            toks[start:start + C])[None], start, len(toks))
    row = eng.host_to_device(toks[2 * C:3 * C])[None]
    calls, core = [], tr._chunk_core

    def recording(*a, **k):
        calls.append((a, k))
        return core(*a, **k)

    tr._chunk_core = recording
    try:
        eng.kv.chunk_step(eng.params, 0, row, 2 * C, len(toks))
    finally:
        tr._chunk_core = core
    what = (f"chunk step profile, {cfg.name}, {cache} cache, {cfg.dtype} "
            f"({cfg.n_layers} layers, tokens {2 * C}-{3 * C - 1} of "
            f"{len(toks)})")
    prof = profiled(what, lambda: eng.kv.chunk_step(
        eng.params, 0, row, 2 * C, len(toks)), steps)
    attn = profiled(f"  its eager chunk attention alone ({len(calls)} "
                    f"calls)", lambda: [core(*a, **k) for a, k in calls],
                    steps)
    prof["attention_device_ms_per_step"] = attn["device_ms_per_step"]
    prof["attention_kernels_per_step"] = attn["kernels_per_step"]
    prof["attention_share"] = (attn["device_ms_per_step"]
                               / prof["device_ms_per_step"])
    log(f"  eager chunk attention: {attn['device_ms_per_step']:.3f} of "
        f"{prof['device_ms_per_step']:.3f} device ms per chunk step "
        f"({100 * prof['attention_share']:.1f}%), "
        f"{attn['kernels_per_step']} of {prof['kernels_per_step']} launches")
    return prof


def path_phase(summary):
    import numpy as np
    import torch
    from repro_torch._tree import tree_map

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
        if streams(src_out) != streams(mrg_out):
            bad = first_mismatch(cfg, params, prompts, src_out, mrg_out)
            raise AssertionError(
                f"merged and source greedy streams differ: prompt {bad[0]}, "
                f"position {bad[1]}, source top-2 logit margin {bad[2]:.3g}")
        log(f"  greedy streams identical (merged vs source, float32, "
            f"{EQ_LAYERS} layers): {[list(o[:6]) for o in mrg_out]} …")
        # the kernels' path against the plain PyTorch forward on one prompt
        kernels_vs_plain("merged", mcfg, mparams, prompts[1], 1e-4)
        # the paged pool: the same streams, through its deferral,
        # preemption, sharing and ring paths
        summary["paged_events"] = {
            tag: paged_checks(tag, c, p, prompts, max_new, want)
            for tag, c, p, want in (("source", cfg, params, src_out),
                                    ("merged", mcfg, mparams, mrg_out))}
        for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
            summary["paged_events"][tag]["ring_recycled_w64"] = \
                window_checks(tag, c, p, prompts, max_new)
        # the int8 pool: its events asserted; how far its streams agree,
        # and its bits, printed as findings
        q8, q8_out = {}, {}
        for tag, c, p, fp in (("source", cfg, params, src_out),
                              ("merged", mcfg, mparams, mrg_out)):
            q8[tag], q8_out[tag] = q8_checks(tag, c, p, prompts, max_new, fp)
        q8["merged_vs_source_agree"] = agreement(q8_out["merged"],
                                                 q8_out["source"])
        log(f"  paged_q8 merged vs source: tokens agreeing before the first "
            f"difference, per prompt: {q8['merged_vs_source_agree']} of "
            f"{max_new}")
        q8.update(q8_prefill_findings(cfg, params, mcfg, mparams, prompts[3]))
        summary["q8_4_layers"] = q8
        # the scheduled path, and temperature sampling, on the same models
        summary["sched_4_layers"] = sched_checks(cfg, params, mcfg, mparams,
                                                 prompts, max_new)
        summary["sampling_4_layers"] = sampling_checks(mcfg, mparams,
                                                       prompts, max_new)
        del src, mrg, params, mparams
        torch.cuda.empty_cache()

        # 2. the full 32-layer model, uncalibrated (its activations decay to
        # exact zeros, which costs the kernels and matmuls the same work):
        # launch counts on the main paths, and speed
        cfg, params, mcfg, mparams = build(32, calibrate=False)
        L = cfg.n_layers
        launches = {k: 0 for k in KERNELS}
        for cache in ("dense", "paged", "paged_q8"):
            for tag, c, p, merged in (("source (generic)", cfg, params, False),
                                      ("merged", mcfg, mparams, True)):
                eng, _, counts, _ = serve(c, p, prompts, max_new, cache=cache)
                check_counts(f"{tag} {cache} float32", counts, eng, L, n,
                             merged)
                launches = {k: launches[k] + counts[k] for k in KERNELS}
                eng, _, counts, _ = serve(c, p, prompts, max_new, cache,
                                          sched=True)
                check_sched_counts(f"{tag} {cache} float32 ({L} layers)",
                                   counts, eng, merged)
                launches = {k: launches[k] + counts[k] for k in KERNELS}
        summary["launches"] = launches
        kernels_vs_plain(f"merged {L} layers, uncalibrated", mcfg, mparams,
                         prompts[1])
        for tag, c, p in (("source", cfg, params),
                          ("merged", mcfg, mparams)):
            eng, outs, _, wall = serve(c, p, prompts, max_new)
            summary[f"{tag}_f32"] = report(f"{tag} float32 ({L} layers)",
                                           outs, wall)
        del eng, params, p
        torch.cuda.empty_cache()
        bcfg = mcfg.with_(dtype="bfloat16", param_dtype="bfloat16")
        bparams = tree_map(lambda t: t.to(torch.bfloat16), mparams)
        del mparams
        torch.cuda.empty_cache()
        for cache in ("dense", "paged", "paged_q8"):
            serve(bcfg, bparams, prompts, max_new, cache=cache)  # warm-up
            eng, outs, counts, wall = serve(bcfg, bparams, prompts, max_new,
                                            cache=cache)
            check_counts(f"merged bfloat16 {cache}", counts, eng, L, n,
                         merged=True)
            if not all(0 <= t < bcfg.vocab_size for o in outs for t in o):
                raise AssertionError("bfloat16 serve emitted out-of-vocab ids")
            key = "merged_bf16" + ("" if cache == "dense" else "_" + cache)
            summary[key] = report(f"merged bfloat16, {cache} cache ({L} "
                                  "layers)", outs, wall)
            serve(bcfg, bparams, prompts, max_new, cache, sched=True)
            eng, outs, counts, wall = serve(bcfg, bparams, prompts, max_new,
                                            cache, sched=True)
            check_sched_counts(f"merged bfloat16 {cache}", counts, eng,
                               merged=True)
            summary["sched_" + key] = dict(
                report(f"merged bfloat16, {cache} cache, scheduled ({L} "
                       f"layers)", outs, wall),
                iterations=eng.n_iterations, chunks=eng.n_chunks_run,
                decode_steps=eng.stats["n_steps"])
            summary["sched_" + key]["chunk_step_profile"] = profile_chunk(
                bcfg, bparams, prompts[3], cache)
        summary["decode_profile_bf16"] = {
            cache: profile_decode(bcfg, bparams, prompts, cache)
            for cache in ("dense", "paged", "paged_q8")}
        summary["prefill_profile_bf16"] = prefill_profiles(bcfg, bparams)
        summary["equal_budget_bf16"] = equal_budget(bcfg, bparams)
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")


SSM_LENS = (16, 37, 250, 512)  # 512: state carried across two 256-row chunks
SSM_MAX_LEN = 1024  # Hymba's window: the ring holds all a query may attend


def ssm_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in SSM_LENS]


def kernels_vs_plain(tag, cfg, params, prompt, rel=None, vision=None):
    """The kernels' prefill logits against the plain PyTorch forward on
    one prompt (a VLM: with its ``vision``): finite, same shape and,
    unless ``rel`` is None (a finding only), max |diff| <= ``rel`` x max
    |logit|.  Returns the ratio."""
    import torch
    from repro_torch.models import DensePrefillDest, forward_prefill
    x = torch.as_tensor(prompt, device="cuda")[None]
    vis = None if vision is None else torch.as_tensor(vision,
                                                      device="cuda")[None]
    dest = DensePrefillDest(len(prompt))
    lg_k, _ = forward_prefill(params, cfg, x, dest, vision=vis, impl="cuda")
    lg_p, _ = forward_prefill(params, cfg, x, dest, vision=vis, impl="torch")
    scale = float(lg_p.abs().max())
    diff = float((lg_k - lg_p).abs().max())
    if not (torch.isfinite(lg_k).all() and lg_k.shape == lg_p.shape
            and (rel is None or 0 < scale and diff <= rel * scale)):
        raise AssertionError(f"{tag} prefill logits vs plain forward: max "
                             f"diff {diff} (scale {scale})")
    log(f"  {tag} prefill logits vs plain PyTorch forward ({len(prompt)} "
        f"tokens): max |diff| {diff:.3g} at logit scale {scale:.3g}"
        f"{'' if rel is None else f' (gate {rel:g} of the scale)'}")
    return diff / scale if scale else None


def hybrid_path(summary):
    """Hymba-1.5B at full width (d 1600, GQA 25/5 of d_head 64, d_ff 5504,
    SSM 50 x 64 x 16, window 1024), skipless from seed 0, and its qp merge
    (Q removed, P kept), on the dense cache (max_len 1024 = the window):
    at 4 calibrated layers in float32 the merged and source streams must
    be identical and the kernels' prefill logits must agree with the plain
    forward; at 32 layers the launch counters must show per prompt 32
    flash and 32 SSD launches and per decode step 32 decode launches and
    nothing else, and bf16 merged and source tok/s, TTFT and the merged
    model's decode and 512-token prefill profiles are printed."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.core import removed_weight_count

    n = len(SSM_LENS)
    max_new = 16
    with torch.no_grad():
        cfg, params, mcfg, mparams = build(EQ_LAYERS, True, "hymba-1.5b")
        prompts = ssm_prompts(cfg.vocab_size)
        outs = {}
        for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
            eng, outs[tag], counts, _ = serve(c, p, prompts, max_new,
                                              max_len=SSM_MAX_LEN)
            check_counts(f"hymba {tag} float32", counts, eng, EQ_LAYERS, n,
                         merged=False)
            # the scheduler: monolithic jobs (SSM state has no mid-prompt
            # checkpoint), the synchronous engine's streams and prefills
            eng, res, sched_counts, _ = serve(c, p, prompts, max_new,
                                              max_len=SSM_MAX_LEN, sched=True)
            check_sched_counts(f"hymba {tag} float32", sched_counts, eng,
                               merged=False, sync_counts=counts)
            if eng._chunked or streams(res) != streams(outs[tag]):
                raise AssertionError(f"hymba {tag}: scheduled streams differ "
                                     f"from the synchronous engine's")
        if streams(outs["source"]) != streams(outs["merged"]):
            bad = first_mismatch(cfg, params, prompts, outs["source"],
                                 outs["merged"])
            raise AssertionError(
                f"hymba merged and source greedy streams differ: prompt "
                f"{bad[0]}, position {bad[1]}, source top-2 margin "
                f"{bad[2]:.3g}")
        log(f"  hymba greedy streams identical (merged vs source, float32, "
            f"{EQ_LAYERS} layers, prompts {SSM_LENS}): "
            f"{[list(o[:6]) for o in outs['merged']]} …")
        # the SSD kernel's y is ~5e-6 of its scale off the plain scan's
        # (kernel phase) and a skipless stack amplifies ~2x per layer
        summary["hymba_4_layers"] = {"plain_vs_kernels_rel": kernels_vs_plain(
            "hymba merged", mcfg, mparams, prompts[1], 1e-3)}
        del params, mparams, eng
        torch.cuda.empty_cache()

        cfg, params, mcfg, mparams = build(32, False, "hymba-1.5b")
        L = cfg.n_layers
        removed = removed_weight_count(params, mparams)
        outs = {}
        for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
            eng, outs[tag], counts, _ = serve(c, p, prompts, max_new,
                                              max_len=SSM_MAX_LEN)
            check_counts(f"hymba {tag} float32 ({L} layers)", counts, eng, L,
                         n, merged=False)
            summary["launches"] = {k: summary["launches"][k] + counts[k]
                                   for k in KERNELS}
        agree = agreement(outs["merged"], outs["source"])
        lg = kernels_vs_plain(f"hymba merged {L} layers", mcfg, mparams,
                              prompts[1])
        log(f"  hymba {L} layers float32: merged vs source tokens agreeing "
            f"before the first difference, per prompt: {agree} of {max_new}")
        out = {"weights_removed": removed, "merged_vs_source_agree_f32": agree,
               "plain_vs_kernels_rel_f32": lg}
        del eng, p
        bf = {}
        for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
            bcfg = c.with_(dtype="bfloat16", param_dtype="bfloat16")
            bparams = tree_map(lambda t: t.to(torch.bfloat16), p)
            serve(bcfg, bparams, prompts, max_new, max_len=SSM_MAX_LEN)
            eng, res, counts, wall = serve(bcfg, bparams, prompts, max_new,
                                           max_len=SSM_MAX_LEN)
            check_counts(f"hymba {tag} bfloat16", counts, eng, L, n, False)
            out[f"{tag}_bf16"] = report(
                f"hymba {tag} bfloat16, dense cache ({L} layers)", res, wall)
            bf[tag] = (bcfg, bparams)
            del eng
        log(f"  hymba qp merge removed {removed:,d} weights (Q only)")
        del params, mparams, p
        out["decode_profile_merged_bf16"] = profile_decode(
            *bf["merged"], prompts, "dense", max_len=SSM_MAX_LEN)
        out["prefill_profile_merged_bf16"] = profile_prefill(
            *bf["merged"], prompts[3])
        del bf
        torch.cuda.empty_cache()
    summary["hymba"] = out


def mamba2_path(summary):
    """Mamba2-2.7B at full width (64 layers, d 2560, SSM 80 x 64 x 128,
    vocab 50280), standard style from seed 0, on the dense cache: the
    kernels' float32 prefill logits against the plain forward, the launch
    counters (64 SSD launches per prompt and nothing else), bf16 tok/s and
    TTFT, and decode and 512-token prefill profiles."""
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_params

    n = len(SSM_LENS)
    max_new = 16
    with torch.no_grad():
        cfg = get_config("mamba2-2.7b").with_(dtype="float32")
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")
        torch.cuda.synchronize()
        L = cfg.n_layers
        log(f"init {cfg.name} standard ({L} layers, d_model {cfg.d_model}, "
            f"SSM {cfg.ssm_n_heads}x{cfg.ssm_head_dim}x{cfg.ssm_state}, "
            f"{count_params(params):,d} weights) on the card: "
            f"{time.perf_counter() - t0:.1f} s")
        prompts = ssm_prompts(cfg.vocab_size)
        # a pre-norm residual stack: the kernel's ~5e-6 relative error per
        # layer adds up over 64 layers, far below 1e-3
        out = {"plain_vs_kernels_rel_f32": kernels_vs_plain(
            "mamba2", cfg, params, prompts[1], 1e-3)}
        eng, sync, counts, _ = serve(cfg, params, prompts, max_new,
                                     max_len=SSM_MAX_LEN)
        check_counts(f"mamba2 float32 ({L} layers)", counts, eng, L, n,
                     merged=False)
        eng, res, sched_counts, _ = serve(cfg, params, prompts, max_new,
                                          max_len=SSM_MAX_LEN, sched=True)
        check_sched_counts(f"mamba2 float32 ({L} layers)", sched_counts, eng,
                           merged=False, sync_counts=counts)
        if eng._chunked or streams(res) != streams(sync):
            raise AssertionError("mamba2: scheduled streams differ from the "
                                 "synchronous engine's")
        summary["launches"] = {k: summary["launches"][k] + counts[k]
                               + sched_counts[k] for k in KERNELS}
        del eng
        bcfg = cfg.with_(dtype="bfloat16", param_dtype="bfloat16")
        bparams = tree_map(lambda t: t.to(torch.bfloat16), params)
        del params
        torch.cuda.empty_cache()
        serve(bcfg, bparams, prompts, max_new, max_len=SSM_MAX_LEN)
        eng, res, counts, wall = serve(bcfg, bparams, prompts, max_new,
                                       max_len=SSM_MAX_LEN)
        check_counts("mamba2 bfloat16", counts, eng, L, n, merged=False)
        out["bf16"] = report(f"mamba2 bfloat16, dense cache ({L} layers)",
                             res, wall)
        del eng
        out["decode_profile_bf16"] = profile_decode(
            bcfg, bparams, prompts, "dense", max_len=SSM_MAX_LEN)
        out["prefill_profile_bf16"] = profile_prefill(bcfg, bparams,
                                                      prompts[3])
        del bparams
        torch.cuda.empty_cache()
    summary["mamba2"] = out


DENSE_ARCHS = ("llama3.2-1b", "phi3-medium-14b", "qwen2.5-32b",
               "pythia-6.9b", "chatglm3-6b")
# bf16 layers served per config after the 4-layer checks: the full depth,
# except Qwen2.5-32B (64 layers take ~65 GB alone) and Phi-3-medium-14B,
# cut to half their layers (16 of 64 and 20 of 40) so that the script,
# with its model-axis phase, keeps a margin under its time limit: their
# random weights take ~20 s each to draw on the card at 32 and 40 layers
CONFIG_DEPTH = {"qwen2.5-32b": 16, "phi3-medium-14b": 20}


def dense_configs_path(summary):
    """The reference's five other dense configs at full width (Llama-3.2-1B:
    D 64, tied embeddings, vocab 128,256; Phi-3-medium-14B: G 4;
    Qwen2.5-32B: G 5, QKV biases; Pythia-6.9B: MHA, parallel blocks, GeLU
    MLP, source only; ChatGLM3-6B: G 16, QKV biases, half-dimension
    interleaved RoPE), skipless from seed 0 with seeded nonzero QKV biases,
    and their qp merges; the Mistral path's four prompt lengths, 16 new
    tokens each:

    * 4 calibrated layers in float32: merged == source greedy streams on
      the dense cache (Pythia: its merge raises), paged == dense, the
      ``ScheduledEngine``'s == the synchronous engine's on both caches,
      exact launch counts on each, and the kernels' prefill logits
      against the plain forward (1e-4 of the logit scale);
    * ``CONFIG_DEPTH`` layers in bfloat16: exact launch counts per prompt
      and per decode step (``n_layers`` decode launches a step, G 16
      included) on the dense cache, the paged pool and the int8 pool for
      the source and the merge, and the scheduler's on the dense cache;
      the served model's (merged; Pythia's source) tok/s and TTFT, one
      run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config

    max_new, lens = 16, (16, 37, 100, 250)
    n = len(lens)
    out = {}
    with torch.no_grad():
        for arch in DENSE_ARCHS:
            cfg, params, mcfg, mparams = build(EQ_LAYERS, True, arch)
            rng = np.random.default_rng(4)
            prompts = [rng.integers(0, cfg.vocab_size, m) for m in lens]
            models = [("source", cfg, params, False)]
            if mcfg is not None:
                models.append(("merged", mcfg, mparams, True))
            dense = {}
            for tag, c, p, merged in models:
                name = f"{arch} {tag} float32"
                eng, res, counts, _ = serve(c, p, prompts, max_new)
                check_counts(name, counts, eng, EQ_LAYERS, n, merged)
                dense[tag] = streams(res)
                eng, res, counts, _ = serve(c, p, prompts, max_new, "paged")
                check_counts(f"{name} paged", counts, eng, EQ_LAYERS, n,
                             merged)
                if streams(res) != dense[tag]:
                    raise AssertionError(f"{name}: paged streams differ "
                                         f"from dense")
                for cache in ("dense", "paged"):
                    eng, res, counts, _ = serve(c, p, prompts, max_new,
                                                cache, sched=True)
                    check_sched_counts(f"{name} {cache}", counts, eng,
                                       merged)
                    if streams(res) != dense[tag] or not eng._chunked:
                        raise AssertionError(f"{name} {cache}: scheduled "
                                             f"streams differ")
            if mcfg is not None and dense["merged"] != dense["source"]:
                bad = first_mismatch(cfg, params, prompts, dense["source"],
                                     dense["merged"])
                raise AssertionError(
                    f"{arch}: merged and source greedy streams differ: "
                    f"prompt {bad[0]}, position {bad[1]}, source top-2 "
                    f"margin {bad[2]:.3g}")
            tag, c, p, _ = models[-1]
            rel = kernels_vs_plain(f"{arch} {tag}", c, p, prompts[1], 1e-4)
            log(f"  {arch} ({EQ_LAYERS} layers, float32): "
                + ("merged == source, " if mcfg is not None else "")
                + "paged == dense, scheduled == synchronous: "
                f"{[s[:6] for s in dense['source']]} …")
            res_arch = {"plain_vs_kernels_rel_f32": rel,
                        "merged": mcfg is not None}
            del models, params, mparams, p, eng
            torch.cuda.empty_cache()

            L = CONFIG_DEPTH.get(arch, get_config(arch).n_layers)
            cfg, params, mcfg, mparams = build(L, False, arch,
                                               dtype="bfloat16")
            models = [("source", cfg, params, False)]
            if mcfg is not None:
                models.append(("merged", mcfg, mparams, True))
            for tag, c, p, merged in models:
                for cache in ("dense", "paged", "paged_q8"):
                    eng, res, counts, _ = serve(c, p, prompts, max_new,
                                                cache)
                    check_counts(f"{arch} {tag} bfloat16 {cache} ({L} "
                                 f"layers)", counts, eng, L, n, merged)
                    summary["launches"] = {
                        k: summary["launches"][k] + counts[k]
                        for k in KERNELS}
                eng, res, counts, _ = serve(c, p, prompts, max_new,
                                            sched=True)
                check_sched_counts(f"{arch} {tag} bfloat16 dense ({L} "
                                   f"layers)", counts, eng, merged)
                summary["launches"] = {k: summary["launches"][k] + counts[k]
                                       for k in KERNELS}
            tag, c, p, _ = models[-1]
            serve(c, p, prompts, max_new)  # warm-up
            eng, res, counts, wall = serve(c, p, prompts, max_new)
            if not all(0 <= t < c.vocab_size for o in res for t in o):
                raise AssertionError(f"{arch}: out-of-vocab ids")
            res_arch.update(layers=L, served=tag, bf16=report(
                f"{arch} {tag} bfloat16, dense cache ({L} layers)", res,
                wall))
            out[arch] = res_arch
            del models, params, mparams, p, eng
            torch.cuda.empty_cache()
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    summary["dense_configs"] = out


MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")
# bf16 depth cuts at full width, so that the source and its merge fit on
# the card together, halved again (from 12 and 24) for the script's time
# margin (PERF.md section 4)
MOE_DEPTH = {"phi3.5-moe-42b-a6.6b": 6, "moonshot-v1-16b-a3b": 12}


def drop_counter():
    """Wraps ``repro_torch.models.moe.route`` to record, for each routing
    call whose capacity is below its group (whole-prompt prefill at the
    configured capacity factor; dropless calls cannot drop), the number of
    (token, choice) pairs it drops.  Returns (that list, a function that
    puts ``route`` back)."""
    from repro_torch.models import moe
    real, rec = moe.route, []

    def counting(router, xg, k, cap):
        out = real(router, xg, k, cap)
        if cap < xg.shape[-2]:
            rec.append(int((~out[3]).sum()))
        return out

    moe.route = counting
    return rec, lambda: setattr(moe, "route", real)


def moe_path(summary):
    """The reference's two MoE configs at full width (Phi-3.5-MoE: GQA
    32/8 of 128, 16 experts top-2 of d_ff 6400; Moonshot-v1-16B-A3B: MHA
    16/16 of 128, 64 experts top-6 of d_ff 1408, vocab 163,840), skipless
    from seed 0, and their qp merges (P folded into the router and every
    expert); the Mistral path's four prompt lengths, 16 new tokens each:

    * 4 calibrated layers in float32 at the no-drop capacity
      ``capacity_factor = n_experts``: merged == source greedy streams on
      the dense cache, paged == dense, the ``ScheduledEngine``'s == the
      synchronous engine's on both caches, exact launch counts on each,
      and the kernels' prefill logits against the plain forward (1e-4 of
      the logit scale);
    * the same weights at the config's capacity factor 1.25, where
      whole-prompt prefill drops (token, choice) pairs: merged == source
      streams on the dense cache, and the merge removed
      ``weight_table(cfg)["removed"]`` weights at that depth.  The pairs
      dropped per prefill, and how far the scheduled streams agree with
      the synchronous ones (chunks route dropless, so they may differ),
      are printed, not gated;
    * ``MOE_DEPTH`` layers in bfloat16: exact launch counts on the dense
      cache, the paged pool and the int8 pool for the source and the
      merge, and the scheduler's on the dense cache; the merged model's
      tok/s, TTFT and peak device memory, one run; a profile of its
      decode steps on the dense cache with the MoE blocks' share of the
      device time, beside the paper's model of the merge's decode gain
      (``decode_speedup``, total and active-only) and the least time a
      step could take streaming the weights the buffer-form dispatch
      reads (every expert's)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (decode_ms_per_token, decode_speedup,
                                  removed_weight_count, weight_table)
    from repro_torch.models import moe

    max_new, lens = 16, (16, 37, 100, 250)
    n = len(lens)
    out = {}
    with torch.no_grad():
        for arch in MOE_ARCHS:
            full = get_config(arch)
            cfg, params, mcfg, mparams = build(
                EQ_LAYERS, True, arch, capacity_factor=float(full.n_experts))
            rng = np.random.default_rng(4)
            prompts = [rng.integers(0, cfg.vocab_size, m) for m in lens]
            models = [("source", cfg, params, False),
                      ("merged", mcfg, mparams, True)]
            dense = {}
            for tag, c, p, merged in models:
                name = f"{arch} {tag} float32 no-drop"
                eng, res, counts, _ = serve(c, p, prompts, max_new)
                check_counts(name, counts, eng, EQ_LAYERS, n, merged)
                dense[tag] = streams(res)
                eng, res, counts, _ = serve(c, p, prompts, max_new, "paged")
                check_counts(f"{name} paged", counts, eng, EQ_LAYERS, n,
                             merged)
                if streams(res) != dense[tag]:
                    raise AssertionError(f"{name}: paged streams differ "
                                         f"from dense")
                for cache in ("dense", "paged"):
                    eng, res, counts, _ = serve(c, p, prompts, max_new,
                                                cache, sched=True)
                    check_sched_counts(f"{name} {cache}", counts, eng,
                                       merged)
                    if streams(res) != dense[tag] or not eng._chunked:
                        raise AssertionError(f"{name} {cache}: scheduled "
                                             f"streams differ")
            if dense["merged"] != dense["source"]:
                bad = first_mismatch(cfg, params, prompts, dense["source"],
                                     dense["merged"])
                raise AssertionError(
                    f"{arch} no-drop: merged and source greedy streams "
                    f"differ: prompt {bad[0]}, position {bad[1]}, source "
                    f"top-2 margin {bad[2]:.3g}")
            rel = kernels_vs_plain(f"{arch} merged no-drop", mcfg, mparams,
                                   prompts[1], 1e-4)
            log(f"  {arch} ({EQ_LAYERS} layers, float32, capacity factor "
                f"{cfg.capacity_factor:g}): merged == source, paged == "
                f"dense, scheduled == synchronous: "
                f"{[s[:6] for s in dense['source']]} …")

            removed = removed_weight_count(params, mparams)
            if removed != weight_table(cfg)["removed"]:
                raise AssertionError(
                    f"{arch}: the merge removed {removed:,d} weights, the "
                    f"table says {weight_table(cfg)['removed']:,d}")
            drops, agree, dflt = {}, {}, {}
            for tag, c, p, merged in models:
                c = c.with_(capacity_factor=full.capacity_factor)
                name = f"{arch} {tag} float32 capacity " \
                    f"{c.capacity_factor:g}"
                rec, restore = drop_counter()
                try:
                    eng, res, counts, _ = serve(c, p, prompts, max_new)
                finally:
                    restore()
                check_counts(name, counts, eng, EQ_LAYERS, n, merged)
                dflt[tag] = streams(res)
                drops[tag] = [sum(rec[i:i + EQ_LAYERS])
                              for i in range(0, len(rec), EQ_LAYERS)]
                eng, res, counts, _ = serve(c, p, prompts, max_new,
                                            sched=True)
                check_sched_counts(name, counts, eng, merged)
                agree[tag] = agreement(dflt[tag], streams(res))
            if dflt["merged"] != dflt["source"]:
                c = cfg.with_(capacity_factor=full.capacity_factor)
                bad = first_mismatch(c, params, prompts, dflt["source"],
                                     dflt["merged"])
                raise AssertionError(
                    f"{arch} capacity {full.capacity_factor:g}: merged and "
                    f"source greedy streams differ: prompt {bad[0]}, "
                    f"position {bad[1]}, source top-2 margin {bad[2]:.3g}")
            log(f"  {arch} capacity {full.capacity_factor:g} ({EQ_LAYERS} "
                f"layers, float32): merged == source "
                f"{[s[:6] for s in dflt['source']]} …; the merge removed "
                f"{removed:,d} weights = weight_table's; pairs dropped per "
                f"prefill (prompts of {list(lens)} tokens, bucketed): "
                f"{drops}; scheduled (dropless chunks) vs synchronous, "
                f"tokens shared before the first difference of "
                f"{max_new}: {agree}")
            res_arch = {"plain_vs_kernels_rel_f32": rel,
                        "dropped_pairs_per_prefill": drops["source"],
                        "sched_vs_sync_agreement_default_capacity":
                        agree["source"]}
            del models, params, mparams, p, c, eng
            torch.cuda.empty_cache()

            L = MOE_DEPTH[arch]
            torch.cuda.reset_peak_memory_stats()
            cfg, params, mcfg, mparams = build(L, False, arch,
                                               dtype="bfloat16")
            if removed_weight_count(params, mparams) != \
                    weight_table(cfg)["removed"]:
                raise AssertionError(f"{arch} ({L} layers): the merge's "
                                     f"removed weights != weight_table's")
            models = [("source", cfg, params, False),
                      ("merged", mcfg, mparams, True)]
            for tag, c, p, merged in models:
                for cache in ("dense", "paged", "paged_q8"):
                    eng, res, counts, _ = serve(c, p, prompts, max_new,
                                                cache)
                    check_counts(f"{arch} {tag} bfloat16 {cache} ({L} "
                                 f"layers)", counts, eng, L, n, merged)
                    summary["launches"] = {
                        k: summary["launches"][k] + counts[k]
                        for k in KERNELS}
                eng, res, counts, _ = serve(c, p, prompts, max_new,
                                            sched=True)
                check_sched_counts(f"{arch} {tag} bfloat16 dense ({L} "
                                   f"layers)", counts, eng, merged)
                summary["launches"] = {k: summary["launches"][k] + counts[k]
                                       for k in KERNELS}
            serve(mcfg, mparams, prompts, max_new)  # warm-up
            eng, res, counts, wall = serve(mcfg, mparams, prompts, max_new)
            if not all(0 <= t < mcfg.vocab_size for o in res for t in o):
                raise AssertionError(f"{arch}: out-of-vocab ids")
            res_arch.update(layers=L, bf16=report(
                f"{arch} merged bfloat16, dense cache ({L} layers)", res,
                wall))
            real = moe.apply_moe

            def ranged(*a, **k):
                with torch.profiler.record_function("moe_block"):
                    return real(*a, **k)

            profs = {}
            moe.apply_moe = ranged
            try:
                for tag, c, p, _ in models:
                    profs[tag] = profile_decode(c, p, prompts, "dense",
                                                ranges=("moe_block",))
            finally:
                moe.apply_moe = real
            peak = torch.cuda.max_memory_allocated() / 1e9
            t = weight_table(cfg)
            # a buffer-form step streams every expert, the layers' other
            # weights and the unembedding; the input embedding is read a
            # row per token
            unembed = cfg.d_model * cfg.vocab_size
            streamed = t["total_without_qp"] - unembed
            bound = decode_ms_per_token(streamed,
                                        hbm_gbps=HBM_BYTES_PER_S / 1e9)
            dev = {k: v["device_ms_per_step"] for k, v in profs.items()}
            res_arch.update(
                decode_profile=profs["merged"],
                decode_device_ms_source=dev["source"], peak_gb=peak,
                step_bound_ms=bound,
                streamed_ratio=(t["total"] - unembed) / streamed,
                decode_speedup_total=decode_speedup(full),
                decode_speedup_active=decode_speedup(full,
                                                     active_only=True))
            log(f"  {arch} bfloat16 ({L} layers): peak device memory "
                f"{peak:.1f} GB; a merged decode step streams "
                f"{streamed * 2 / 1e9:.1f} GB of weights (every expert: "
                f"the buffer-form dispatch), bound {bound:.3f} ms at 3.35 "
                f"TB/s; decode step device ms source / merged "
                f"{dev['source']:.3f} / {dev['merged']:.3f} = "
                f"{dev['source'] / max(dev['merged'], 1e-9):.4f} against "
                f"the bytes "
                f"streamed, {res_arch['streamed_ratio']:.4f}; the paper's "
                f"decode model for the full config: speedup "
                f"{res_arch['decode_speedup_total']:.4f} over all weights, "
                f"{res_arch['decode_speedup_active']:.4f} over the weights "
                f"a token reads (active experts only)")
            out[arch] = res_arch
            del models, params, mparams, p, eng
            torch.cuda.empty_cache()
    summary["moe_configs"] = out

# ---------------------------------------------------------------------------
# the VLM and the audio encoder
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "llama3.2-vision-11b", "hubert-xlarge"
# float32 identity depth of the VLM: two groups of four self layers and a
# cross layer, so the cross -> next-self fold of the merge is exercised
# (5 if 10 do not hold: one group)
VLM_EQ_LAYERS = (10, 5)
AUDIO_FRAMES = (4, 1000)  # B x frames: 20 s of audio at 50 Hz
AUDIO_TOL = 1e-4  # merges and kernels vs plain: of the float32 logit scale


def cross_phase(rng, rows):
    """Kernel rows of the new shapes: row 1 non-causal at the VLM's cross
    prefill (B 1, Sq 250 over Sk 1600 vision tokens, Hq 32, Hkv 8, D 128)
    and at HuBERT's encoder layer (B 4, Sq = Sk = 1000, MHA 16 of D 80),
    bf16 and float32; row 4 at the VLM's cross decode step (B 4, Hkv 8,
    G 4, D 128, all 1600 vision tokens at q_position 1601), the cache read
    in place (``decode_attention_bshd``).  SDPA runs non-causal on the
    same (head-major) inputs."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fk, ref

    dev = torch.device("cuda")
    for dtype in (torch.bfloat16, torch.float32):
        el = torch.tensor([], dtype=dtype).element_size()

        def rand(*shape):
            return torch.from_numpy(rng.standard_normal(
                shape, np.float32)).to(dev, dtype)

        for label, B, Sq, Sk, Hq_, Hkv_, D_ in (
                ("VLM cross prefill", 1, 250, 1600, 32, 8, 128),
                ("HuBERT encoder", 4, 1000, 1000, 16, 16, 80)):
            nbytes = B * (2 * Sq * Hq_ + 2 * Sk * Hkv_) * D_ * el
            n_sets = n_sets_for(nbytes)
            qh = [rand(B, Hq_, Sq, D_) for _ in range(n_sets)]
            kh = [rand(B, Hkv_, Sk, D_) for _ in range(n_sets)]
            vh = [rand(B, Hkv_, Sk, D_) for _ in range(n_sets)]
            bound = bound_ms(nbytes, 4 * D_ * Hq_ * B * Sq * Sk, dtype)
            rows.append(kernel_row(
                "flash_attention_bhsd", dtype,
                f"B={B} Sq={Sq} Sk={Sk} non-causal Hq={Hq_} Hkv={Hkv_} "
                f"D={D_} ({label})",
                lambda i: fk.flash_attention_bhsd(qh[i], kh[i], vh[i],
                                                  causal=False),
                lambda i: ref.ref_attention(qh[i], kh[i], vh[i],
                                            causal=False),
                lambda i: F.scaled_dot_product_attention(
                    qh[i], kh[i], vh[i], enable_gqa=True),
                n_sets, bound, timed=False))
            del qh, kh, vh
        B, Hkv_, G_, D_, nv = 4, 8, 4, 128, 1600
        nbytes = 2 * B * nv * Hkv_ * D_ * el + 2 * B * Hkv_ * G_ * D_ * el \
            + B * nv * 4 + B * 4
        n_sets = n_sets_for(nbytes)
        qs = [rand(B, Hkv_, G_, D_) for _ in range(n_sets)]
        ks = [rand(B, nv, Hkv_, D_) for _ in range(n_sets)]
        vs = [rand(B, nv, Hkv_, D_) for _ in range(n_sets)]
        khs = [k.transpose(1, 2).contiguous() for k in ks]
        vhs = [v.transpose(1, 2).contiguous() for v in vs]
        kvp = torch.arange(nv, dtype=torch.int32, device=dev).expand(
            B, nv).contiguous()
        qp = torch.full((B,), nv + 1, dtype=torch.int32, device=dev)
        rows.append(kernel_row(
            "decode_attention_bhsd", dtype,
            f"B={B} S={nv} all valid, cache read in place (VLM cross step)",
            lambda i: dk.decode_attention_bshd(qs[i], ks[i], vs[i], kvp, qp),
            lambda i: ref.ref_decode_attention(qs[i], khs[i], vhs[i], kvp,
                                               qp),
            lambda i: F.scaled_dot_product_attention(
                qs[i].reshape(B, Hkv_ * G_, 1, D_), khs[i], vhs[i],
                enable_gqa=True),
            n_sets, bound_ms(nbytes, 4 * D_ * Hkv_ * G_ * B * nv, dtype),
            timed=False))
        del qs, ks, vs, khs, vhs
        torch.cuda.empty_cache()


def logit_gap(cfg, params, mcfg, mparams, tokens, vision):
    """(max |merged - source| logit, max |source logit|) of one prompt's
    last position, the kernels' forward."""
    import torch
    from repro_torch.models import forward_seq
    x = torch.as_tensor(tokens, device="cuda")[None]
    v = torch.as_tensor(vision, device="cuda")[None]
    a, _, _ = forward_seq(params, cfg, x, vision=v, impl="cuda")
    b, _, _ = forward_seq(mparams, mcfg, x, vision=v, impl="cuda")
    a, b = a[0, -1, :cfg.vocab_size], b[0, -1, :cfg.vocab_size]
    return float((a - b).abs().max()), float(a.abs().max())


def block_rms(cfg, params, tokens, vision):
    """The source stream's RMS after each block on one prompt (the
    kernels' forward): where a calibrated random skipless stack leaves
    its O(1) regime."""
    import torch
    from repro_torch.models import block_sequence
    from repro_torch.models.transformer import apply_block_seq, embed_inputs
    x = torch.as_tensor(tokens, device="cuda")[None]
    h = embed_inputs(params, cfg, x)
    ctx = {"positions": torch.arange(x.shape[1], device="cuda")[None],
           "impl": "cuda",
           "vision": torch.as_tensor(vision, device="cuda")[None].to(h.dtype)}
    out = []
    for kind, lp, _ in block_sequence(params, cfg):
        h, _, _, _ = apply_block_seq(lp, cfg, h, ctx, kind)
        out.append(float(h.float().pow(2).mean().sqrt()))
    return out


def vlm_path(summary):
    """Llama-3.2-Vision-11B at full width (40 layers, d 4096, GQA 32/8 of
    128, d_ff 14336, vocab 128,256, a cross-attention layer every 5th over
    1600 vision tokens), skipless from seed 0, and its qp merge (the cross
    layers keep wk/wv, P folds into their FFN); the Mistral path's four
    prompt lengths, each with its own seeded (1600, 4096) vision array, 16
    new tokens each, the dense cache:

    * ``VLM_EQ_LAYERS`` calibrated layers in float32 (10: two groups, so
      the cross -> next-self fold is exercised; if merged != source there,
      the first mismatch and its logit margin are printed and 5 are
      tried): merged == source greedy streams, exact launch counts, the
      kernels' prefill logits against the plain forward (1e-4 of the
      logit scale); ``ScheduledEngine`` and the paged pools refuse vision;
    * 40 layers in bfloat16: exact launch counts (per prefill 40 generic
      flash launches, 8 of them non-causal over the vision tokens; per
      decode step 32 merged + 8 generic decode launches merged, 40
      generic source), merged tok/s and TTFT (one run), decode-step
      profiles of both, peak device memory."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import removed_weight_count, weight_table
    from repro_torch.serving import (Engine, Request, ScheduledEngine,
                                     ServeConfig)

    max_new, lens = 16, (16, 37, 100, 250)
    n = len(lens)
    out = {}
    with torch.no_grad():
        for L in VLM_EQ_LAYERS:
            cfg, params, mcfg, mparams = build(L, True, VLM_ARCH)
            rng = np.random.default_rng(5)
            prompts = [rng.integers(0, cfg.vocab_size, m) for m in lens]
            vision = [rng.standard_normal(
                (cfg.n_vision_tokens, cfg.d_model), np.float32)
                for _ in lens]
            got = {}
            for tag, c, p, merged in (("source", cfg, params, False),
                                      ("merged", mcfg, mparams, True)):
                eng, res, counts, _ = serve(c, p, prompts, max_new,
                                            vision=vision)
                check_counts(f"{VLM_ARCH} {tag} float32 ({L} layers)",
                             counts, eng, L, n, merged)
                got[tag] = streams(res)
            if got["merged"] == got["source"]:
                break
            bad = first_mismatch(cfg, params, prompts, got["source"],
                                 got["merged"], vision)
            # the logit gap there, and on the calibration prompt (whose
            # layers are O(1) by construction): a broken fold would show on
            # both, float32 drift through a chaotic stack on the first only
            crng = np.random.default_rng(1)
            calib = (crng.integers(0, cfg.vocab_size, 64),
                     crng.standard_normal((cfg.n_vision_tokens, cfg.d_model),
                                          np.float32))
            i, j = bad[0], bad[1]
            at = (np.concatenate([prompts[i], np.asarray(got["source"][i][:j],
                                                         np.int64)]),
                  vision[i])
            gaps = {name: logit_gap(cfg, params, mcfg, mparams, *x)
                    for name, x in (("mismatch", at), ("calibration", calib))}
            log(f"  {VLM_ARCH} ({L} layers, float32): merged and source "
                f"greedy streams differ: prompt {i}, position {j}, source "
                f"top-2 margin {bad[2]:.3g}; max |merged - source logit| / "
                f"max |logit| there {gaps['mismatch'][0]:.3g} / "
                f"{gaps['mismatch'][1]:.3g}, on the calibration prompt "
                f"{gaps['calibration'][0]:.3g} / {gaps['calibration'][1]:.3g}")
            rms = block_rms(cfg, params, *at)
            log(f"  the source stream's RMS after each block there: "
                + ", ".join(f"{r:.3g}" for r in rms))
            out[f"gap_{L}_layers"] = gaps
            out[f"rms_{L}_layers"] = rms
            if L == VLM_EQ_LAYERS[-1]:
                raise AssertionError(f"{VLM_ARCH}: merged != source at {L} "
                                     f"layers")
            del params, mparams, eng, p
            torch.cuda.empty_cache()
        rel = kernels_vs_plain(f"{VLM_ARCH} source", cfg, params, prompts[3],
                               1e-4, vision[3])
        rel_m = kernels_vs_plain(f"{VLM_ARCH} merged", mcfg, mparams,
                                 prompts[3], 1e-4, vision[3])
        removed = removed_weight_count(params, mparams)
        if removed != weight_table(cfg)["removed"]:
            raise AssertionError(f"{VLM_ARCH}: the merge removed "
                                 f"{removed:,d} weights, the table says "
                                 f"{weight_table(cfg)['removed']:,d}")
        sc = ServeConfig(n_slots=4, max_len=512)
        for fn in (lambda: ScheduledEngine(mcfg, mparams, sc, impl="cuda",
                                           device="cuda").submit(
                Request(prompt=prompts[0]), vision=vision[0]),
                lambda: Engine(mcfg, mparams, sc, impl="cuda",
                               cache="paged", device="cuda"),
                lambda: Engine(mcfg, mparams, sc, impl="cuda",
                               device="cuda").submit(
                    Request(prompt=prompts[0]))):
            try:
                fn()
            except ValueError as e:
                log(f"  refused, as in the reference: {e}")
            else:
                raise AssertionError(f"{VLM_ARCH}: a vision refusal did not "
                                     f"raise")
        log(f"  {VLM_ARCH} ({L} layers, float32): merged == source "
            f"{[x[:6] for x in got['source']]} …; the merge removed "
            f"{removed:,d} weights = weight_table's")
        out.update(eq_layers=L, plain_vs_kernels_rel_f32=rel,
                   plain_vs_kernels_rel_f32_merged=rel_m)
        del params, mparams, eng, p
        torch.cuda.empty_cache()

        L = get_config(VLM_ARCH).n_layers
        torch.cuda.reset_peak_memory_stats()
        cfg, params, mcfg, mparams = build(L, False, VLM_ARCH,
                                           dtype="bfloat16")
        models = (("source", cfg, params, False),
                  ("merged", mcfg, mparams, True))
        for tag, c, p, merged in models:
            eng, res, counts, _ = serve(c, p, prompts, max_new,
                                        vision=vision)
            check_counts(f"{VLM_ARCH} {tag} bfloat16 dense ({L} layers)",
                         counts, eng, L, n, merged)
            summary["launches"] = {k: summary["launches"][k] + counts[k]
                                   for k in KERNELS}
        serve(mcfg, mparams, prompts, max_new, vision=vision)  # warm-up
        eng, res, counts, wall = serve(mcfg, mparams, prompts, max_new,
                                       vision=vision)
        if not all(0 <= t < mcfg.vocab_size for o in res for t in o):
            raise AssertionError(f"{VLM_ARCH}: out-of-vocab ids")
        out["bf16"] = report(f"{VLM_ARCH} merged bfloat16, dense cache ({L} "
                             f"layers, 1600 vision tokens a request)", res,
                             wall)
        profs = {tag: profile_decode(c, p, prompts, "dense", vision=vision)
                 for tag, c, p, _ in models}
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {VLM_ARCH} bfloat16 ({L} layers): peak device memory "
            f"{peak:.1f} GB (source and merge resident together)")
        out.update(layers=L, peak_gb=peak, decode_profile=profs["merged"],
                   decode_profile_source=profs["source"])
        del models, params, mparams, p, c, eng
        torch.cuda.empty_cache()
    summary["vlm"] = out


def audio_path(summary):
    """HuBERT-XLarge at full width (48 layers, d 1280, MHA 16 of D 80,
    d_ff 5120, GeLU MLP, conv positional embedding of width 128), an
    encoder: no cache, no engine; seeded frame embeddings stand in for the
    conv feature extractor, as in the reference.

    * 4 calibrated layers in float32, B 2 x 250 frames: the qp, kp and vp
      merges' logits against the source's, and the kernels' forward
      against the plain forward, within ``AUDIO_TOL`` of the logit scale;
      each forward launches the generic flash kernel (non-causal, D 80)
      once per layer and nothing else;
    * 48 layers in bfloat16, B 4 x 1000 frames (``AUDIO_FRAMES``): 48 row-1
      launches per forward, exactly; the source's and the qp merge's
      forward profiled (device ms, busy share, launches)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import merge_skipless
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import forward_seq

    out = {}

    def forward(c, p, frames, impl="cuda"):
        reset_launch_counts()
        lg, _, _ = forward_seq(p, c, frames, impl=impl)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: 0 for k in KERNELS}
        if impl == "cuda":
            want["flash_attention_bhsd"] = c.n_layers
        if counts != want:
            raise AssertionError(f"{c.name} forward: launch counts {counts} "
                                 f"!= {want}")
        if not torch.isfinite(lg).all() or lg.shape[:2] != frames.shape[:2]:
            raise AssertionError(f"{c.name}: bad logits {lg.shape}")
        return lg, counts

    with torch.no_grad():
        cfg, params, mcfg, mparams = build(EQ_LAYERS, True, AUDIO_ARCH)
        frames = torch.as_tensor(np.random.default_rng(6).standard_normal(
            (2, 250, cfg.d_model), np.float32), device="cuda")
        ref_lg, _ = forward(cfg, params, frames)
        scale = float(ref_lg.abs().max())
        errs = {}
        for v in ("qp", "kp", "vp"):
            mp, mc = (mparams, mcfg) if v == "qp" else \
                merge_skipless(params, cfg, v)
            lg, _ = forward(mc, mp, frames)
            errs[v] = float((lg - ref_lg).abs().max()) / scale
            del mp
        plain, _ = forward(cfg, params, frames, impl="torch")
        errs["kernels_vs_plain"] = float((ref_lg - plain).abs().max()) / scale
        log(f"  {AUDIO_ARCH} ({EQ_LAYERS} layers, float32, B 2 x 250 "
            f"frames): max |logit diff| / logit scale {scale:.3g}: "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (gate {AUDIO_TOL:g})")
        if not 0 < scale or any(e > AUDIO_TOL for e in errs.values()):
            raise AssertionError(f"{AUDIO_ARCH}: merges or kernels beyond "
                                 f"{AUDIO_TOL:g} of the logit scale: {errs}")
        out.update(eq_layers=EQ_LAYERS, rel_err_f32=errs)
        del params, mparams, frames, ref_lg, plain
        torch.cuda.empty_cache()

        L = get_config(AUDIO_ARCH).n_layers
        cfg, params, mcfg, mparams = build(L, False, AUDIO_ARCH,
                                           dtype="bfloat16")
        frames = torch.as_tensor(np.random.default_rng(7).standard_normal(
            AUDIO_FRAMES + (cfg.d_model,), np.float32),
            device="cuda").to(torch.bfloat16)
        for tag, c, p in (("source", cfg, params), ("merged", mcfg, mparams)):
            _, counts = forward(c, p, frames)
            summary["launches"] = {k: summary["launches"][k] + counts[k]
                                   for k in KERNELS}
            out[f"forward_profile_{tag}"] = profiled(
                f"forward profile, {AUDIO_ARCH} {tag}, bfloat16 ({L} layers, "
                f"B {AUDIO_FRAMES[0]} x {AUDIO_FRAMES[1]} frames)",
                lambda: forward_seq(p, c, frames, impl="cuda"), 3)
        out["layers"] = L
        del params, mparams, frames
        torch.cuda.empty_cache()
    summary["audio"] = out


# ---------------------------------------------------------------------------
# training: the port's train step on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "llama3.2-1b"
# (a) the Trainer at full width and depth on SyntheticLM
TRAIN_RUN = dict(batch=8, seq_len=1024, steps=30, log_every=5, lr=3e-4,
                 warmup=5)
TRAIN_TIMED_FROM = 5  # the median step time is taken over steps 6-30
# the profiled step's kernels by kind: float32 GEMMs on FMA units (the
# tied unembedding multiplies in the float32 table's dtype, the plain
# attention core's Q K^T in float32; TF32 off), the other GEMMs (bf16),
# softmax, and elementwise kernels
TRAIN_KERNEL_GROUPS = (("f32_gemm", ("sgemm", "f32f32_f32f32")),
                       ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                       ("softmax", ("softmax",)),
                       ("elementwise", ("elementwise",)))
# (b) a trained skipless Mistral-7B stack, merged and served: the depths
# tried in turn (float32 must hold merged == source on the trained stack)
TRAIN_EQ_LAYERS = (4, 2)
TRAIN_MERGE = dict(batch=4, seq_len=256, steps=20, lr=1e-4)
# (c) every family's train step on the card against the CPU
TRAIN_STYLES = ("standard", "skipless", "skipless_merged", "residual_qpfree")
TRAIN_TOL = 1e-5  # loss and updated params: of their scale
# the gradients that reach the optimizer: of each leaf's largest (the
# port's CPU gradients sit within 1.3e-5 of jax.grad's on these stacks)
TRAIN_GRAD_TOL = 1e-4


def train_path(summary):
    """Training through ``repro_torch.training`` on the card (the step
    runs the plain PyTorch forward and its autograd backward: the kernels
    have no backward, and the reference trains through its XLA cores):

    (a) ``train_llama``: Llama-3.2-1B whole (16 layers, d 2048, 32/8 of
        64, vocab 128,256, tied) in the paper's trainable Q/P-free style
        (``residual_qpfree``, Fig. 4), bf16 compute over float32 params,
        AdamW, remat, B 8 x S 1024 of ``SyntheticLM``, 30 ``Trainer``
        steps: every logged loss finite and the last below the first by
        more than 0.02; step time, tokens/s, model FLOPs share, peak
        memory, the final checkpoint's size and write time, and one
        profiled step with remat True, False and "dots";
    (b) ``train_merge_serve``: a skipless Mistral-7B at full width and 4
        calibrated float32 layers trained 20 steps, saved and restored
        bit for bit through ``training.checkpoint``, merged
        (``merge_skipless(..., "qp")``) and served with its source
        through the kernels on the dense cache: identical greedy streams,
        exact launch counts (rows 1 and 4 for the source, 2 and 5 for the
        merge), else the first mismatch and per-block RMS and 2 layers;
    (c) ``train_card_vs_cpu``: one ``make_train_step`` of every arch at
        ``reduce_config`` in every style it admits (and ``grad_accum=2``
        in its standard style) on the card and on the CPU from the same
        params and batch: loss and updated params within ``TRAIN_TOL``
        of their scale, the gradients within ``TRAIN_GRAD_TOL``."""
    summary["train"] = {"llama": train_llama(),
                        "merge": train_merge_serve(summary),
                        "card_vs_cpu": train_card_vs_cpu()}


MESH_TRAIN_STEPS = 5
MESH_TRAIN_RTOL = 1e-6


# the dry run's placed cells on the card's host: one of each kind on both
# production meshes, among them heads a model axis of 16 does not divide
# (Qwen2.5-32B's 40 and 8 kv, Hymba's 25 and 5, Phi-3.5-MoE's 8 kv
# heads and its expert dispatch), and the two cells this host's PyTorch
# (2.11) refused before the cores and the encoder's convolution ran on
# local tensors (HuBERT-XLarge's train step, Moonshot's MHA decode over
# split heads); the full placed run is ``--all``'s
DRYRUN_PLACED = ("llama3.2-1b:train_4k,qwen2.5-32b:prefill_32k,"
                 "phi3.5-moe-42b-a6.6b:decode_32k,hymba-1.5b:long_500k,"
                 "hubert-xlarge:train_4k,moonshot-v1-16b-a3b:decode_32k")


def start_dryrun():
    """``repro_torch.launch.dryrun`` on the host's CPU, no card, in two
    subprocesses of three workers each: every cell's meta-only record
    (``--all --both-meshes --no-analysis``) and the placed record of
    ``DRYRUN_PLACED`` on both meshes.  Started before the dense-config
    phase so that they run beside the card's phases; ``mesh_path``
    collects them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    runs = {"meta": ["--all", "--no-analysis"],
            "placed": ["--cells", DRYRUN_PLACED]}
    return {name: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *how,
         "--both-meshes", "--jobs", "3", "--out",
         os.path.join(ROOT, "build", "dryrun_" + name)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, how in runs.items()}


def collect_dryrun(dry):
    """The two dry runs' cell counts (each given what is left of 600
    seconds); a failing cell, a failing run or a run cut at the cap
    fails the phase."""
    deadline = time.perf_counter() + 600
    out = {}
    for name, proc in dry.items():
        try:
            text, _ = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        lines = text.splitlines()
        counts = json.loads(lines[-1])["dryrun_cells"] if lines and \
            lines[-1].startswith("{") else None
        for ln in lines:
            if "FAIL" in ln or (name == "placed" and ln.startswith("[")):
                log(f"  dryrun {name} {ln}")
        log(f"  dryrun {name} --both-meshes (meta device, subprocess): "
            f"{counts}; exit {proc.returncode}")
        if proc.returncode != 0 or counts is None or counts["failed"]:
            raise AssertionError(f"the {name} dry run failed: exit "
                                 f"{proc.returncode}, {counts}; last lines "
                                 f"{lines[-5:]}")
        out[name] = counts
    if out["placed"]["run"] != 2 * len(DRYRUN_PLACED.split(",")):
        raise AssertionError(f"placed dry run: {out['placed']}")
    return out


def mesh_path(summary, dry):
    """The distribution layer on the card, at world size 1 over NCCL (the
    process group's rendezvous file under ``build/``), on a (1, 1)
    ("data", "model") ``DeviceMesh``:

    (a) merged skipless Mistral-7B, full width, 32 layers, bf16, served on
        the dense cache by ``Engine(mesh=)`` with ``impl="cuda"``: greedy
        streams and the launch counts of rows 2 and 5 equal the engine's
        without a mesh on the path phase's prompts; meshed and unmeshed
        tok/s side by side (one run each, after a warm-up each); then the
        same model on the paged pool (rows 2 and 7) and the int8 pool
        (rows 3 and 9): streams and launch counts equal the unmeshed
        engine's, tok/s side by side (one run each, no warm-up of their
        own: the path phase ran these kernels);
    (b) ``ScheduledEngine(mesh=)`` on the paged pool with
        ``SCHED_STARVED_PAGES`` pages and the path phase's prompts plus a
        repeat of the longest (a shared prefix): its streams, launch
        counts, deferrals and preemptions equal the unmeshed scheduler's;
    (c) merged == source greedy streams at 4 calibrated float32 layers on
        the mesh, on the dense cache and on the paged pool (rows 1, 2, 6
        and 7);
    (d) ``Trainer(mesh=)`` on Llama-3.2-1B whole for ``MESH_TRAIN_STEPS``
        steps: its losses equal the unmeshed trainer's within
        ``MESH_TRAIN_RTOL`` relative;
    (e) the host syncs of one decode step on the paged and on the int8
        pool, meshed and unmeshed (``sync_counted``, which leaves PyTorch's
        trace hooks on, so it runs after the timed parts): equal;
    (f) the dry runs ``dry`` (``start_dryrun``, running on the host's CPU
        since the dense-config phase; ``collect_dryrun``): the counts of
        cells run, skipped and failed; a failure fails the phase."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh

    pg = os.path.join(ROOT, "build", "mesh_pg")
    if os.path.exists(pg):
        os.remove(pg)
    out = {}
    try:
        dist.init_process_group("nccl", init_method="file://" + pg, rank=0,
                                world_size=1)
        mesh = make_mesh((1, 1), ("data", "model"))
        log(f"mesh {mesh}")
        t0 = time.perf_counter()
        out["serve"] = mesh_serve(mesh)
        out["serve_s"] = time.perf_counter() - t0
        out["train"] = mesh_train(mesh)
        t0 = time.perf_counter()
        out["paged_step_syncs"] = mesh_paged_syncs(mesh)
        out["paged_s"] = out["serve"].pop("paged_s") + \
            time.perf_counter() - t0
        log(f"  mesh phase: serving {out['serve_s']:.1f} s, of which the "
            f"paged pools' checks with their syncs {out['paged_s']:.1f} s")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        if os.path.exists(pg):
            os.remove(pg)
        out["dryrun"] = collect_dryrun(dry)
    summary["mesh"] = out


MODEL_AXIS_TIMEOUT = 600  # seconds the two ranks of the model-axis phase get
# new tokens a request of the model-axis phase: a decode step on
# DTensors takes ~40 ms of host time per layer (over a second at 32)
MODEL_AXIS_NEW = 8
# the model-axis phase's scheduler: chunks of 256 (each chunk on DTensors
# costs host time per layer, whatever its length)
MODEL_AXIS_SCHED = dict(token_budget=512, chunk_tokens=256)
# the model-axis phase's pools: 32 pages, of which its four requests take
# 29, so that each rank's part of a model axis of 2 or 4 holds pages the
# requests attend (the default pool's 128 pages would keep them all in
# rank 0's part)
MODEL_AXIS_PAGES = 32


def pool_size(cache) -> dict:
    """``serve`` keywords of the model-axis phase for ``cache``."""
    return {} if cache == "dense" else {"n_blocks": MODEL_AXIS_PAGES}


def gloo_cuda_all_gather() -> None:
    """Route DTensor's functional all-gather (``funcol.all_gather_tensor``)
    through c10d's ``all_gather_into_tensor`` on the same group.  Gloo
    carries CUDA tensors for c10d's all-reduce, broadcast, all-gather,
    reduce-scatter and all-to-all in the card's PyTorch build, but the
    functional all-gather that DTensor's Shard -> Replicate
    redistributions run segfaults in its ``wait_tensor`` there (the
    functional all-reduce does not).  NCCL, across cards, needs no such
    shim; it changes where the gathered bytes travel, not what arrives."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.distributed_c10d as c10d

    def all_gather_tensor(self, gather_dim, group, tag=""):
        pg = c10d._resolve_process_group(funcol._resolve_group_name(group,
                                                                     tag))
        n = pg.size()
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out

    funcol.all_gather_tensor = all_gather_tensor


def model_axis_path(summary, meanwhile=None):
    """The kernel route on a mesh whose model axis is 2, on the one card:
    two processes (``python3 chip_smoke.py --model-axis-rank R``, R 0 and
    1) in a gloo process group (rendezvous file ``build/model_axis_pg``;
    NCCL will not put two ranks on one device), a (1, 2) ("data",
    "model") ``DeviceMesh`` on CUDA, DTensor's all-gather routed through
    c10d's (``gloo_cuda_all_gather``).  Each rank (``model_axis_rank``):

    (a) at ``EQ_LAYERS`` calibrated float32 layers, merged skipless
        Mistral-7B at full width and its source served by
        ``Engine(mesh=, impl="cuda")`` on the dense cache, the paged pool
        and the int8 pool, ``MODEL_AXIS_NEW`` new tokens a request
        (``model_axis_f32``): on the fp caches greedy streams equal the
        unmeshed engine's and merged == source; on the int8 pool the
        cause of the streams' parting is shown and the int8 prefill and
        split-K decode are gated in float32 (``q8_on_the_mesh``);
    (b) at 32 bfloat16 layers, the merged model through ``Engine`` and
        ``ScheduledEngine`` on the three caches, ``MODEL_AXIS_NEW`` new
        tokens a request: each rank's launches are
        the unmeshed engine's, one flash (rows 2, 2, 3) per layer and
        prefill, one decode (rows 5, 7, 9, in the partial-state mode) per
        layer and step; the tokens each stream shares with the unmeshed
        engine's before they part (bf16: the model axis's row-parallel
        sums round in another order);
    (c) at those 32 bfloat16 layers, ``build_step``'s prefill and decode
        steps (``impl="cuda"``, ``MODEL_AXIS_STEPS``; the functions the dry
        run runs, on a dense cache) under the collective counter
        (``distribution.collectives.StepCounter``): each op's count and
        bytes equal on both ranks and equal to the dry run's prediction
        for the same step, config, batch, mesh and route, computed by
        rank 0 in subprocesses over fake groups (``start_prediction``);
        and, as information, the collectives of one more ``Engine``
        decode step on each cache and the seconds inside them.
    The phase fails if a rank exits non-zero; the ranks' launch counts
    join the summary's.  ``meanwhile(summary)``, a phase that measures no
    time (the lint), runs in this process while the ranks run, its
    seconds recorded under its name."""
    import torch

    torch.cuda.empty_cache()
    pg = os.path.join(ROOT, "build", "model_axis_pg")
    if os.path.exists(pg):
        os.remove(pg)
    procs = []
    for r in range(2):
        log_path = os.path.join(ROOT, "build", f"model_axis_{r}.log")
        procs.append((r, log_path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--model-axis-rank",
             str(r)], cwd=ROOT, stdout=open(log_path, "w"),
            stderr=subprocess.STDOUT)))
    try:
        if meanwhile is not None:
            t0 = time.perf_counter()
            meanwhile(summary)
            summary["phase_s"][meanwhile.__name__] = time.perf_counter() - t0
            log(f"{meanwhile.__name__} (beside the model-axis ranks): "
                f"{summary['phase_s'][meanwhile.__name__]:.1f} s")
    finally:  # the ranks end either way
        codes = wait_ranks(procs)
    if os.path.exists(pg):
        os.remove(pg)
    for r, log_path, _ in procs:
        for ln in open(log_path).read().splitlines():
            if r == 0 or codes[r] != 0:
                log(f"  [rank {r}] {ln}")
    if codes != [0, 0]:
        raise AssertionError(f"model-axis phase: the ranks exited {codes}")
    res = [json.load(open(os.path.join(ROOT, "build",
                                       f"model_axis_{r}.json")))
           for r in range(2)]
    if res[0]["streams"] != res[1]["streams"]:
        raise AssertionError("model-axis phase: the two ranks emitted "
                             "different tokens")
    for kind, c in res[0]["collectives"].items():
        if any(c[k] != res[1]["collectives"][kind][k] for k in
               ("counts", "per_op_bytes", "total_bytes", "by_link")):
            raise AssertionError(f"model-axis phase: the ranks' {kind} "
                                 f"collectives differ: {c} != "
                                 f"{res[1]['collectives'][kind]}")
        _, B, S = MODEL_AXIS_STEPS[kind]
        log(moved_line(f"(1, 2) mesh, merged bfloat16 32 layers, "
                       f"build_step {kind} (B {B}, S {S}, impl cuda), rank "
                       f"0 == rank 1 == the dry run's prediction", c))
    for cache, c in res[0]["engine_step"].items():
        log(moved_line(f"(1, 2) mesh, Engine decode step, {cache}, rank 0",
                       c))
    summary["launches"] = {k: summary["launches"][k] + sum(
        x["launches"][k] for x in res) for k in summary["launches"]}
    summary["model_axis"] = {k: v for k, v in res[0].items()
                             if k not in ("streams", "launches")}


def wait_ranks(procs):
    """The ranks' exit codes, each given ``MODEL_AXIS_TIMEOUT`` seconds
    (killed past it)."""
    codes = []
    for r, log_path, p in procs:
        try:
            codes.append(p.wait(timeout=MODEL_AXIS_TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes


# ``build_step``'s steps each rank of the model-axis phase runs under the
# collective counter: kind -> (dry-run cell, batch, prompt or cache length)
MODEL_AXIS_STEPS = {"prefill": ("prefill_32k", 2, 256),
                    "decode": ("decode_32k", 2, 512)}


def axis_config():
    """The merged bfloat16 Mistral-7B of the model-axis phase's 32 layers:
    what ``build(32, calibrate=False, dtype="bfloat16")`` merges to."""
    from repro_torch.configs import get_config
    return get_config("mistral-7b").with_(
        block_style="skipless_merged", merged_variant="qp", n_layers=32,
        dtype="bfloat16", param_dtype="bfloat16")


def start_prediction(mesh="1x2", steps=None):
    """The dry run's record of each ``steps`` step (kind -> (cell, batch,
    length); default ``MODEL_AXIS_STEPS``) of ``axis_config()`` on a
    ``mesh`` ("DxM") with ``impl="cuda"`` (``python -m
    repro_torch.launch.dryrun ... --mesh 1x2 --impl cuda``): subprocesses
    over fake groups of their own, on the host's CPU, no card.  Returns
    them by kind; ``predicted`` reads them."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg, full = axis_config(), get_config("mistral-7b")
    over = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if getattr(cfg, f.name) != getattr(full, f.name)}
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return {kind: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mistral-7b", "--shape", cell, "--mesh", mesh, "--impl", "cuda",
         "--batch", str(B), "--seq-len", str(S), "--overrides",
         json.dumps(over), "--print-record"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for kind, (cell, B, S) in (steps or MODEL_AXIS_STEPS).items()}


def predicted(procs):
    """Each prediction's collectives (``start_prediction``), by kind."""
    out = {}
    for kind, proc in procs.items():
        text, _ = proc.communicate(timeout=MODEL_AXIS_TIMEOUT)
        lines = text.splitlines()
        if proc.returncode != 0:
            raise AssertionError(f"the {kind} prediction exited "
                                 f"{proc.returncode}: {lines[-20:]}")
        out[kind] = json.loads(lines[-2])[0]["collectives"]
    return out


def counted_steps(mcfg, placed, mesh, sizes=None):
    """``build_step``'s prefill and decode steps (``impl="cuda"``) of the
    merged model on this rank, at the ``sizes`` (default
    ``MODEL_AXIS_STEPS``), placed
    as the dry run places them (``dryrun.place_args``: the params as
    ``place_params`` placed them, the inputs, a dense cache from
    ``init_cache``), each under ``StepCounter``: its collectives, the
    seconds inside them and the step's wall seconds."""
    import torch
    from repro_torch.distribution import sharding as shd
    from repro_torch.distribution.collectives import StepCounter
    from repro_torch.distribution.placed import on_mesh
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import init_cache

    g = torch.Generator("cuda").manual_seed(5)

    def ids(*shape):
        return torch.randint(0, mcfg.vocab_size, shape, generator=g,
                             device="cuda", dtype=torch.int32)

    out = {}
    for kind, (_, B, S) in (sizes or MODEL_AXIS_STEPS).items():
        args = (placed, {"inputs": ids(B, S)}) if kind == "prefill" else \
            (placed, ids(B), init_cache(mcfg, B, S, device="cuda"))
        args = dryrun.place_args(mcfg, kind, args, mesh,
                                 shd.make_rules(mesh, batch=B))
        fn, _ = steps.build_step(mcfg, kind, impl="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with on_mesh(mesh), StepCounter() as c:
            fn(*args)
        torch.cuda.synchronize()
        out[kind] = dict(c.collectives(), comm_s=c.comm_s,
                         wall_s=time.perf_counter() - t0)
        del args
        torch.cuda.empty_cache()
    return out


def engine_step_collectives(eng):
    """One more decode step of ``eng`` after its run (every request done:
    the step writes rows no request reads) under ``StepCounter``: its
    collectives, the seconds inside them and the step's wall seconds."""
    import torch
    from repro_torch.distribution.collectives import StepCounter
    from repro_torch.distribution.placed import on_mesh

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with on_mesh(eng.mesh), StepCounter() as c:
        eng._decode(eng._last_token, eng.kv.device_cache())
    torch.cuda.synchronize()
    return dict(c.collectives(), comm_s=c.comm_s,
                wall_s=time.perf_counter() - t0)


def moved_line(tag, c, backend="gloo"):
    """One log line of a counted step's collectives (over ``backend``)."""
    ops = ", ".join(f"{k} {n} ({c['per_op_bytes'][k]} B)"
                    for k, n in c["counts"].items() if n)
    return (f"  {tag}: {ops or 'none'}; total {c['total_bytes']} B, by "
            f"link {c['by_link']}; {c['comm_s'] * 1e3:.1f} ms inside the "
            f"{backend} collectives of a {c['wall_s'] * 1e3:.1f} ms step")


def model_axis_rank(rank: int) -> int:
    """One rank of ``model_axis_path``; writes ``build/model_axis_<rank>
    .json``: its checks' results, the streams it emitted and its launch
    counts."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import make_mesh

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # rank 0 holds this rank's counts against the dry run's prediction,
    # computed meanwhile on the host's CPU
    prediction = start_prediction() if rank == 0 else None
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        ROOT, "build", "model_axis_pg"), rank=rank, world_size=2)
    gloo_cuda_all_gather()
    try:
        mesh = make_mesh((1, 2), ("data", "model"))
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, 32000, n) for n in (16, 37, 100, 250)]
        out = {"rank": rank, "streams": {}}
        t0 = time.perf_counter()
        with torch.no_grad():
            out["f32"] = model_axis_f32(mesh, prompts, out["streams"])
            out["f32_s"] = time.perf_counter() - t0
            out.update(model_axis_bf16(mesh, prompts, out["streams"]))
        out["seconds"] = time.perf_counter() - t0
        if prediction is not None:
            want = predicted(prediction)
            prediction = None
            for kind, got in out["collectives"].items():
                for key in ("counts", "per_op_bytes", "total_bytes",
                            "by_link"):
                    if got[key] != want[kind][key]:
                        raise AssertionError(
                            f"{kind} step on the (1, 2) mesh: {key} moved "
                            f"{got[key]} != the dry run's {want[kind][key]}")
            out["predicted"] = want
        with open(os.path.join(ROOT, "build", f"model_axis_{rank}.json"),
                  "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()
        for proc in (prediction or {}).values():
            proc.kill()
            proc.communicate()
    return 0


def prefill_logits(sink):
    """A ``serve`` probe: each prefill's logits (the real vocabulary,
    gathered whole under a mesh) appended to ``sink``."""
    from repro_torch.distribution.placed import full

    def probe(eng):
        sample = eng._sample

        def recording(logits, slots, rows=None):
            if rows is None:
                sink.append(full(logits)[0, :eng.cfg.vocab_size].float())
            return sample(logits, slots, rows)

        eng._sample = recording
    return probe


MESH_LOGIT_RTOL = 1e-4  # meshed vs unmeshed float32 prefill logits, of
# the max |logit| (the fp caches measure ~1e-5: the row-parallel sums)
Q8_SCALE_RTOL = 1e-6  # an int8 scale's own rounding, of the scale


def place_params(params, mesh):
    """``params`` placed on ``mesh`` as ``Engine(mesh=)`` places them for
    4 slots: an engine given them places nothing again, so the engines of
    the model-axis phase share one placement (over gloo a placement moves
    the weights through host memory)."""
    from repro_torch.distribution import sharding as shd
    return shd.distribute_tree(params, shd.param_pspecs(
        params, shd.make_rules(mesh, batch=4)), mesh)


def prefill_gap(got, want) -> float:
    """Max |got - want| over ``prefill_logits`` records, of max |want|."""
    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))


def model_axis_f32(mesh, prompts, emitted, name="(1, 2)", want=None):
    """(a) of ``model_axis_path`` on the ``name``d mesh: per cache, the
    merged model served meshed and unmeshed, then the source meshed.  On
    the fp caches the meshed prefill logits are within ``MESH_LOGIT_RTOL``
    of the unmeshed engine's, the greedy streams equal, and the source's
    on the mesh equal the merged model's.  On the int8 pool a float32
    rounding difference (the model axis's row-parallel sums) moves some
    K/V values across an int8 rounding boundary, and the streams part
    where the unmeshed logits are near a tie: ``q8_on_the_mesh`` shows that
    cause and gates the int8 prefill and decode in float32 instead, for
    both models; the streams' agreement is reported.  ``want``: cache ->
    (streams, prefill logits) of the unmeshed merged engine computed
    elsewhere (``chip_smoke_4.py``'s reference), served here without it."""
    import torch

    cfg, params, mcfg, mparams = build(EQ_LAYERS, calibrate=True)
    placed, mplaced = place_params(params, mesh), place_params(mparams, mesh)
    n, res = len(prompts), {}
    for cache in ("dense", "paged"):
        got = []
        if want is None:
            ref = []
            _, plain, _, _ = serve(mcfg, mparams, prompts, MODEL_AXIS_NEW,
                                   cache=cache, probe=prefill_logits(ref),
                                   **pool_size(cache))
            plain = streams(plain)
        else:
            plain, ref = want[cache]
        eng, mrg, counts, _ = serve(mcfg, mplaced, prompts, MODEL_AXIS_NEW,
                                    cache=cache, mesh=mesh,
                                    probe=prefill_logits(got),
                                    **pool_size(cache))
        check_counts(f"merged float32 {cache}, {name} mesh", counts, eng,
                     EQ_LAYERS, n, merged=True)
        emitted[f"f32/{cache}"] = streams(mrg)
        gap = prefill_gap(got, [r.to(got[0].device) for r in ref])
        res[cache] = {"prefill_logit_gap": gap,
                      "agree_unmeshed": agreement(streams(mrg), plain)}
        if streams(mrg) != plain or not gap <= MESH_LOGIT_RTOL:
            bad = first_mismatch(mcfg, mparams, prompts, plain, mrg)
            raise AssertionError(f"{cache}: meshed and unmeshed float32 "
                                 f"streams differ at {bad} or the prefill "
                                 f"logit gap {gap:.3g} > {MESH_LOGIT_RTOL}")
        eng, src, counts, _ = serve(cfg, placed, prompts, MODEL_AXIS_NEW,
                                    cache=cache, mesh=mesh,
                                    **pool_size(cache))
        check_counts(f"source float32 {cache}, {name} mesh", counts, eng,
                     EQ_LAYERS, n, merged=False)
        if streams(src) != streams(mrg):
            bad = first_mismatch(cfg, params, prompts, src, mrg)
            raise AssertionError(f"{cache}: on the {name} mesh, merged "
                                 f"and source streams differ at {bad}")
        res[cache]["merged_eq_source"] = True
        log(f"  {name} mesh, float32 {EQ_LAYERS} layers, {cache}: prefill "
            f"logits within {gap:.3g} of the unmeshed engine's; meshed == "
            f"unmeshed and merged == source greedy streams")
    q8, out = {}, {}
    for tag, c, p, pl in (("merged", mcfg, mparams, mplaced),
                          ("source", cfg, params, placed)):
        q8[tag], out[tag] = q8_on_the_mesh(tag, c, p, pl, mesh, prompts,
                                           name)
    emitted["f32/paged_q8"] = out["merged"]
    q8["merged_vs_source_agree"] = agreement(out["merged"], out["source"])
    res["paged_q8"] = q8
    log(f"  {name} mesh, float32 {EQ_LAYERS} layers, paged_q8: merged vs "
        f"source tokens shared {q8['merged_vs_source_agree']} (of "
        f"{MODEL_AXIS_NEW} each; they part unmeshed too)")
    del params, mparams, placed, mplaced, eng
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def patched(obj, name, wrap):
    """``obj.<name>`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


@contextlib.contextmanager
def uncounted():
    """Kernel launches inside the block leave the launch counts as they
    were (a comparison's launches are not the path's)."""
    from repro_torch import kernels
    before = kernels.launch_counts()
    try:
        yield
    finally:
        for c in kernels._COUNTERS:
            for k in c:
                c[k] = before[k]


def q8_recorder(sink):
    """``patched`` wrapper of ``quant.q8_quantize_seq`` (the int8
    prefill's quantiser, called on whole K then V per layer): appends
    (float input after the padding mask, int8 output, scales) per call."""
    import torch

    def wrap(orig):
        def q8_quantize_seq(kv, block_size, valid=None):
            ints, scale = orig(kv, block_size, valid)
            x = kv.float() if valid is None else torch.where(
                valid[..., None, None], kv.float(), 0.0)
            sink.append((x, ints, scale))
            return ints, scale
        return q8_quantize_seq
    return wrap


def q8_replay(record):
    """``patched`` wrapper of ``quant.q8_quantize_seq`` returning, call by
    call, what another run's quantiser returned (``q8_recorder``'s
    ``record``), of the same shapes."""
    calls = iter(record)

    def wrap(orig):
        def q8_quantize_seq(kv, block_size, valid=None):
            ints, scale = orig(kv, block_size, valid)
            _, q, s = next(calls)
            if q.shape != ints.shape or s.shape != scale.shape:
                raise AssertionError(f"int8 replay: shapes {tuple(q.shape)}"
                                     f" {tuple(s.shape)} for "
                                     f"{tuple(ints.shape)} "
                                     f"{tuple(scale.shape)}")
            return q.clone(), s.clone()
        return q8_quantize_seq
    return wrap


def prefill_pages(sink, ids=None):
    """A ``serve`` probe on a paged engine: after each prefill, the pages
    its slot's table maps, gathered whole, (k, v, k_scale, v_scale) with
    the layers leading, and their ids added to ``ids``."""
    from repro_torch.distribution.placed import full

    def probe(eng):
        sample = eng._sample

        def recording(logits, slots, rows=None):
            if rows is None:
                pm = eng.pm
                idx = [int(b) for b in pm.tables[slots[0]] if b >= 0]
                if ids is not None:
                    ids.extend(idx)
                sink.append(tuple(full(t)[:, idx] for t in (
                    pm.k, pm.v, pm.k_scale, pm.v_scale)))
            return sample(logits, slots, rows)

        eng._sample = recording
    return probe


def probes(*ps):
    """Several ``serve`` probes as one."""
    def probe(eng):
        for p in ps:
            p(eng)
    return probe


def split_k_gate(sink):
    """``patched`` wrapper of ``models.attention._paged_on_mesh``: each
    meshed paged decode core's output (the partial-state kernel on this
    rank's pages, combined across the model axis) held against the
    whole-pool kernel on the gathered operands, i.e. what the unmeshed
    engine computes from the meshed engine's state, within
    ``TOL_F32`` of the largest |output| (at least 1); appends each call's
    max |error|.  The whole kernel's launches are not counted."""
    from repro_torch.distribution.placed import full, split_group

    def wrap(orig):
        def _paged_on_mesh(core, q, pools, block_tables, q_position, kw):
            if split_group(pools[0], 0) is None:
                raise AssertionError("the model axis does not split the "
                                     "pool's pages")
            out = orig(core, q, pools, block_tables, q_position, kw)
            with uncounted():
                want = core(full(q), *[full(p) for p in pools],
                            block_tables=full(block_tables),
                            q_position=full(q_position), **kw).float()
            err = float((full(out).float() - want).abs().max())
            tol = TOL_F32 * max(1.0, float(want.abs().max()))
            if not err <= tol:
                raise AssertionError(f"split-K paged decode on the mesh: "
                                     f"{err:.3g} from the whole-pool kernel "
                                     f"(tol {tol:.3g})")
            sink.append(err)
            return out
        return _paged_on_mesh
    return wrap


def q8_on_the_mesh(tag, cfg, params, placed, mesh, prompts,
                   name="(1, 2)"):
    """One model on the int8 pool in float32: served on the ``name``d
    mesh (where its model axis m is larger than 1, each decode core's
    split-K output gated by ``split_k_gate``, and the prefills' pages
    lie in each of the pool's m parts), then
    unmeshed twice: free, and with its quantiser replaying the meshed
    run's int8 values and scales.  Asserts (``q8_rounding_cause``) that
    each run's pool pages hold what its quantiser wrote, that equal float
    K/V quantise equal, and that where a request's float K/V first differ
    the int8 values differ by one step at most, each across a rounding
    boundary within the float gap, and each scale by no more than its
    page's float gap / 127 (and ``Q8_SCALE_RTOL`` of rounding);
    and that the replayed prefill logits are within ``MESH_LOGIT_RTOL`` of
    the meshed ones.  Returns (findings, meshed streams)."""
    from repro_torch.kernels import quant
    from repro_torch.models import attention

    n, merged = len(prompts), cfg.block_style == "skipless_merged"
    m = int(mesh.size(list(mesh.mesh_dim_names).index("model")))
    kw = dict(cache="paged_q8", **pool_size("paged_q8"))
    rec_m, pages_m, ids, lg_m, errs = [], [], [], [], []
    with patched(quant, "q8_quantize_seq", q8_recorder(rec_m)), \
            patched(attention, "_paged_on_mesh", split_k_gate(errs)) \
            if m > 1 else contextlib.nullcontext():
        eng, meshed, counts, _ = serve(
            cfg, placed, prompts, MODEL_AXIS_NEW, mesh=mesh,
            probe=probes(prefill_logits(lg_m), prefill_pages(pages_m, ids)),
            **kw)
    check_counts(f"{tag} float32 paged_q8, {name} mesh", counts, eng,
                 EQ_LAYERS, n, merged=merged)
    parts = sorted({m * i // MODEL_AXIS_PAGES for i in ids})
    if parts != list(range(m)):
        raise AssertionError(f"{tag} paged_q8: the prefills' pages lie in "
                             f"the parts {parts} of the pool's {m} only")
    del eng
    rec_u, pages_u, lg_u, lg_r = [], [], [], []
    with patched(quant, "q8_quantize_seq", q8_recorder(rec_u)):
        _, plain, _, _ = serve(cfg, params, prompts, MODEL_AXIS_NEW,
                               probe=probes(prefill_logits(lg_u),
                                            prefill_pages(pages_u)), **kw)
    with patched(quant, "q8_quantize_seq", q8_replay(rec_m)):
        _, replay, _, _ = serve(cfg, params, prompts, MODEL_AXIS_NEW,
                                probe=prefill_logits(lg_r), **kw)
    res = q8_rounding_cause(cfg.n_layers, n, rec_u, rec_m, pages_u, pages_m)
    res.update(
        prefill_logit_gap=prefill_gap(lg_m, lg_u),
        replayed_prefill_logit_gap=prefill_gap(lg_m, lg_r),
        split_k_calls=len(errs), split_k_max_abs_err=max(errs, default=0.0),
        agree_unmeshed=agreement(streams(meshed), streams(plain)),
        agree_replayed=agreement(streams(meshed), streams(replay)))
    if len(errs) != (m > 1) * cfg.n_layers * (MODEL_AXIS_NEW - 1) or \
            not res["replayed_prefill_logit_gap"] <= MESH_LOGIT_RTOL:
        raise AssertionError(f"{tag} paged_q8 on the mesh: {len(errs)} "
                             f"gated decode calls, replayed prefill logit "
                             f"gap {res['replayed_prefill_logit_gap']:.3g}")
    first = [c and (c["layer"], c["kv"], c["flips"], c["float_gap_rel"])
             for c in res["first_float_difference"]]
    log(f"  {name} mesh, float32 {EQ_LAYERS} layers, paged_q8, {tag}: "
        f"{res['int8_differing']:,d} of {res['int8_entries']:,d} prefill "
        f"int8 entries differ from the unmeshed run's (per layer "
        f"{res['int8_differing_per_layer']}, max step "
        f"{res['int8_max_step']}); per request, where the float K/V first "
        f"differ (layer, k/v, int8 flips, float gap of max |x|): {first}; "
        f"prefill logits within {res['prefill_logit_gap']:.3g} free, "
        f"{res['replayed_prefill_logit_gap']:.3g} with the meshed int8 "
        f"values replayed; split-K decode within "
        f"{res['split_k_max_abs_err']:.3g} of the whole-pool kernel over "
        f"{len(errs)} calls; tokens shared with the unmeshed engine "
        f"{res['agree_unmeshed']}, with the replayed one "
        f"{res['agree_replayed']} (of {MODEL_AXIS_NEW} each)")
    return res, streams(meshed)


def q8_rounding_cause(L, n_req, rec_u, rec_m, pages_u, pages_m):
    """The int8 prefills of an unmeshed (``_u``) and a meshed (``_m``) run
    from ``q8_recorder`` (2 calls per layer and request) and
    ``prefill_pages`` (one record per request): see ``q8_on_the_mesh``.
    Returns the counts and, per request, where its float K/V first differ
    (None if never)."""
    import torch

    if not (len(rec_u) == len(rec_m) == 2 * L * n_req and
            len(pages_u) == len(pages_m) == n_req):
        raise AssertionError(f"int8 prefills: {len(rec_u)} / {len(rec_m)} "
                             f"quantiser calls, {len(pages_u)} / "
                             f"{len(pages_m)} prefills")
    out = {"int8_entries": 0, "int8_differing": 0, "int8_max_step": 0,
           "int8_differing_per_layer": [0] * L, "first_float_difference": []}
    for r in range(n_req):
        first = None
        for i in range(2 * L * r, 2 * L * (r + 1)):
            layer, j = (i // 2) % L, i % 2
            where = f"request {r} layer {layer} {'kv'[j]}"
            for side, rec, pages in (("unmeshed", rec_u, pages_u),
                                     ("meshed", rec_m, pages_m)):
                _, q, s = rec[i]  # the bucket's pages; the table maps
                n = pages[r][j].shape[1]  # those the prompt fills
                if not (torch.equal(pages[r][j][layer], q[0].reshape(
                        s.shape[1], -1, *q.shape[2:])[:n]) and
                        torch.equal(pages[r][2 + j][layer], s[0, :n])):
                    raise AssertionError(f"{side} int8 pool, {where}: its "
                                         f"pages hold other values than "
                                         f"the quantiser wrote")
            (xu, qu, su), (xm, qm, sm) = rec_u[i], rec_m[i]
            diff = qu != qm
            step = int((qu.int() - qm.int()).abs().max())
            out["int8_entries"] += qu.numel()
            out["int8_differing"] += int(diff.sum())
            out["int8_differing_per_layer"][layer] += int(diff.sum())
            out["int8_max_step"] = max(out["int8_max_step"], step)
            if torch.equal(xu, xm):
                if diff.any() or not torch.equal(su, sm):
                    raise AssertionError(f"int8 prefill, {where}: equal "
                                         f"float K/V quantised differently")
                continue
            if first is not None:
                continue
            nb, Hkv = su.shape[1:]
            bs = qu.shape[1] // nb
            tu = xu / su.repeat_interleave(bs, dim=1)[..., None]
            tm = xm / sm.repeat_interleave(bs, dim=1)[..., None]
            gap = (tu - tm).abs()
            edge = (tu.abs() % 1 - 0.5).abs()  # distance to a boundary
            off = diff & ~(edge <= gap + 1e-6)
            # a scale (absmax / 127) moves at most its page's float gap
            # / 127, and one rounding
            dx = (xm - xu).abs().reshape(1, nb, bs, Hkv, -1).amax((2, 4))
            sgap = (sm - su).abs() - dx / 127 - 2 * Q8_SCALE_RTOL * su
            srel = float(((sm - su).abs() / su).max())
            if step > 1 or (sgap > 0).any() or off.any():
                raise AssertionError(
                    f"int8 prefill, {where} (the float K/V's first "
                    f"difference): step {step}, scales within {srel:.3g} "
                    f"({int((sgap > 0).sum())} past their page's float "
                    f"gap), {int(off.sum())} differing entries away from "
                    f"a rounding boundary")
            first = dict(layer=layer, kv="kv"[j], flips=int(diff.sum()),
                         float_gap_rel=float((xm - xu).abs().max()
                                             / xu.abs().max()),
                         scale_rel=srel, max_t_gap=float(gap.max()))
        out["first_float_difference"].append(first)
    return out


def model_axis_bf16(mesh, prompts, emitted):
    """(b) of ``model_axis_path``: the results and the meshed runs'
    launch counts.  The ranks build the model in turns (a build holds the
    source and its merge, ~28 GB): rank 1 builds while rank 0 serves the
    unmeshed references."""
    import torch
    import torch.distributed as dist

    # barrier 1: rank 0 has built (rank 1 starts its build); barrier 2:
    # rank 1 has built
    rank = dist.get_rank()
    if rank == 1:
        dist.barrier()
    mcfg, mparams = build(32, calibrate=False, dtype="bfloat16")[2:]
    torch.cuda.empty_cache()  # the source's bytes, for the peer
    dist.barrier()
    unmeshed = {c: serve(mcfg, mparams, prompts, MODEL_AXIS_NEW,
                         cache=c, **pool_size(c))[1:]
                for c in ("dense", "paged", "paged_q8")}
    if rank == 0:
        dist.barrier()
    if mcfg != axis_config():
        raise AssertionError(f"the model-axis phase's merged config is not "
                             f"the prediction's: {mcfg}")
    placed = place_params(mparams, mesh)
    del mparams
    torch.cuda.empty_cache()
    L, n = mcfg.n_layers, len(prompts)
    res = {"launches": {k: 0 for k in KERNELS}, "bf16": {},
           "collectives": counted_steps(mcfg, placed, mesh),
           "engine_step": {}}
    for cache in ("dense", "paged", "paged_q8"):
        plain, pcounts, pwall = unmeshed[cache]
        eng, meshed, counts, wall = serve(mcfg, placed, prompts,
                                          MODEL_AXIS_NEW, cache=cache,
                                          mesh=mesh, **pool_size(cache))
        check_counts(f"merged bfloat16 {cache}, (1, 2) mesh", counts, eng, L,
                     n, merged=True)
        if counts != pcounts:
            raise AssertionError(f"{cache}: meshed launches {counts} != "
                                 f"unmeshed {pcounts}")
        res["engine_step"][cache] = engine_step_collectives(eng)
        del eng  # its cache, before the next engine allocates its own
        torch.cuda.empty_cache()
        seng, sched, scounts, swall = serve(mcfg, placed, prompts,
                                            MODEL_AXIS_NEW, cache=cache,
                                            sched=MODEL_AXIS_SCHED,
                                            mesh=mesh, **pool_size(cache))
        check_sched_counts(f"merged bfloat16 {cache}, (1, 2) mesh",
                           scounts, seng, merged=True)
        del seng
        torch.cuda.empty_cache()
        for k in KERNELS:
            res["launches"][k] += counts[k] + scounts[k]
        emitted[f"bf16/{cache}"] = [streams(meshed), streams(sched)]
        res["bf16"][cache] = {
            "agree_unmeshed": agreement(streams(meshed), streams(plain)),
            "agree_sched": agreement(streams(sched), streams(meshed)),
            "unmeshed": report(f"merged bfloat16 {cache} ({L} layers), no "
                               "mesh", plain, pwall),
            "meshed": report(f"merged bfloat16 {cache} ({L} layers), (1, 2) "
                             "mesh", meshed, wall),
            "sched_wall_s": swall}
        log(f"  (1, 2) mesh, bfloat16 {L} layers, {cache}: tokens shared "
            f"with the unmeshed engine {res['bf16'][cache]['agree_unmeshed']}"
            f", scheduler with the engine "
            f"{res['bf16'][cache]['agree_sched']} (of {MODEL_AXIS_NEW} "
            f"each)")
    del placed
    torch.cuda.empty_cache()
    return res


def mesh_serve(mesh):
    """(a)-(c) of ``mesh_path``; ``paged_s`` in the result: the seconds of
    the paged pools' parts."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    lens = (16, 37, 100, 250)  # the path phase's prompts
    prompts = [rng.integers(0, 32000, n) for n in lens]
    max_new, n = 16, len(lens)
    res = {}
    with torch.no_grad():
        _, _, mcfg, mparams = build(32, calibrate=False, dtype="bfloat16")
        L = mcfg.n_layers
        serve(mcfg, mparams, prompts, max_new)  # warm-up
        eng, plain, counts, wall = serve(mcfg, mparams, prompts, max_new)
        check_counts("merged bfloat16 dense, no mesh", counts, eng, L, n,
                     merged=True)
        res["unmeshed"] = report(f"merged bfloat16 dense ({L} layers), no "
                                 "mesh", plain, wall)
        serve(mcfg, mparams, prompts, max_new, mesh=mesh)  # warm-up
        eng, meshed, mcounts, wall = serve(mcfg, mparams, prompts, max_new,
                                           mesh=mesh)
        check_counts("merged bfloat16 dense, (1, 1) mesh", mcounts, eng, L,
                     n, merged=True)
        if mcounts != counts:
            raise AssertionError(f"meshed launch counts {mcounts} != "
                                 f"unmeshed {counts}")
        if streams(meshed) != streams(plain):
            raise AssertionError("the meshed engine's greedy streams differ "
                                 "from the unmeshed engine's")
        res["meshed"] = report(f"merged bfloat16 dense ({L} layers), (1, 1) "
                               "mesh", meshed, wall)
        log(f"  (1, 1) mesh: streams and launch counts equal the unmeshed "
            f"engine's; tok/s meshed {res['meshed']['tok_s']:.1f} vs "
            f"unmeshed {res['unmeshed']['tok_s']:.1f} (one run each)")
        t_paged = time.perf_counter()
        res["paged"] = mesh_paged_serve(mesh, mcfg, mparams, prompts,
                                        max_new)
        paged_s = time.perf_counter() - t_paged
        del eng, mparams
        torch.cuda.empty_cache()

        cfg, params, mcfg, mparams = build(EQ_LAYERS, calibrate=True)
        _, src, c_src, _ = serve(cfg, params, prompts, max_new, mesh=mesh)
        _, mrg, c_mrg, _ = serve(mcfg, mparams, prompts, max_new, mesh=mesh)
        if streams(src) != streams(mrg):
            bad = first_mismatch(cfg, params, prompts, src, mrg)
            raise AssertionError(
                f"on the mesh, merged and source greedy streams differ: "
                f"prompt {bad[0]}, position {bad[1]}, source top-2 margin "
                f"{bad[2]:.3g}")
        log(f"  (1, 1) mesh: merged == source greedy streams (float32, "
            f"{EQ_LAYERS} calibrated layers); launches source "
            f"{ {k: v for k, v in c_src.items() if v} }, merged "
            f"{ {k: v for k, v in c_mrg.items() if v} }")
        res["identity_f32"] = True
        # (c) on the paged pool: rows 1 and 6 (source), 2 and 7 (merged)
        t_paged = time.perf_counter()
        e_src, src, c_src, _ = serve(cfg, params, prompts, max_new,
                                     cache="paged", mesh=mesh)
        check_counts("source float32 paged, (1, 1) mesh", c_src, e_src,
                     EQ_LAYERS, n, merged=False)
        e_mrg, mrg, c_mrg, _ = serve(mcfg, mparams, prompts, max_new,
                                     cache="paged", mesh=mesh)
        check_counts("merged float32 paged, (1, 1) mesh", c_mrg, e_mrg,
                     EQ_LAYERS, n, merged=True)
        if streams(src) != streams(mrg):
            bad = first_mismatch(cfg, params, prompts, src, mrg)
            raise AssertionError(
                f"on the mesh, paged merged and source greedy streams "
                f"differ: prompt {bad[0]}, position {bad[1]}, source top-2 "
                f"margin {bad[2]:.3g}")
        log(f"  (1, 1) mesh: paged merged == source greedy streams "
            f"(float32, {EQ_LAYERS} calibrated layers)")
        res["identity_f32_paged"] = True
        res["paged_s"] = paged_s + time.perf_counter() - t_paged
        del params, mparams, e_src, e_mrg
        torch.cuda.empty_cache()
    return res


def mesh_paged_serve(mesh, mcfg, mparams, prompts, max_new):
    """(a) on the paged and int8 pools and (b) of ``mesh_path``, on the
    32-layer merged bfloat16 model."""
    L, n = mcfg.n_layers, len(prompts)
    res = {}
    for cache in ("paged", "paged_q8"):
        eng, plain, counts, wall = serve(mcfg, mparams, prompts, max_new,
                                         cache=cache)
        check_counts(f"merged bfloat16 {cache}, no mesh", counts, eng, L, n,
                     merged=True)
        unmeshed = report(f"merged bfloat16 {cache} ({L} layers), no mesh",
                          plain, wall)
        eng, meshed, mcounts, wall = serve(mcfg, mparams, prompts, max_new,
                                           cache=cache, mesh=mesh)
        check_counts(f"merged bfloat16 {cache}, (1, 1) mesh", mcounts, eng,
                     L, n, merged=True)
        if mcounts != counts or streams(meshed) != streams(plain):
            raise AssertionError(
                f"{cache}: meshed launch counts {mcounts} vs unmeshed "
                f"{counts}, streams equal {streams(meshed) == streams(plain)}")
        res[cache] = {"unmeshed": unmeshed, "meshed": report(
            f"merged bfloat16 {cache} ({L} layers), (1, 1) mesh", meshed,
            wall)}
        log(f"  (1, 1) mesh, {cache}: streams and launch counts equal the "
            f"unmeshed engine's; tok/s meshed "
            f"{res[cache]['meshed']['tok_s']:.1f} vs unmeshed "
            f"{res[cache]['unmeshed']['tok_s']:.1f} (one run each)")
    # (b): the scheduler through a starved pool, a repeat of the longest
    # prompt sharing its prefix
    sp = list(prompts) + [prompts[3].copy()]
    got = {}
    for tag, m in (("unmeshed", None), ("meshed", mesh)):
        eng, outs, counts, wall = serve(mcfg, mparams, sp, max_new, "paged",
                                        sched=True, mesh=m,
                                        n_blocks=SCHED_STARVED_PAGES)
        check_sched_counts(f"merged bfloat16 paged, {SCHED_STARVED_PAGES} "
                           f"pages, {tag}", counts, eng, merged=True)
        got[tag] = (streams(outs), counts, eng.stats["n_deferred"],
                    eng.stats["n_preempted"], eng.pm.allocator.n_shared_hits)
    if got["meshed"] != got["unmeshed"] or not all(got["meshed"][2:4]):
        raise AssertionError(
            f"starved scheduled pool: meshed (deferred, preempted, prefix "
            f"hits) {got['meshed'][2:]} vs unmeshed {got['unmeshed'][2:]}, "
            f"streams equal {got['meshed'][0] == got['unmeshed'][0]}")
    res["sched_starved"] = dict(zip(("deferred", "preempted", "prefix_hits"),
                                    got["meshed"][2:]))
    log(f"  (1, 1) mesh: ScheduledEngine, {SCHED_STARVED_PAGES} pages: "
        f"streams, launch counts and {res['sched_starved']} equal the "
        f"unmeshed scheduler's")
    return res


def mesh_paged_syncs(mesh):
    """(e) of ``mesh_path``: one decode step's host syncs on the paged and
    the int8 pool, meshed and unmeshed (merged bfloat16 Mistral-7B at two
    full-width layers: the syncs do not depend on depth or weights), after
    a step of warm-up each."""
    import numpy as np
    import torch
    from repro_torch.serving import Engine, Request, ServeConfig

    _, _, mcfg, mparams = build(2, calibrate=False, dtype="bfloat16")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, k) for k in (16, 37, 100, 250)]
    out = {}
    with torch.no_grad():
        for cache in ("paged", "paged_q8"):
            per = {}
            for tag, m in (("unmeshed", None), ("meshed", mesh)):
                eng = Engine(mcfg, mparams, ServeConfig(n_slots=4,
                                                        max_len=512),
                             impl="cuda", cache=cache, device="cuda", mesh=m)
                for p in prompts:
                    eng.submit(Request(prompt=np.asarray(p, np.int32),
                                       max_new_tokens=8))
                eng.step()
                _, caught = sync_counted(eng.step)
                per[tag] = dict(caught)
            if sum(per["meshed"].values()) != sum(per["unmeshed"].values()):
                raise AssertionError(f"{cache}: host syncs of a decode step "
                                     f"meshed {per['meshed']} vs unmeshed "
                                     f"{per['unmeshed']}")
            out[cache] = {k: sum(v.values()) for k, v in per.items()}
            log(f"  (1, 1) mesh, {cache}: host syncs of one decode step "
                f"meshed {out[cache]['meshed']} == unmeshed "
                f"{out[cache]['unmeshed']} (by call chain: "
                f"{per['meshed']})")
    del mparams
    torch.cuda.empty_cache()
    return out


def mesh_train(mesh):
    """(c) of ``mesh_path``."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import DataConfig, Trainer, TrainerConfig

    r = TRAIN_RUN
    cfg = get_config(TRAIN_ARCH).with_(block_style="residual_qpfree")
    losses, secs = {}, {}
    for tag, m in (("unmeshed", None), ("meshed", mesh)):
        ckdir = tempfile.mkdtemp(prefix="mesh_ckpt_",
                                 dir=os.path.join(ROOT, "build"))
        tc = TrainerConfig(steps=MESH_TRAIN_STEPS, log_every=1,
                           ckpt_every=10 ** 9, ckpt_dir=ckdir, keep_ckpts=1,
                           lr=r["lr"], warmup=r["warmup"], remat=True)
        tr = Trainer(cfg, tc, DataConfig(global_batch=r["batch"],
                                         seq_len=r["seq_len"], seed=0),
                     device="cuda", mesh=m)
        tr._save = lambda step: None  # no 13 GB checkpoint here
        tr.run()
        shutil.rmtree(ckdir)
        losses[tag] = [x["loss"] for x in tr.metrics_log]
        secs[tag] = list(tr.straggler.durations)
        del tr
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["meshed"],
                                                   losses["unmeshed"]))
    log(f"  Trainer {cfg.name} {cfg.block_style} whole (B {r['batch']} x S "
        f"{r['seq_len']}), {MESH_TRAIN_STEPS} steps: losses meshed "
        f"{losses['meshed']} vs unmeshed {losses['unmeshed']} (max rel "
        f"{rel:.2e}); step s meshed {[round(x, 3) for x in secs['meshed']]} "
        f"vs unmeshed {[round(x, 3) for x in secs['unmeshed']]}")
    if len(losses["meshed"]) != MESH_TRAIN_STEPS or rel > MESH_TRAIN_RTOL:
        raise AssertionError(f"meshed losses {losses['meshed']} vs "
                             f"unmeshed {losses['unmeshed']}: rel {rel}")
    return {"losses": losses, "step_s": secs, "max_rel": rel}


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def train_llama():
    import shutil
    import statistics
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import count_params
    from repro_torch.training import (DataConfig, Trainer, TrainerConfig,
                                      make_train_step)

    r = TRAIN_RUN
    cfg = get_config(TRAIN_ARCH).with_(block_style="residual_qpfree")
    cfg.validate_style()
    ckdir = tempfile.mkdtemp(prefix="train_ckpt_",
                             dir=os.path.join(ROOT, "build"))
    tc = TrainerConfig(steps=r["steps"], log_every=r["log_every"],
                       ckpt_every=r["steps"], ckpt_dir=ckdir, keep_ckpts=1,
                       lr=r["lr"], warmup=r["warmup"], remat=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, DataConfig(global_batch=r["batch"],
                                     seq_len=r["seq_len"], seed=0),
                 device="cuda")
    torch.cuda.synchronize()
    log(f"train {cfg.name} {cfg.block_style} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads} of "
        f"{cfg.d_head}, vocab {cfg.vocab_size}, {cfg.dtype} compute over "
        f"{cfg.param_dtype} params, AdamW, remat, B {r['batch']} x S "
        f"{r['seq_len']}): init {time.perf_counter() - t0:.1f} s")
    saved = {}
    save = tr.ckpt.save

    def timed_save(*a, **kw):  # the final save; run() waits for its write
        saved["t0"] = time.perf_counter()
        save(*a, **kw)
        saved["snapshot_s"] = time.perf_counter() - saved["t0"]

    tr.ckpt.save = timed_save
    tr.run()
    write_s = time.perf_counter() - saved["t0"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    size = _dir_bytes(ckdir)
    shutil.rmtree(ckdir)
    losses = [m["loss"] for m in tr.metrics_log]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0] - 0.02:
        raise AssertionError(f"{cfg.name}: logged losses {losses} do not "
                             f"fall by 0.02")
    step_s = statistics.median(tr.straggler.durations[TRAIN_TIMED_FROM:])
    tokens = r["batch"] * r["seq_len"]
    n = count_params(tr.params) - (0 if cfg.tie_embeddings else
                                   tr.params["embed"]["table"].numel())
    mfu = 6 * n * tokens / step_s / PEAK_FLOPS["torch.bfloat16"]
    out = {"losses": losses, "step_s": step_s, "tok_s": tokens / step_s,
           "n_params_flops": n, "model_flops_share": mfu, "peak_gb": peak,
           "ckpt_gb": size / 1e9, "ckpt_snapshot_s": saved["snapshot_s"],
           "ckpt_write_s": write_s}
    log(f"  losses at steps {[m['step'] for m in tr.metrics_log]}: "
        f"{[round(x, 4) for x in losses]}; step {step_s:.4f} s (median of "
        f"steps {TRAIN_TIMED_FROM + 1}-{r['steps']}), {tokens / step_s:,.0f} "
        f"tokens/s, model FLOPs share {100 * mfu:.1f}% (6 N tokens / step "
        f"time / 989 TFLOP/s, N {n:,d}); peak device memory {peak:.1f} GB; "
        f"final checkpoint {size / 1e9:.2f} GB, host snapshot "
        f"{saved['snapshot_s']:.1f} s, written in {write_s:.1f} s")

    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in tr.dataset.batch_at(r["steps"]).items()}
    for remat in (True, False, "dots"):
        step = make_train_step(cfg, tr.optimizer, remat=remat)
        for B in (r["batch"], r["batch"] // 2):
            b = {k: v[:B] for k, v in batch.items()}

            def one():
                tr.params, tr.opt_state, _ = step(tr.params, tr.opt_state, b)

            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                one()  # warm-up: the allocator's pools for this remat
            except torch.cuda.OutOfMemoryError:
                fits = False
            else:
                fits = True
            if fits:
                prof = profiled(f"train step profile, {cfg.name}, remat="
                                f"{remat!r}, B {B} x S {r['seq_len']}", one, 1,
                                groups=TRAIN_KERNEL_GROUPS)
                prof.update(batch=B, peak_gb=torch.cuda.max_memory_allocated()
                            / 1e9)
                log(f"    peak device memory {prof['peak_gb']:.1f} GB")
                out[f"profile_remat_{remat}"] = prof
                break
            log(f"  remat={remat!r}: B {B} x S {r['seq_len']} does not fit "
                f"on the card" + ("; trying B 4" if B == r["batch"] else ""))
    del tr, batch, b, step
    torch.cuda.empty_cache()
    return out


def block_rms_tokens(cfg, params, tokens):
    """``block_rms`` of a token-only stack."""
    import torch
    from repro_torch.models import block_sequence
    from repro_torch.models.transformer import apply_block_seq, embed_inputs
    x = torch.as_tensor(tokens, device="cuda")[None]
    h = embed_inputs(params, cfg, x)
    ctx = {"positions": torch.arange(x.shape[1], device="cuda")[None],
           "impl": "cuda"}
    out = []
    for kind, lp, _ in block_sequence(params, cfg):
        h, _, _, _ = apply_block_seq(lp, cfg, h, ctx, kind)
        out.append(float(h.float().pow(2).mean().sqrt()))
    return out


def train_merge_serve(summary):
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch._tree import tree_leaves
    from repro_torch.core import merge_skipless
    from repro_torch.training import (DataConfig, SyntheticLM, checkpoint,
                                      make_optimizer, make_train_step)

    r = TRAIN_MERGE
    out = {}
    for L in TRAIN_EQ_LAYERS:
        cfg, params, _, _ = build(L, calibrate=True)
        torch.cuda.empty_cache()
        rng = np.random.default_rng(0)  # the path phase's prompts
        prompts = [rng.integers(0, cfg.vocab_size, n)
                   for n in (16, 37, 100, 250)]
        opt = make_optimizer("adamw", r["lr"], 2, r["steps"],
                             weight_decay=0.0)
        step = make_train_step(cfg, opt, remat=True)
        state = opt.init(params)
        data = SyntheticLM(DataConfig(global_batch=r["batch"],
                                      seq_len=r["seq_len"], seed=0),
                           cfg.vocab_size)
        losses = []
        t0 = time.perf_counter()
        for s in range(r["steps"]):
            batch = {k: torch.from_numpy(v).to("cuda")
                     for k, v in data.batch_at(s).items()}
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
        train_s = time.perf_counter() - t0
        del state, opt, step
        torch.cuda.empty_cache()
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{cfg.name} skipless: losses {losses}")
        ckdir = tempfile.mkdtemp(prefix="train_ckpt_",
                                 dir=os.path.join(ROOT, "build"))
        t0 = time.perf_counter()
        checkpoint.save(ckdir, r["steps"], {"params": params})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = checkpoint.restore(ckdir, r["steps"],
                                      {"params": params})["params"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        size = _dir_bytes(ckdir)
        shutil.rmtree(ckdir)
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(restored), tree_leaves(params))):
            raise AssertionError("the restored checkpoint differs from the "
                                 "trained weights")
        del params
        torch.cuda.empty_cache()
        log(f"  trained {cfg.name} skipless ({L} layers, float32) "
            f"{r['steps']} steps of B {r['batch']} x S {r['seq_len']} in "
            f"{train_s:.1f} s, losses {losses[0]:.4g} -> {losses[-1]:.4g}; "
            f"checkpoint {size / 1e9:.2f} GB saved in {save_s:.1f} s, "
            f"restored in {restore_s:.1f} s, bit for bit")
        with torch.no_grad():
            mparams, mcfg = merge_skipless(restored, cfg, "qp")
            got = {}
            for tag, c, p, merged in (("source", cfg, restored, False),
                                      ("merged", mcfg, mparams, True)):
                eng, res, counts, _ = serve(c, p, prompts, 16)
                check_counts(f"trained {tag} float32 ({L} layers)", counts,
                             eng, L, len(prompts), merged)
                summary["launches"] = {k: summary["launches"][k] + counts[k]
                                       for k in KERNELS}
                got[tag] = streams(res)
            out[f"losses_{L}_layers"] = losses
            if got["merged"] == got["source"]:
                log(f"  trained merged == source greedy streams ({L} layers,"
                    f" float32): {[x[:6] for x in got['source']]} …")
                out.update(eq_layers=L, train_s=train_s, ckpt_gb=size / 1e9,
                           ckpt_save_s=save_s, ckpt_restore_s=restore_s)
                break
            i, j, margin = first_mismatch(cfg, restored, prompts,
                                          got["source"], got["merged"])
            rms = block_rms_tokens(cfg, restored, np.concatenate(
                [prompts[i], np.asarray(got["source"][i][:j], np.int64)]))
            log(f"  trained merged and source greedy streams differ ({L} "
                f"layers, float32): prompt {i}, position {j}, source top-2 "
                f"margin {margin:.3g}; the source stream's RMS after each "
                f"block there: {', '.join(f'{x:.3g}' for x in rms)}")
            out[f"mismatch_{L}_layers"] = dict(prompt=i, position=j,
                                               margin=margin, rms=rms)
            if L == TRAIN_EQ_LAYERS[-1]:
                raise AssertionError(f"trained merged != source at {L} "
                                     f"layers")
        del restored, mparams, eng, p
        torch.cuda.empty_cache()
    del restored, mparams, eng, p
    torch.cuda.empty_cache()
    return out


class RecordingOptimizer:
    """Wraps an optimizer and keeps the gradients its ``update`` is given:
    what reaches the optimizer (``None`` where the loss does not reach a
    leaf; averaged over micro-batches under ``grad_accum``)."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        self.grads = grads
        return self.inner.update(grads, state, params)


def train_step_card_vs_cpu(cfg, grad_accum):
    """One ``make_train_step`` of ``cfg`` (reduced) on the card and on the
    CPU from the same params and batch -> the largest relative errors of
    the loss, the gradients that reach the optimizer (of each leaf's
    largest) and the updated params (of each leaf's largest).  The
    optimizer is AdamW with eps 1: at eps 1e-8 its first step is
    lr * sign(g), and an element whose gradient sits at rounding level on
    one side would move a whole 2 lr; eps 1 keeps the step smooth in the
    gradient."""
    import torch
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.models import init_params
    from repro_torch.training import DataConfig, make_dataset, make_train_step
    from repro_torch.training.optimizer import AdamW, constant_schedule

    p0 = init_params(cfg, seed=0, device="cpu")
    np_batch = make_dataset(cfg, DataConfig(global_batch=4, seq_len=16,
                                            seed=0)).batch_at(0)
    res = {}
    for dev in ("cpu", "cuda"):
        opt = RecordingOptimizer(AdamW(lr=constant_schedule(1e-3), eps=1.0,
                                       weight_decay=0.0))
        step = make_train_step(cfg, opt, grad_accum=grad_accum, remat=True)
        params = tree_map(lambda t: t.clone().to(dev), p0)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
        params, _, m = step(params, opt.init(params), batch)
        res[dev] = (tree_leaves(tree_map(lambda t: t.cpu(), params)),
                    [None if g is None else g.cpu()
                     for g in tree_leaves(opt.grads)], float(m["loss"]))
    (pc, gc, lc), (pg, gg, lg) = res["cpu"], res["cuda"]
    worst = {"loss": abs(lg - lc) / max(abs(lc), 1e-30), "grads": 0.0,
             "params": 0.0}

    def rel(a, b):
        diff = float((a - b).abs().max())
        scale = float(b.abs().max())
        return diff / scale if scale else (0.0 if diff == 0 else math.inf)

    for a, b in zip(pg, pc):
        worst["params"] = max(worst["params"], rel(a, b))
    for a, b in zip(gg, gc):
        if (a is None) != (b is None):
            worst["grads"] = math.inf
        elif a is not None:
            worst["grads"] = max(worst["grads"], rel(a, b))
    return worst


def train_card_vs_cpu():
    from repro_torch.configs import get_config, list_archs, reduce_config

    t0 = time.perf_counter()
    worst = {"loss": 0.0, "grads": 0.0, "params": 0.0}
    n = 0
    for arch in list_archs():
        for style in TRAIN_STYLES:
            cfg = reduce_config(get_config(arch)).with_(block_style=style)
            try:
                cfg.validate_style()
            except ValueError:
                continue
            for accum in (1, 2) if style == "standard" else (1,):
                w = train_step_card_vs_cpu(cfg, accum)
                n += 1
                if w["loss"] > TRAIN_TOL or w["params"] > TRAIN_TOL or \
                        w["grads"] > TRAIN_GRAD_TOL:
                    raise AssertionError(
                        f"train step card vs CPU, {arch} {style} grad_accum "
                        f"{accum}: {w} (tolerances {TRAIN_TOL:g}, gradients "
                        f"{TRAIN_GRAD_TOL:g})")
                worst = {k: max(worst[k], w[k]) for k in worst}
    log(f"train step card vs CPU: {n} steps (12 archs at reduce_config, "
        f"every style each admits, grad_accum 2 in the standard style; TF32 "
        f"off) agree: worst loss {worst['loss']:.2e}, updated params "
        f"{worst['params']:.2e} (gates {TRAIN_TOL:g} of the scale), "
        f"gradients {worst['grads']:.2e} of each leaf's largest (gate "
        f"{TRAIN_GRAD_TOL:g}); {time.perf_counter() - t0:.1f} s")
    return dict(worst, steps=n)


_SYNC_SINK = []  # the Counter that ``sync_counted`` fills, while it counts


def _record_sync(*_):
    import traceback
    if _SYNC_SINK:
        stack = traceback.extract_stack()[:-1][-6:]
        _SYNC_SINK[-1][" < ".join(f"{os.path.basename(f.filename)}:"
                                  f"{f.lineno} {f.name}"
                                  for f in reversed(stack))] += 1


def sync_counted(fn):
    """(fn(), the host syncs it made, by the Python call chain that made
    them), counted through PyTorch's GPU trace hooks (the ones its CUDA
    sanitizer uses): each device, stream or event synchronization (a
    device-to-host copy, a blocking host-to-device copy, a ``.cpu()``, a
    ``synchronize``) calls back into Python on the thread that made it.
    The hooks stay on for the rest of the process once set, so this runs
    after every timed phase.  Garbage from earlier work is collected
    first, so that no finalizer of it runs inside the count."""
    import collections
    import gc
    import torch
    from torch.cuda import _gpu_trace as gpu_trace

    if not getattr(sync_counted, "hooked", False):
        torch._C._activate_gpu_trace()
        gpu_trace.register_callback_for_device_synchronization(_record_sync)
        gpu_trace.register_callback_for_stream_synchronization(_record_sync)
        gpu_trace.register_callback_for_event_synchronization(_record_sync)
        sync_counted.hooked = True
    gc.collect()
    torch.cuda.synchronize()
    _SYNC_SINK.append(collections.Counter())
    try:
        out = fn()
    finally:
        caught = _SYNC_SINK.pop()
    return out, caught


# depth of the obs phase's model: its checks (obs on == off in streams,
# launches and host syncs) do not depend on depth; cut from 32 so that
# the script, with its model-axis phase, keeps a margin under its limit
OBS_LAYERS = 8


def obs_path(summary):
    """The obs phase on merged bf16 Mistral-7B at ``OBS_LAYERS`` layers
    (uncalibrated, as the path phase's bf16 runs), the path phase's
    prompts.  After every timed phase: it turns on the GPU trace hooks
    (``sync_counted``)."""
    import numpy as np
    import torch
    from repro_torch._tree import tree_map

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 32000, n) for n in (16, 37, 100, 250)]
    with torch.no_grad():
        _, params, mcfg, mparams = build(OBS_LAYERS, calibrate=False)
        del params
        bcfg = mcfg.with_(dtype="bfloat16", param_dtype="bfloat16")
        bparams = tree_map(lambda t: t.to(torch.bfloat16), mparams)
        del mparams
        torch.cuda.empty_cache()
        summary["obs_bf16"] = obs_phase(bcfg, bparams, prompts, 16)
        del bparams
        torch.cuda.empty_cache()


def obs_phase(cfg, params, prompts, max_new):
    """The observer (``ServeConfig(obs=True)``) on the served model (merged
    bf16 Mistral-7B, 32 layers) through ``Engine`` and ``ScheduledEngine``
    on the paged pool, roomy and tight (deferral and preemption), the four
    prompts and a repeat of the 250-token one.  Per run, against the same
    run with the observer off: the same streams, the same kernel launch
    counts and the same host syncs made by ``generate`` (``sync_counted``;
    after a warm-up run of the same configuration); and with it on:
    one terminal event per request, a valid Perfetto export (written to
    ``build/obs_trace_<engine>_<pool>.json``), histograms that count the
    requests and the decode steps, and pool gauges equal to the
    allocator's counters.  On the roomy pools the obs-off and obs-on tok/s
    of one timed run each are printed side by side (no claim)."""
    import torch
    from repro_torch import obs as O
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (Engine, SchedConfig, ScheduledEngine,
                                     ServeConfig)

    def counted(sched, n_blocks, obs):
        """``serve``, with the host syncs of ``generate`` alone counted
        (the synchronizes around it are the measurement's own)."""
        sc = ServeConfig(n_slots=4, max_len=512, n_blocks=n_blocks, obs=obs)
        kw = dict(impl="cuda", cache="paged", device="cuda")
        eng = ScheduledEngine(cfg, params, sc, SchedConfig(**SCHED), **kw) \
            if sched else Engine(cfg, params, sc, **kw)
        torch.cuda.synchronize()
        reset_launch_counts()
        res, syncs = sync_counted(lambda: eng.generate(
            sp, max_new_tokens=max_new))
        torch.cuda.synchronize()
        return eng, streams(res), launch_counts(), syncs

    sp = list(prompts) + [prompts[3].copy()]
    n = len(sp)
    need = max(-(-(len(p) + max_new - 1) // PAGE) for p in sp)
    # timed first: the sync count's trace hooks stay on once set
    timed = {}
    for sched in (False, True):
        engine = "scheduled" if sched else "engine"
        for obs in (False, False, True):  # a warm-up, then timed
            eng, res, _, wall = serve(cfg, params, sp, max_new, "paged",
                                      sched=sched, obs=obs)
            timed[(engine, obs)] = report(
                f"{engine} roomy obs {'on' if obs else 'off'} "
                f"({cfg.dtype})", res, wall)["tok_s"]
        timed[engine] = O.serving_obs_doc(eng)["headline"]
        del eng
    out = {}
    for sched in (False, True):
        engine = "scheduled" if sched else "engine"
        tight = SCHED_STARVED_PAGES if sched else need + 1
        for pool, n_blocks in (("roomy", 0), ("tight", tight)):
            tag = f"{engine} {pool}"
            # a warm-up: the first run of a configuration in the process
            # may make a one-time host sync
            serve(cfg, params, sp, max_new, "paged", sched=sched,
                  n_blocks=n_blocks)
            runs = {obs: counted(sched, n_blocks, obs)
                    for obs in (False, True)}
            (_, s_off, c_off, y_off), (eng, s_on, c_on, y_on) = \
                runs[False], runs[True]
            if not (s_on == s_off and c_on == c_off and y_on == y_off
                    and y_off):
                raise AssertionError(
                    f"obs {tag}: obs-on changed the run: streams equal "
                    f"{s_on == s_off}, launches {c_on} vs {c_off}, host "
                    f"syncs {sum(y_on.values())} vs {sum(y_off.values())}: "
                    f"obs on only {dict(y_on - y_off)}, obs off only "
                    f"{dict(y_off - y_on)}")
            tr, m = eng.obs.trace, eng.metrics
            finishes = [sum(e["name"] == "finish"
                            for e in O.request_events(tr, rid))
                        for rid in range(n)]
            path = os.path.join(ROOT, "build", f"obs_trace_{engine}_"
                                f"{pool}.json")
            O.write_perfetto(path, tr)
            with open(path) as f:
                counts = O.validate_perfetto(json.load(f))
            a = eng.pm.allocator
            gauges = {k: m[k].collect()["value"] for k in (
                "pool_blocks_used", "pool_peak_used", "pool_cow",
                "pool_prefix_hits", "pool_recycled")}
            want_gauges = {"pool_blocks_used": a.n_used,
                           "pool_peak_used": a.peak_used,
                           "pool_cow": a.n_cow,
                           "pool_prefix_hits": a.n_shared_hits,
                           "pool_recycled": a.n_recycled}
            ev = dict(deferred=eng.stats["n_deferred"],
                      preempted=eng.stats["n_preempted"],
                      decode_steps=eng.stats["n_steps"],
                      host_syncs=sum(y_on.values()),
                      trace_events=counts, dropped=tr.n_dropped)
            ok = (finishes == [1] * n and tr.open_spans() == []
                  and tr.n_dropped == 0
                  and m["serve_requests_finished"].value == n
                  and m["serve_ttft_seconds"].count == n
                  and m["serve_queued_seconds"].count == n
                  and m["serve_decode_step_seconds"].count
                  == eng.stats["n_steps"]
                  and m["serve_requests_resumed"].value
                  == eng.stats["n_preempted"]
                  and gauges == want_gauges
                  and (pool == "roomy" or ev["deferred"] + ev["preempted"]))
            if not ok:
                raise AssertionError(f"obs {tag}: finishes {finishes}, "
                                     f"gauges {gauges} vs {want_gauges}, "
                                     f"{ev}, metrics {m.collect()}")
            if pool == "roomy":
                ev.update(tok_s_obs_off=timed[(engine, False)],
                          tok_s_obs_on=timed[(engine, True)],
                          headline_obs_on=timed[engine])
            log(f"  obs {tag}: one finish per request, Perfetto export "
                f"valid, histograms and pool gauges agree; streams, "
                f"launches and host syncs equal with the observer off; "
                f"{ev}")
            out[tag] = ev
            del eng, runs
    torch.cuda.empty_cache()
    return out


LINT_LAYERS = 2  # the full-width lint's only cut: Mistral-7B at 2 layers


def lint_kernel_targets(tag, targets):
    """Each "cuda" decode and prefill target holds one ``repro_torch``
    kernel node per attention layer and launched as many kernels during
    its trace as it holds kernel nodes; chunk programs (the eager
    positions core on every impl) and the "torch" route hold none."""
    for t in targets:
        want = t["n_attn_layers"] if t["impl"] == "cuda" and \
            t["phase"] != "chunk" else 0
        if not t["n_kernel_nodes"] == t["launches"] == want:
            raise AssertionError(
                f"lint {tag} {t['key']}: {t['n_kernel_nodes']} kernel nodes, "
                f"{t['launches']} launches in its trace, want {want}")


def lint_path(summary):
    """The lint phase (``repro_torch.lint``): ``python -m repro_torch.lint
    --device cuda``'s four parts — the sweep of the 36 registered combos
    at reduced shape (the "cuda" combos traced on the card, their kernels
    launching inside the trace; the "torch" combos on the host) and the
    aliasing, submit-path and retention audits on CUDA engines with
    ``impl="cuda"`` — then the registered builders once more on
    full-width Mistral-7B, skipless and its qp merge in bf16, cut to
    ``LINT_LAYERS`` layers (the sweep asserts its max_len collides with no
    dimension of the config or the pool): its 18 "cuda" targets.  Every
    report must be CLEAN, and every kernel target must pass
    ``lint_kernel_targets`` (these launches are asserted here; they are
    not the main path's, so the kernels line does not count them).  Then
    the host syncs of one paged and one int8 paged decode step
    (``forward_step`` alone, full width, idle rows included) through the
    GPU trace hooks (``sync_counted``): none.  Last in the script, after
    the obs phase has turned those hooks on."""
    import importlib

    import torch
    from repro_torch.lint import report
    from repro_torch.lint.__main__ import main as lint_main
    from repro_torch.models import (forward_step, init_paged_cache,
                                    init_paged_q8_cache)

    sw = importlib.import_module("repro_torch.lint.sweep")
    out = {}
    t0 = time.perf_counter()
    path = os.path.join(ROOT, "build", "lint_report.json")
    if lint_main(["--device", "cuda", "--json", path]):
        raise AssertionError("lint (reduced, card): violations above")
    with open(path) as f:
        doc = json.load(f)
    lint_kernel_targets("reduced", doc["sweep"]["targets"])
    out["reduced_s"] = time.perf_counter() - t0
    out["reduced_targets"] = len(doc["sweep"]["targets"])

    t0 = time.perf_counter()
    with torch.no_grad():
        cfg, params, mcfg, mparams = build(LINT_LAYERS, calibrate=False,
                                           dtype="bfloat16")
        rep = sw.sweep(device="cuda", impls=("cuda",),
                       models={"generic": (cfg, params),
                               "merged": (mcfg, mparams)})
    report.render_sweep(rep, verbose=True)
    targets = [t.to_dict() for t in rep.targets]
    if not rep.ok or len(targets) != 18:
        raise AssertionError(f"lint (full width, {LINT_LAYERS} layers): "
                             f"{len(targets)} targets, findings "
                             f"{[str(f) for f in rep.findings]}")
    lint_kernel_targets("full width", targets)
    out["full_width_s"] = time.perf_counter() - t0
    out["kernel_nodes_full_width"] = sum(t["n_kernel_nodes"]
                                         for t in targets)

    syncs = {}
    with torch.no_grad():
        for kind, init in (("paged", init_paged_cache),
                           ("paged_q8", init_paged_q8_cache)):
            cache = init(mcfg, 64, 16, 4, 512, device="cuda")
            tbl = torch.full(tuple(cache.block_tables.shape), -1,
                             dtype=torch.int32)
            tbl[1, :2], tbl[3, 0] = torch.tensor([3, 4]), 7
            cache = cache._replace(
                block_tables=tbl.cuda(),
                length=torch.tensor([0, 20, 0, 9], dtype=torch.int32,
                                    device="cuda"))
            toks = torch.tensor([1, 2, 3, 4], dtype=torch.int32,
                                device="cuda")
            forward_step(mparams, mcfg, toks, cache, impl="cuda")
            _, caught = sync_counted(lambda: forward_step(
                mparams, mcfg, toks, cache, impl="cuda"))
            syncs[kind] = sum(caught.values())
            if syncs[kind]:
                raise AssertionError(f"a {kind} decode step made host "
                                     f"syncs: {dict(caught)}")
    out["host_syncs_per_paged_step"] = syncs
    del params, mparams, rep
    torch.cuda.empty_cache()
    log(f"  lint: reduced sweep (36 targets) + three audits CLEAN in "
        f"{out['reduced_s']:.1f} s; full width ({LINT_LAYERS} layers) 18 "
        f"kernel targets CLEAN in {out['full_width_s']:.1f} s; host syncs "
        f"of one decode step: {syncs}")
    summary["lint"] = out


def profiled(what, fn, steps, ranges=(), groups=()):
    """torch.profiler over ``steps`` calls of ``fn``: device time by kernel
    name, kernel launches per call and the device busy share of the wall
    time, logged under ``what``.  For each name in ``ranges`` (a
    ``record_function`` range that ``fn`` opens), the device time of the
    kernels launched inside it per call, and its share of the device
    time.  ``groups``: (label, name substrings) in order; each kernel
    counts in the first group one of whose substrings its name holds
    (the rest in "other"), and each group's device time per call and
    share are given."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or \
            getattr(e, "self_cuda_time_total", 0)

    # device-side rows only: a CPU op's row (aten::mm) also carries the
    # device time of the kernels it launched, which have rows of their own
    events = prof.key_averages()
    # a range's own device-side row (its span on the GPU timeline) is left
    # out: the kernels inside it have rows of their own
    rows = sorted(((dev_us(e), e.key, e.count) for e in events
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                   and e.key not in ranges), reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    flash = sum(r[0] for r in rows if "flash" in r[1]) / 1e6
    decode = [r for r in rows if "decode" in r[1]]
    ssd = [r for r in rows if "ssd" in r[1]]
    out = {"steps": steps, "wall_ms_per_step": wall / steps * 1e3,
           "device_ms_per_step": busy / steps * 1e3,
           "device_busy_share": busy / wall,
           "flash_ms_per_step": flash / steps * 1e3,
           "flash_share_of_device": flash / busy if busy else 0.0,
           "decode_kernel_ms_per_step": sum(r[0] for r in decode) / steps
           / 1e3,
           "decode_kernels_per_step": sum(r[2] for r in decode) / steps,
           "ssd_kernel_ms_per_step": sum(r[0] for r in ssd) / steps / 1e3,
           "ssd_kernels_per_step": sum(r[2] for r in ssd) / steps,
           "kernels_total": sum(r[2] for r in rows),
           "kernels_per_step": sum(r[2] for r in rows) // steps,
           "top": [[k[:90], us / steps / 1e3, n // steps]
                   for us, k, n in rows[:8]]}
    if groups:
        sums = {label: 0.0 for label, _ in groups}
        sums["other"] = 0.0
        for us, key, _ in rows:
            label = next((lb for lb, subs in groups
                          if any(x in key for x in subs)), "other")
            sums[label] += us
        out["groups"] = {label: {"ms_per_step": us / steps / 1e3,
                                 "share_of_device": us / 1e6 / busy
                                 if busy else 0.0}
                         for label, us in sums.items()}
    for name in ranges:
        # the CPU-side range row: device time of every kernel launched
        # inside it, children included
        us = sum(getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) for e in events
                 if e.key == name and e.device_type == DeviceType.CPU)
        out[f"{name}_ms_per_step"] = us / steps / 1e3
        out[f"{name}_share_of_device"] = us / 1e6 / busy if busy else 0.0
    log(f"  {what} ({steps} calls): {out['wall_ms_per_step']:.2f} ms/call "
        f"wall, {out['device_ms_per_step']:.2f} ms/call of kernels "
        f"({100 * out['device_busy_share']:.0f}% busy), "
        f"{out['kernels_per_step']} kernel launches/call; flash kernels "
        f"{out['flash_ms_per_step']:.3f} ms/call, "
        f"{100 * out['flash_share_of_device']:.1f}% of the kernels' time; "
        f"decode attention kernels {out['decode_kernel_ms_per_step']:.3f} "
        f"ms/call, {out['decode_kernels_per_step']:g} launches/call; SSD "
        f"kernel {out['ssd_kernel_ms_per_step']:.3f} ms/call, "
        f"{out['ssd_kernels_per_step']:g} launches/call; "
        f"{out['kernels_total']} kernel launches in all")
    for name in ranges:
        log(f"    range {name}: {out[f'{name}_ms_per_step']:.3f} ms/call of "
            f"kernels, {100 * out[f'{name}_share_of_device']:.1f}% of the "
            f"kernels' time")
    for label, g in out.get("groups", {}).items():
        log(f"    kernels {label}: {g['ms_per_step']:.3f} ms/call, "
            f"{100 * g['share_of_device']:.1f}% of the kernels' time")
    for k, ms, n in out["top"]:
        log(f"    {ms:8.3f} ms/call  {n:4d} calls/call  {k[:90]}")
    if not rows:
        log("    (the profiler recorded no device time)")
    return out


def profile_decode(cfg, params, prompts, cache, steps=5, max_len=512,
                   ranges=(), vision=None, **serve_kw):
    """``profiled`` over ``steps`` batched decode steps of the 4-slot
    engine on ``cache`` (``serve_kw``: more ``ServeConfig`` fields, e.g. a
    temperature; ``ranges``: as ``profiled``'s), the prompts (a VLM's with
    their ``vision``) prefilled first."""
    from repro_torch.serving import Engine, Request, ServeConfig

    eng = Engine(cfg, params, ServeConfig(n_slots=4, max_len=max_len,
                                          **serve_kw),
                 impl="cuda", cache=cache, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=p, max_new_tokens=steps + 2),
                   vision=None if vision is None else vision[i])
    eng.step()
    extra = "".join(f", {k} {v}" for k, v in serve_kw.items())
    return profiled(f"decode profile, {cfg.name}, {cache} cache, {cfg.dtype} "
                    f"({cfg.n_layers} layers, 4 slots{extra})", eng.step,
                    steps, ranges)


def profile_prefill(cfg, params, prompt, steps=3, max_len=None):
    """``profiled`` over ``steps`` dense prefills of one prompt (after one
    unprofiled warm-up) into a cache of ``max_len`` positions (default
    ``SSM_MAX_LEN``)."""
    import torch
    from repro_torch.models import DensePrefillDest, forward_prefill

    x = torch.as_tensor(prompt, device="cuda")[None]

    def run():
        forward_prefill(params, cfg, x,
                        DensePrefillDest(max_len or SSM_MAX_LEN), impl="cuda")

    run()
    return profiled(f"prefill profile, {cfg.name}, {cfg.dtype} "
                    f"({cfg.n_layers} layers, {len(prompt)} tokens)", run,
                    steps)


PREFILL_PROFILE_LENS = (250, 2048)


def prefill_profiles(cfg, params):
    """Dense prefill profiles of one seeded prompt of each of
    ``PREFILL_PROFILE_LENS`` tokens, keyed by length."""
    import numpy as np
    rng = np.random.default_rng(2)
    return {str(n): profile_prefill(cfg, params,
                                    rng.integers(0, cfg.vocab_size, n),
                                    max_len=n)
            for n in PREFILL_PROFILE_LENS}


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
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    stdout = sys.stdout
    with open(os.path.join(ROOT, "build", "chip_smoke.log"), "w") as f:
        sys.stdout = Tee(stdout, f)
        try:
            return run()
        finally:
            sys.stdout = stdout


def run() -> int:
    import numpy as np
    import torch
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
        spills = {ln.strip() for ln in out.splitlines()
                  if "spill stores" in ln and " 0 bytes spill stores" not in ln}
        for ln in sorted(spills):
            log(f"  {name}: ptxas {ln}")
    decode_occupancy(card)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    rng = np.random.default_rng(0)
    per_call = decode_kernels_per_call(np.random.default_rng(1))
    per_call["ssd_chunk_scan"] = ssd_kernels_per_call(
        np.random.default_rng(1))
    if any(c != 1 for c in per_call.values()):
        raise AssertionError(f"a decode or SSD wrapper call launched other "
                             f"than one device kernel: {per_call}")
    glm_call = decode_kernels_per_call(np.random.default_rng(1), CHATGLM_ATTN)
    if any(c != 1 for c in glm_call.values()):
        raise AssertionError(f"a decode wrapper call at G 16 launched other "
                             f"than one device kernel: {glm_call}")
    rows = []
    decode_phase(rng, rows)
    flash_phase(rng, rows)
    paged_phase(rng, rows, q8=False)
    quant_check(rng)
    paged_phase(rng, rows, q8=True)
    shielded_phase(rng)
    q8_flash_phase(rng, rows)
    decode_phase(rng, rows, hymba=True)
    flash_phase(rng, rows, hymba=True)
    ssd_phase(rng, rows)
    # ChatGLM3-6B's G 16 (two parts of the query group) and a G 12 whose
    # second part is not full
    decode_phase(rng, rows, attn=CHATGLM_ATTN)
    paged_phase(rng, rows, q8=False, attn=CHATGLM_ATTN)
    paged_phase(rng, rows, q8=True, attn=CHATGLM_ATTN)
    decode_phase(rng, rows, attn=G12_ATTN)
    # the VLM's and HuBERT's shapes: non-causal flash with Sk != Sq and at
    # D 80, the cross step's decode read in place
    cross_phase(rng, rows)
    # the partial-state mode over the boxes of model axes 2 and 4
    t0 = time.perf_counter()
    split_rows = []
    split_k_phase(rng, split_rows)
    split_k_phase(rng, split_rows, attn=CHATGLM_ATTN)
    log(f"split-K phase ({card}; rows 4-9 in the partial-state mode over "
        f"the boxes of model axes {MODEL_AXES}, combined, against the whole "
        f"kernel; times in ms from a CUDA graph of 30 calls on one input "
        f"set, L2 warm: the box with the most attended keys beside the "
        f"whole kernel; {time.perf_counter() - t0:.1f} s):")
    for r in split_rows:
        t = "" if "ms" not in r else (
            f"  box {r['box']} ({r['box_keys']} of {r['whole_keys']} keys) "
            f"{r['ms']:.4f} ms, whole {r['whole_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}; box at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)")
        log(f"  {r['name']:36s} {r['dtype']:15s} {r['case']:50s} axis "
            f"{r['axis']}: err {r['max_abs_err']:.2e} (tol {r['tol']:.1e}), "
            f"{r['empty_boxes']} empty box(es){t}")
    log(f"kernel phase ({card}; times in ms, L2 cold, per call from a CUDA "
        f"graph of 30 calls: median [three replays], then the eager timer "
        f"of earlier runs; bound = the larger of the bytes at 3.35 TB/s and "
        f"the flops at the dtype's peak; sdpa on the paged rows: SDPA on "
        f"gathered cache; gather not timed; sdpa on the int8 rows: SDPA on "
        f"dequantized cache; dequant not timed; the SSD rows have no "
        f"library call):")
    for r in rows:
        runs = ", ".join(f"{t:.4f}" for t in r["ms_runs"])
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"  {r['name']:36s} {r['dtype']:15s} {r['case']:50s} err "
            f"{r['max_abs_err']:.2e} (tol {r['tol']:.1e})  kernel "
            f"{r['ms']:.4f} [{runs}] eager {r['eager_ms']:.4f}  plain "
            f"{r['plain_ms']:.4f}  sdpa {lib}  bound "
            f"{r['bound_ms']:.5f} ({r['bound_by']}; bytes "
            f"{r['bytes_ms']:.5f}, flops {r['ops_ms']:.5f}; kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)")

    summary = {"phase_s": {}}

    def timed(phase, *args):
        t0 = time.perf_counter()
        phase(summary, *args)
        summary["phase_s"][phase.__name__] = time.perf_counter() - t0
        log(f"{phase.__name__}: {summary['phase_s'][phase.__name__]:.1f} s")

    for phase in (path_phase, hybrid_path, mamba2_path):
        timed(phase)
    # the dry run's CPU work runs beside the next phases on the card
    dry = start_dryrun()
    try:
        for phase in (dense_configs_path, moe_path, vlm_path, audio_path,
                      train_path):
            timed(phase)
    except BaseException:
        for proc in dry.values():
            proc.kill()
            proc.communicate()
        raise
    timed(mesh_path, dry)
    timed(obs_path)
    # the lint measures no time: it runs beside the model-axis ranks
    timed(model_axis_path, lint_path)

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
    if sys.argv[1:2] == ["--model-axis-rank"]:  # a rank of model_axis_path
        sys.exit(model_axis_rank(int(sys.argv[2])))
    sys.exit(main())
