#!/usr/bin/env python3
"""The flash kernel rows (bf16, and float32 beside them) and a long merged
prefill profile, or (``--mode decode``) the decode kernel rows and the
decode step profiles, or (``--mode ssd``) the SSD scan rows and the SSM
prefill profiles, on the port found under ``--src``, so that two trees
can be compared on one card.

    python3 tools/flash_before_after.py --src build/parent/src --tag parent
    python3 tools/flash_before_after.py --src src --tag change
    python3 tools/flash_before_after.py --mode decode --src src --tag change
    python3 tools/flash_before_after.py --mode ssd --src src --tag change

Imports ``repro_torch`` from ``--src`` (nothing else of that tree) and the
phases of this checkout's ``chip_smoke.py``, builds that tree's kernels of
the mode, then runs, in the flash mode:

* the bf16 flash kernel rows of ``chip_smoke.py`` at 250 tokens and at the
  long prompts (rows 1 and 2 at Mistral-7B's shape: 2048 and 4096 causal,
  2048 with window 512; row 1 at Hymba-1.5B's at 2048 with window 1024;
  row 3 at 2048), and its float32 rows at 250 tokens (rows 1-3) and at
  2048 (row 2), each held against its plain version as there;
* ``profile_prefill`` of a merged (skipless_merged) Mistral-7B in bf16,
  32 layers, random weights from seed 0 (the kernels' work does not
  depend on the values), at 250 and 2048 tokens;

and in the decode mode:

* ``chip_smoke.py``'s decode kernel rows 4-9 in bf16 and float32 (rows 4
  and 5 at Mistral-7B's shape, row 4 also at Hymba-1.5B's, rows 6-9 on the
  paged tables and int8 pools), each held against its plain version as
  there, with the device kernels per call of each bf16 wrapper;
* ``profile_decode`` of the same merged Mistral-7B on the dense, paged
  and int8 paged caches (4 slots, the path phase's prompts);

and in the ssd mode:

* ``chip_smoke.py``'s SSD rows (row 10) in bf16 and float32 at
  Hymba-1.5B's geometry (H 50, P 64, N 16; 250, 512 and 2048 tokens) and
  Mamba2-2.7B's (H 80, P 64, N 128; 256, 512 and 2048), each held against
  its plain version at the same gate, with the device kernels per
  ``ssd_chunk_scan`` call;
* ``profile_prefill`` of bf16 Mamba2-2.7B at 64 layers (512 and 2048
  tokens) and of bf16 Hymba-1.5B at 32 layers (512 tokens), random weights
  from seed 0, with the SSD kernel's device ms.

Prints the card, then one JSON line, and appends it to
``build/<mode>_before_after_<tag>.jsonl`` (run each tree twice, in turns
with the other, to see the spread).  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", required=True, help="name of the tree")
    ap.add_argument("--mode", choices=("flash", "decode", "ssd"),
                    default="flash", help="which kernel family to time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    sys.path.insert(1, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("flash_before_after: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all(["ssd_scan" if args.mode == "ssd"
                      else f"{args.mode}_attention"])
    build_s = time.perf_counter() - t0

    rng = np.random.default_rng(0)
    rows = []
    per_call = {}
    if args.mode == "decode":
        per_call = cs.decode_kernels_per_call(np.random.default_rng(1))
        cs.decode_phase(rng, rows)
        cs.paged_phase(rng, rows, q8=False)
        cs.paged_phase(rng, rows, q8=True)
        cs.decode_phase(rng, rows, hymba=True)
    elif args.mode == "ssd":
        from repro_torch.kernels import ssd_scan as sk
        per_call = {"ssd_chunk_scan": cs.ssd_kernels_per_call(
            np.random.default_rng(1))}
        cs.ssd_phase(rng, rows, occupancy=hasattr(sk, "occupancy"))
    else:
        flash_rows(cs, rng, rows)
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['name']:36s} {r['dtype'][6:]:9s} {r['case'][:56]:56s} "
              f"err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} sdpa {lib} "
              f"bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}%)",
              flush=True)

    if args.mode == "ssd":
        profiles = {"prefill_profile_bf16": ssm_profiles(cs)}
    else:
        profiles = attention_profiles(cs, args.mode)
    out = {"tag": args.tag, "mode": args.mode, "card": card,
           "build_s": build_s,
           "rows": [{k: r[k] for k in (
               "name", "dtype", "case", "max_abs_err", "ms", "ms_runs",
               "plain_ms", "library_ms", "bound_ms", "bound_by")}
                    for r in rows], **profiles}
    if per_call:
        out["kernels_per_call"] = per_call
    line = json.dumps(out)
    print(line, flush=True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", f"{args.mode}_before_after_"
                           f"{args.tag}.jsonl"), "a") as f:
        f.write(line + "\n")
    return 0


def attention_profiles(cs, mode):
    """The flash and decode modes' profiles of a merged bf16 Mistral-7B."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("mistral-7b").with_(
        block_style="skipless_merged", dtype="bfloat16",
        param_dtype="bfloat16")
    with torch.no_grad():
        params = init_params(cfg, seed=0, device="cuda")
        if mode == "decode":
            prng = np.random.default_rng(0)
            prompts = [prng.integers(0, cfg.vocab_size, n)
                       for n in (16, 37, 100, 250)]
            profiles = {"decode_profile_bf16": {
                cache: cs.profile_decode(cfg, params, prompts, cache)
                for cache in ("dense", "paged", "paged_q8")}}
        else:
            profiles = {"prefill_profile_bf16": cs.prefill_profiles(
                cfg, params)}
    return profiles


SSM_PROFILES = (("mamba2-2.7b", (512, 2048)), ("hymba-1.5b", (512,)))


def ssm_profiles(cs):
    """The ssd mode's prefill profiles: bf16 Mamba2-2.7B (64 layers) and
    Hymba-1.5B (32 layers) at full width from seed 0, one seeded prompt of
    each length, keyed "<arch> <length>"."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    out = {}
    rng = np.random.default_rng(2)
    with torch.no_grad():
        for arch, lens in SSM_PROFILES:
            cfg = get_config(arch).with_(dtype="bfloat16",
                                         param_dtype="bfloat16")
            params = init_params(cfg, seed=0, device="cuda")
            for n in lens:
                out[f"{arch} {n}"] = cs.profile_prefill(
                    cfg, params, rng.integers(0, cfg.vocab_size, n),
                    max_len=max(n, cs.SSM_MAX_LEN))
            del params
            torch.cuda.empty_cache()
    return out


def flash_rows(cs, rng, rows):
    """The flash mode's kernel rows (see the module docstring)."""
    import torch
    cs.flash_phase(rng, rows, cases=[
        c for c in cs.flash_cases()
        if c[1] >= 2048 or (c[1] == 250 and c[2] == 0)])
    cs.flash_phase(rng, rows, hymba=True, cases=[
        c for c in cs.flash_cases(hymba=True)
        if c[0] == torch.bfloat16 and c[1] in (250, 2048)])
    cs.q8_flash_phase(rng, rows, cases=[
        c for c in cs.Q8_FLASH_CASES if c[1] in (256, 2048) and c[2] == 0])


if __name__ == "__main__":
    sys.exit(main())
