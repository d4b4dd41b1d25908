"""The one traffic generator: reads a mix's parameters (``<mix>.json``
beside this file) and makes its requests from the seed.

Every seed gets the same sizes and gaps in another order.  Prompt
lengths, output lengths and inter-arrival gaps are quantiles of the mix's
distributions at stratified points ``(i + 0.5) / strata``; each block of
``strata`` consecutive requests holds every point once, in an order drawn
from the seed (each quantity its own order), so any prefix of the
backlog that a window consumes has nearly the mix's own distribution.
Token ids are drawn uniformly from the vocabulary.

A closed loop (``"loop": "closed"``) is a backlog that refills every
freed slot; with ``"first_wave": "partial"`` the first ``n_slots``
requests start part-way through, each with a budget drawn (stratified)
uniformly from 1 to its drawn output length, so finishes are spread from
the first step on.  An open loop (``"loop": "open"``) gives each request
a due time: Poisson arrivals at ``rate_per_s``, the exponential gaps
stratified as above.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List

import numpy as np

_NORMAL = NormalDist()


@dataclass
class Item:
    """One request of a mix: its prompt, its output budget and, in an open
    loop, when it is due (seconds after the loop opens)."""
    prompt: np.ndarray  # (S,) int32
    max_new: int
    due: float = 0.0


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed (any whole number)."""
    return np.random.default_rng([seed % 2 ** 64, stream])


def quantile(spec: Dict, u: float) -> int:
    """The length at probability ``u`` of a distribution spec: "uniform"
    over the whole numbers min..max, or "lognormal" with its median and
    sigma, clipped to min..max."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        x = lo + math.floor(u * (hi - lo + 1))
    elif spec["dist"] == "lognormal":
        x = round(spec["median"] * math.exp(spec["sigma"]
                                            * _NORMAL.inv_cdf(u)))
    else:
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    return min(max(x, lo), hi)


def stratified(rng: np.random.Generator, n: int, strata: int) -> np.ndarray:
    """``n`` points in (0, 1): block after block of ``strata`` points,
    each block every ``(i + 0.5) / strata`` once, in the rng's order."""
    blocks = [(rng.permutation(strata) + 0.5) / strata
              for _ in range(-(-n // strata))]
    return np.concatenate(blocks)[:n]


def generate(mix: Dict, seed: int, vocab: int) -> List[Item]:
    """The mix's ``backlog`` requests for ``seed``, in order."""
    n, strata = int(mix["backlog"]), int(mix["strata"])
    u_prompt = stratified(rng_for(seed, 1), n, strata)
    u_out = stratified(rng_for(seed, 2), n, strata)
    lens = [quantile(mix["prompt"], u) for u in u_prompt]
    outs = [quantile(mix["output"], u) for u in u_out]
    if mix["loop"] == "closed" and mix.get("first_wave") == "partial":
        k = min(int(mix["serve"]["n_slots"]), n)
        u_part = stratified(rng_for(seed, 3), k, k)
        for i in range(k):
            outs[i] = max(1, math.ceil(u_part[i] * outs[i]))
    dues = [0.0] * n
    if mix["loop"] == "open":
        gaps = [-math.log1p(-u) / float(mix["rate_per_s"])
                for u in stratified(rng_for(seed, 4), n, strata)]
        dues = np.cumsum(gaps).tolist()
    toks = rng_for(seed, 5).integers(0, vocab, size=sum(lens),
                                     dtype=np.int32)
    cuts = np.cumsum([0] + lens)
    return [Item(prompt=toks[cuts[i]:cuts[i + 1]], max_new=outs[i],
                 due=dues[i]) for i in range(n)]


def warm_lengths(mix: Dict) -> List[int]:
    """Prompt lengths that reach every prefill shape the mix can send
    under power-of-two bucketing: the shortest, each power of two above
    it up to the longest, and the longest."""
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    out = {lo, hi}
    b = 8
    while b < hi:
        if b > lo:
            out.add(b)
        b *= 2
    return sorted(out)
