"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the finished requests, drawn from
the seed and holding the longest of them, is run through the plain
reference once: each prompt with its served tokens.  The numbers compared
are the widest and the mean gap by which a served (greedy) token's
reference logit lies below the reference's best logit at its position.
The control reads, at the same positions, the gaps of the tokens that the
lower-precision reference puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch



def pick_sample(finished: Sequence, rng: np.random.Generator,
                served_tokens: int, max_requests: int) -> List:
    """The request with the most served tokens, then others drawn by
    ``rng`` until ``served_tokens`` are covered or ``max_requests`` are
    taken.  Each request has ``prompt`` and ``out_tokens``."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: (-len(finished[i].out_tokens),
                                  -len(finished[i].prompt)))
    picked = [order[0]]
    rest = [order[i] for i in rng.permutation(len(order) - 1) + 1]
    n = len(finished[order[0]].out_tokens)
    for i in rest:
        if n >= served_tokens or len(picked) >= max_requests:
            break
        picked.append(i)
        n += len(finished[i].out_tokens)
    return [finished[i] for i in picked]


def _inputs(sample, device) -> Tuple[List[torch.Tensor], List[int]]:
    seqs, starts = [], []
    for r in sample:
        toks = np.concatenate([np.asarray(r.prompt, np.int64),
                               np.asarray(r.out_tokens[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        starts.append(len(r.prompt) - 1)
    return seqs, starts


def _gaps(ref: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Per position, how far the reference's logit of ``toks`` lies below
    its best."""
    return ref.max(-1).values - ref.gather(1, toks[:, None])[:, 0]


def _summary(gaps: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers a limit may hold: the widest and the mean gap, the
    share of positions whose token is not the reference's first, and the
    90th percentile of the gaps."""
    g = torch.cat(gaps)
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "mismatch_share": float((g > 0).float().mean()),
            "p90_logit_gap": float(torch.quantile(g.float(), 0.9)),
            "tokens": int(g.numel())}


def served_gaps(ref, weights: Dict, s: Dict, sample) -> Dict[str, float]:
    """The widest and the mean gap of the served tokens below the best of
    the reference module ``ref`` (``reference/<name>.py``), and how many
    tokens were compared."""
    dev = weights["embed"]["table"].device
    seqs, starts = _inputs(sample, dev)
    best = ref.logits(weights, s, seqs, starts)
    return _summary([_gaps(lg, torch.as_tensor(
        np.asarray(r.out_tokens, np.int64), device=lg.device))
        for lg, r in zip(best, sample)])


def control_gaps(ref, weights: Dict, s: Dict, sample) -> Dict[str, float]:
    """The same numbers for the tokens that the float8 reference puts
    first at each served position."""
    dev = weights["embed"]["table"].device
    seqs, starts = _inputs(sample, dev)
    best = ref.logits(weights, s, seqs, starts)
    low = ref.logits(weights, s, seqs, starts, fp8=True)
    return _summary([_gaps(a, b.argmax(-1)) for a, b in zip(best, low)])
