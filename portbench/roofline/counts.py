"""Operations and bytes that the inputs need, from the lengths the harness
sent and a configuration's widths (``shapes`` of ``weights/<reference>.py``):
the true lengths, the causal band and the sliding window, never a bucket's
padding or a slot that holds no request.  FLOPs count 2 per multiply-add.
"""
from __future__ import annotations

from typing import Dict, List

BYTES = 2  # bfloat16 activations and cache


def _keys(n: int, window: int) -> int:
    return min(n, window) if window else n


def band(n: int, window: int) -> int:
    """Query-key pairs of a causal prompt of ``n`` tokens under the
    window: sum over positions p < n of min(p + 1, window)."""
    if not window or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def decode_attn(s: Dict, ctx_lens: List[int]) -> Dict[str, float]:
    """One layer's decode attention call over the active slots, each
    attending ``ctx`` cached positions (its new one included): the K and
    V rows read, the query read and the output written."""
    keys = sum(_keys(n, s["W"]) for n in ctx_lens)
    qo = 2 * len(ctx_lens) * s["H"] * s["D"]
    return {"bytes": BYTES * (2 * keys * s["Hkv"] * s["D"] + qo),
            "flops": 4.0 * s["H"] * s["D"] * keys}


def flash(s: Dict, n: int) -> Dict[str, float]:
    """One layer's causal prefill attention over ``n`` true tokens: q, k,
    v read once, the output written once."""
    rows = n * (2 * s["H"] * s["D"] + 2 * s["Hkv"] * s["D"])
    return {"bytes": float(BYTES * rows),
            "flops": 4.0 * s["H"] * s["D"] * band(n, s["W"])}


def weight_flops_per_token(s: Dict) -> float:
    """The matmul FLOPs of one token through every layer: K and V, the
    dense FFN or the k routed experts and the router."""
    d, f = s["d"], s["f"]
    kv = 2 * 2 * d * s["Hkv"] * s["D"]
    ffn = 2 * 3 * d * f * (s["k"] if s["E"] else 1)
    router = 2 * d * s["E"]
    return float(s["L"] * (kv + ffn + router))


def unembed_flops(s: Dict) -> float:
    return 2.0 * s["d"] * s["V"]


def prefill_flops(s: Dict, n: int) -> float:
    """A whole-prompt prefill of ``n`` true tokens that samples one
    token."""
    attn = s["L"] * 4.0 * s["H"] * s["D"] * band(n, s["W"])
    return n * weight_flops_per_token(s) + attn + unembed_flops(s)


def decode_flops(s: Dict, ctx_lens: List[int]) -> float:
    """One decode step over the active slots' context lengths."""
    attn = sum(s["L"] * 4.0 * s["H"] * s["D"] * _keys(n, s["W"])
               for n in ctx_lens)
    return len(ctx_lens) * (weight_flops_per_token(s) + unembed_flops(s)) \
        + attn
