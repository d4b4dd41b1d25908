"""Plain float32 reference of the benchmark's configurations: the Q/P-free
block with norms and skips (arXiv:2404.12362, Fig. 4) over a dense SwiGLU
FFN or a top-k mixture of SwiGLU experts.

It reads only a configuration file's widths and the weights the benchmark
made; it imports nothing of the program.  Per layer, for a stream ``x``:

    n = rmsnorm(x) * g1          q = rope(n)            (no Q projection)
    k = rope(n @ wk)             v = n @ wv
    x = x + attention(q, k, v)                          (no P projection)
    x = x + ffn(rmsnorm(x) * g2)

with grouped-query heads, RoPE in the half-split layout, causal attention
over a sliding window of ``W`` positions (position p sees p - W < j <= p),
and logits ``rmsnorm(x) * g @ unembed.T``.  The MoE routes each token to
its top-k experts by ``softmax(n @ router)`` (ties to the lower index),
the k gates renormalised, and drops nothing.

Everything runs in float32 with TF32 off, layer by layer, each layer's
weights widened once for every sequence.  ``fp8=True`` is the control:
every weight product instead takes float8 (e4m3) operands, the
activations scaled per row and the weights per output column, the
precision step below the configuration's bfloat16.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8_e4m3fn


def _fq(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _mm(a: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """a (n, i) @ w (i, o) in float32, or on float8 operands."""
    if fp8:
        a, w = _fq(a, -1), _fq(w, 0)
    return a @ w


def _rms(x, g, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g.float()


def _rope(x, theta):
    """x (S, h, D) at positions 0..S-1, half-split pairs."""
    S, D = x.shape[0], x.shape[-1]
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, window: int, block: int = 1024):
    """Causal grouped-query attention: q (S, H, D), k/v (S, Hkv, D)."""
    S, H, D = q.shape
    Hkv = k.shape[1]
    qg = q.reshape(S, Hkv, H // Hkv, D)
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        lo = max(0, s0 - window + 1) if window else 0
        sc = torch.einsum("qhgd,khd->hgqk", qg[s0:s1], k[lo:s1]) / math.sqrt(D)
        qp = torch.arange(s0, s1, device=q.device)[:, None]
        kp = torch.arange(lo, s1, device=q.device)[None, :]
        ok = kp <= qp
        if window:
            ok = ok & (qp - kp < window)
        p = torch.softmax(sc.masked_fill(~ok, float("-inf")), dim=-1)
        out[s0:s1] = torch.einsum("hgqk,khd->qhgd", p, v[lo:s1]) \
            .reshape(s1 - s0, H, D)
    return out


def _swiglu(x, wg, wu, wd, fp8):
    return _mm(F.silu(_mm(x, wg, fp8)) * _mm(x, wu, fp8), wd, fp8)


def _moe(x, p, layer: int, k: int, fp8: bool):
    probs = torch.softmax(x @ p["router"][layer].float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    idx = idx[:, :k]
    out = torch.zeros_like(x)
    for e in range(probs.shape[-1]):
        rows, choice = (idx == e).nonzero(as_tuple=True)
        if rows.numel():
            y = _swiglu(x[rows], p["w_gate"][layer, e].float(),
                        p["w_up"][layer, e].float(),
                        p["w_down"][layer, e].float(), fp8)
            out.index_add_(0, rows, y * gates[rows, choice, None])
    return out


@torch.no_grad()
def logits(weights: Dict, s: Dict, seqs: List[torch.Tensor],
           starts: List[int], fp8: bool = False) -> List[torch.Tensor]:
    """Float32 logits (n_i, V) at positions ``starts[i]`` .. end of each
    token sequence ``seqs[i]`` (1-D int), over the real vocabulary.
    ``s``: the widths (``weights.qpfree.shapes``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(weights, s, seqs, starts, fp8)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _logits(weights, s, seqs, starts, fp8):
    H, Hkv, D, eps, W = s["H"], s["Hkv"], s["D"], s["eps"], s["W"]
    table = weights["embed"]["table"]
    hs = [table[t.to(table.device).long()].float() for t in seqs]
    lay = weights["layers"]
    for i in range(s["L"]):
        wk = lay["attn"]["wk"][i].float()
        wv = lay["attn"]["wv"][i].float()
        for j, h in enumerate(hs):
            n = _rms(h, lay["norm1"]["scale"][i], eps)
            S = n.shape[0]
            q = _rope(n.reshape(S, H, D), s["theta"])
            kk = _rope(_mm(n, wk, fp8).reshape(S, Hkv, D), s["theta"])
            vv = _mm(n, wv, fp8).reshape(S, Hkv, D)
            hs[j] = h + _attend(q, kk, vv, W).reshape(S, H * D)
        del wk, wv
        # the FFN is position-wise: every sequence's rows at once
        x = _rms(torch.cat(hs), lay["norm2"]["scale"][i], eps)
        if "moe" in lay:
            y = _moe(x, lay["moe"], i, s["k"], fp8)
        else:
            f = lay["ffn"]
            y = _swiglu(x, f["w_gate"][i].float(), f["w_up"][i].float(),
                        f["w_down"][i].float(), fp8)
        del x
        cuts = [0]
        for h in hs:
            cuts.append(cuts[-1] + h.shape[0])
        hs = [h + y[a:b] for h, a, b in zip(hs, cuts, cuts[1:])]
        del y
    un = weights["unembed"]["table"][:s["V"]].float().T
    g = weights["final_norm"]["scale"]
    return [_mm(_rms(h[st:], g, eps), un, fp8) for h, st in zip(hs, starts)]
