"""Token-choice top-k Mixture-of-Experts FFN (GShard/Switch style).

Counterpart of ``repro.models.moe``, with the same capacity semantics:

  * routing in float32 (``x.float() @ router``, softmax, top-k, the chosen
    gates renormalised); ties in the top-k go to the LOWER expert index,
    the rule ``jax.lax.top_k`` follows (``torch.topk`` promises no order
    on ties, so the port takes a stable descending sort);
  * dispatch group-wise: ``g = min(group_size, B·S)`` tokens per group, or
    one group when ``B·S`` is not a multiple of ``g``; with several groups
    the aux loss is their mean (the reference's ``jax.lax.map``);
  * capacity ``_capacity(g, E, k, factor)`` per expert and group, or ``g``
    under ``dropless`` (serving's chunk and decode programs); priority is
    choice-major, then token order (a cumsum over the (k·g, E) one-hot);
    a dropped (token, choice) pair contributes exactly zero;
  * aux load-balance loss ``E · Σ_e fraction_e · prob_e`` (Switch).

Two dispatches, chosen by ``impl`` and equal in exact arithmetic:
"scatter" routes tokens into an (E·C + 1, d) buffer whose last row takes
every dropped pair and is sliced away, gathers each pair's expert output
back and combines in float32 before the cast; "einsum" is the GShard
one-hot dispatch and combine, whose combine runs in the compute dtype, as
the reference's does.  The expert products run over the whole (E, C, d)
buffer, zero rows of experts that got no token included, as XLA einsums
do in the reference; they are plain ``torch.bmm`` calls, not a kernel.

Under the paper's merged form P folds into the router and into every
expert's input matrices (``core.merge``): the shapes do not change.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, gelu


def init_moe(gen, d_in: int, d_ff: int, d_out: int, n_experts: int,
             ffn_type: str, dtype=torch.float32):
    """Expert weights from ``dense_init`` (whatever the block style) and a
    float32 router, as in the reference."""
    if ffn_type not in ("swiglu", "geglu"):
        raise ValueError("MoE experts use GLU FFNs in this framework")
    router = dense_init(gen, d_in, n_experts, torch.float32)

    def stack(fan_in, fan_out):
        w = torch.empty((n_experts, fan_in, fan_out), dtype=dtype,
                        device=gen.device)
        for e in range(n_experts):
            w[e] = dense_init(gen, fan_in, fan_out, dtype)
        return w

    return {"router": router,
            "w_gate": stack(d_in, d_ff),  # (E, d_in, f)
            "w_up": stack(d_in, d_ff),
            "w_down": stack(d_ff, d_out)}  # (E, f, d_out)


def _capacity(group_size: int, n_experts: int, k: int, factor: float) -> int:
    cap = int(group_size * k * factor / n_experts)
    return max(cap, 1)


def route(router, xg, k: int, cap: int):
    """Routing of one group xg (g, d) -> (gate_vals (g, k) float32, idx
    (g, k) int64, slot (g, k) int64, keep (g, k) bool, aux scalar): each
    (token, choice)'s expert, its place in that expert's queue (clipped to
    ``cap - 1``) and whether it fits under ``cap``."""
    g = xg.shape[0]
    E = router.shape[1]
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)  # (g, E)
    # stable descending sort: equal probabilities keep ascending expert
    # order, so a tie goes to the lower index (jax.lax.top_k's rule)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :k], idx[:, :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(idx, E).float()  # (g, k, E)
    # position of each (token, choice) in its expert queue, priority by
    # (choice rank, token order)
    flat = onehot.transpose(0, 1).reshape(k * g, E)  # choice-major
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, g, E).transpose(0, 1)
    pos = pos.gather(-1, idx[..., None])[..., 0]  # (g, k)
    keep = pos < cap
    slot = pos.clamp(0, cap - 1).long()
    frac = onehot[:, 0, :].mean(dim=0)  # top-1 routing fraction
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return gate_vals, idx, slot, keep, aux


def _experts(params, expert_in, ffn_type: str):
    """(E, C, d) -> (E, C, d_out) through each expert's GLU FFN."""
    cdt = expert_in.dtype
    act = F.silu if ffn_type == "swiglu" else gelu
    h = act(torch.bmm(expert_in, params["w_gate"].to(cdt)))
    h = h * torch.bmm(expert_in, params["w_up"].to(cdt))
    return torch.bmm(h, params["w_down"].to(cdt))


def _group_scatter(params, xg, k: int, E: int, cap: int, ffn_type: str):
    gate_vals, idx, slot, keep, aux = route(params["router"], xg, k, cap)
    g, d = xg.shape
    # destination row of each (token, choice): expert*C + slot; dropped
    # pairs go to an overflow row that is sliced away.  Every kept row is
    # written once onto zero, so the add is exact in any dtype
    dest = torch.where(keep, idx * cap + slot, E * cap).reshape(g * k)
    x_rep = xg.repeat_interleave(k, dim=0)  # (g*k, d): token per choice
    buf = xg.new_zeros((E * cap + 1, d)).index_add_(0, dest, x_rep)
    eo = _experts(params, buf[:E * cap].reshape(E, cap, d), ffn_type)
    # combine: gather each pair's expert output, weight, sum over k
    pair_out = eo.reshape(E * cap, -1)[dest.clamp(0, E * cap - 1)]
    w = (gate_vals * keep.float()).reshape(g * k, 1)
    out = (pair_out.float() * w).reshape(g, k, -1).sum(dim=1)
    return out.to(xg.dtype), aux


def _group_einsum(params, xg, k: int, E: int, cap: int, ffn_type: str):
    """The GShard one-hot dispatch and combine (the reference semantics;
    O(g·E·C·d) dispatch products, quadratic in the group size)."""
    gate_vals, idx, slot, keep, aux = route(params["router"], xg, k, cap)
    cdt = xg.dtype
    onehot = F.one_hot(idx, E)  # (g, k, E)
    slot_oh = F.one_hot(slot, cap).to(cdt)  # (g, k, C)
    disp = (onehot * keep[..., None]).to(cdt)[..., None] * \
        slot_oh[:, :, None, :]  # (g, k, E, C)
    expert_in = torch.einsum("gec,gd->ecd", disp.sum(dim=1), xg)
    eo = _experts(params, expert_in, ffn_type)
    combine = torch.einsum("gkec,gk->gec", disp.float(),
                           gate_vals * keep.float())
    out = torch.einsum("gec,ecd->gd", combine.to(cdt), eo)
    return out.to(xg.dtype), aux


def apply_moe(params, x, *, n_experts: int, experts_per_token: int,
              capacity_factor: float = 1.25, group_size: int = 2048,
              ffn_type: str = "swiglu", dropless: bool = False,
              impl: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d_out), aux_loss float32 scalar).

    ``dropless=True`` (serving's chunk and decode programs) sets the
    capacity to the group size, so no pair is ever dropped; whole-prompt
    prefill drops by ``capacity_factor``.  ``impl`` is "scatter" (the
    default) or "einsum"."""
    B, S, d = x.shape
    k, E = experts_per_token, n_experts
    tokens = B * S
    g = min(group_size, tokens)
    if tokens % g:
        g = tokens  # degenerate small inputs: one group
    cap = g if dropless else _capacity(g, E, k, capacity_factor)
    one_group = _group_scatter if impl == "scatter" else _group_einsum
    groups = x.reshape(tokens // g, g, d)
    if len(groups) == 1:
        out, aux = one_group(params, groups[0], k, E, cap, ffn_type)
        return out.reshape(B, S, -1), aux
    outs, auxes = zip(*(one_group(params, xg, k, E, cap, ffn_type)
                        for xg in groups))
    return torch.cat(outs).reshape(B, S, -1), torch.stack(auxes).mean()
