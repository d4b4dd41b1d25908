"""Token-choice top-k Mixture-of-Experts FFN (GShard/Switch style).

Counterpart of ``repro.models.moe``, with the same capacity semantics:

  * routing in float32 (``x.float() @ router``, softmax, top-k, the chosen
    gates renormalised); ties in the top-k go to the LOWER expert index,
    the rule ``jax.lax.top_k`` follows (``torch.topk`` promises no order
    on ties, so the port takes a stable descending sort);
  * dispatch group-wise: ``g = min(group_size, B·S)`` tokens per group, or
    one group when ``B·S`` is not a multiple of ``g``; with several groups
    the aux loss is their mean (the reference's ``jax.lax.map``), and the
    "scatter" dispatch runs every group in one pass (``_groups_scatter``:
    each group keeps its own queues; the experts run over all of them at
    once), the "einsum" dispatch one group at a time;
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

Under a device mesh (DTensors) the "scatter" dispatch routes, fills the
queues and combines on each rank's local groups, and only the expert
products run on DTensors, split over the model axis with the expert
weights (``_groups_scatter_placed``); where the ranks that split the
batch do not divide the groups, each rank takes the batch whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distribution.placed import (hold_layout, is_placed,
                                             local_part, split_count,
                                             whole_dim)
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
    """Routing of xg (..., g, d), each group (its last two dims) on its
    own -> (gate_vals (..., g, k) float32, idx (..., g, k) int64, slot
    (..., g, k) int64, keep (..., g, k) bool, aux (...)): each (token,
    choice)'s expert, its place in that expert's queue (clipped to
    ``cap - 1``) and whether it fits under ``cap``."""
    *lead, g, _ = xg.shape
    # the group's dim, counted from the front: DTensor's cumsum over a
    # sharded dim named by a negative index runs on each shard alone
    n = len(lead)
    E = router.shape[1]
    probs = torch.softmax(xg.float() @ router.float(), dim=-1)  # (..., g, E)
    # stable descending sort: equal probabilities keep ascending expert
    # order, so a tie goes to the lower index (jax.lax.top_k's rule)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :k], idx[..., :k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    onehot = F.one_hot(idx, E).float()  # (..., g, k, E)
    # position of each (token, choice) in its expert queue, priority by
    # (choice rank, token order): the pairs of earlier choices, then this
    # choice's earlier tokens (the choice-major running count, without
    # flattening (k, g): under a mesh the tokens may be split)
    per_choice = onehot.sum(dim=n)  # (..., k, E)
    earlier = torch.cumsum(per_choice, dim=n) - per_choice
    pos = torch.cumsum(onehot, dim=n) - onehot + earlier.unsqueeze(n)
    pos = pos.gather(-1, idx[..., None])[..., 0]  # (..., g, k)
    keep = pos < cap
    slot = pos.clamp(0, cap - 1).long()
    frac = onehot[..., 0, :].mean(dim=n)  # top-1 routing fraction
    aux = E * torch.sum(frac * probs.mean(dim=n), dim=-1)
    return gate_vals, idx, slot, keep, aux


def _experts(params, expert_in, ffn_type: str):
    """(E, C, d) -> (E, C, d_out) through each expert's GLU FFN."""
    cdt = expert_in.dtype
    act = F.silu if ffn_type == "swiglu" else gelu
    h = act(torch.bmm(expert_in, params["w_gate"].to(cdt)))
    h = h * torch.bmm(expert_in, params["w_up"].to(cdt))
    return torch.bmm(h, params["w_down"].to(cdt))


def _dispatch(router, xs, k: int, E: int, cap: int):
    """Route every group of xs (G, g, d) and fill its expert queues (its
    own buffer rows, its last row taking the group's dropped pairs; every
    kept row is written once onto zero, so the add is exact in any dtype)
    -> (expert inputs (G, E, cap, d), each (token, choice)'s row in the
    (G·E·cap) expert outputs (G·g·k,), its weight (G·g·k, 1) float32,
    aux (G,))."""
    gate_vals, idx, slot, keep, aux = route(router, xs, k, cap)
    G, g, d = xs.shape
    rows = E * cap + 1  # a group's queues and its overflow row
    local = torch.where(keep, idx * cap + slot, E * cap)  # (G, g, k)
    base = torch.arange(G, device=xs.device)[:, None, None] * rows
    dest = (local + base).reshape(G * g * k)
    x_rep = xs.reshape(G * g, d).repeat_interleave(k, dim=0)
    buf = xs.new_zeros((G * rows, d)).index_add_(0, dest, x_rep)
    ein = buf.reshape(G, rows, d)[:, :E * cap].reshape(G, E, cap, d)
    src = (local.clamp(0, E * cap - 1) + base // rows * (E * cap)) \
        .reshape(G * g * k)
    w = (gate_vals * keep.float()).reshape(G * g * k, 1)
    return ein, src, w, aux


def _combine(eo, src, w, g: int, k: int, dtype):
    """Each group's pairs' expert outputs eo (G, E, cap, d_out) gathered
    back and combined in float32 -> (G, g, d_out) in ``dtype``."""
    G = eo.shape[0]
    out = (eo.reshape(-1, eo.shape[-1])[src].float() * w) \
        .reshape(G, g, k, -1).sum(dim=2)
    return out.to(dtype)


def _groups_scatter(params, xs, k: int, E: int, cap: int, ffn_type: str):
    """The buffer dispatch of every group of xs (G, g, d) in one pass:
    each group routes and fills its own expert queues (``_dispatch``), the
    experts run once over all groups' queues, and each group gathers its
    pairs' expert outputs back and combines them in float32
    (``_combine``).  Returns (out (G, g, d_out), aux (G,))."""
    if is_placed(xs):
        return _groups_scatter_placed(params, xs, k, E, cap, ffn_type)
    ein, src, w, aux = _dispatch(params["router"], xs, k, E, cap)
    G, d = xs.shape[0], xs.shape[2]
    eo = _experts(params, ein.transpose(0, 1).reshape(E, G * cap, d),
                  ffn_type)  # (E, G*cap, d_out)
    eo = eo.reshape(E, G, cap, -1).transpose(0, 1)
    return _combine(eo, src, w, xs.shape[1], k, xs.dtype), aux


def _groups_scatter_placed(params, xs, k: int, E: int, cap: int,
                           ffn_type: str):
    """``_groups_scatter`` of a DTensor xs: each rank routes, dispatches
    and combines its groups on local tensors (the groups split over the
    data axes as they lie, each group whole on its ranks, the router
    whole), and only the experts run on DTensors, split over the model
    axis as their weights are (each rank its experts, on every queue of
    its groups); their outputs are gathered over the model axis for the
    combine.  DTensor places no scatter or gather of the dispatch (its
    ``index_add`` has no sharding rule of its own)."""
    mesh = xs.device_mesh
    names = list(mesh.mesh_dim_names or ())
    md = names.index("model") if "model" in names else None
    groups = [i for i, p in enumerate(xs.placements)
              if p.is_shard(0) and mesh.size(i) > 1 and i != md]
    place = [Shard(0) if i in groups else Replicate()
             for i in range(mesh.ndim)]
    xl = xs.redistribute(mesh, place).to_local()
    router = params["router"]
    if is_placed(router):  # whole; its gradient a sum over the groups
        router = local_part(router.redistribute(
            mesh, [Replicate()] * mesh.ndim), groups)
    ein, src, w, aux = _dispatch(router, xl, k, E, cap)
    G, d = xl.shape[0], xl.shape[2]
    queues = [Shard(1) if i in groups else Replicate()
              for i in range(mesh.ndim)]
    eo = _experts(params, DTensor.from_local(
        ein.transpose(0, 1).reshape(E, G * cap, d), mesh, queues,
        run_check=False), ffn_type)  # (E, G*cap, d_out)
    eo = eo.redistribute(mesh, queues).to_local()
    eo = eo.reshape(E, G, cap, -1).transpose(0, 1)
    out = _combine(eo, src, w, xl.shape[1], k, xs.dtype)
    return (DTensor.from_local(out, mesh, place, run_check=False),
            DTensor.from_local(aux, mesh, place, run_check=False))


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
    like = None
    if tokens // g > 1 and (tokens // g) % split_count(x, 0):
        # under a mesh the groups split as the batch does; where the
        # ranks that split it do not divide the groups (DTensor cannot
        # unflatten such a split), each rank takes the batch whole
        like, x = x, whole_dim(x, 0)
    groups = x.reshape(tokens // g, g, d)
    if impl == "scatter":  # every group in one pass
        out, aux = _groups_scatter(params, groups, k, E, cap, ffn_type)
    else:
        outs, auxes = zip(*(_group_einsum(params, xg, k, E, cap, ffn_type)
                            for xg in groups))
        out, aux = torch.cat(outs), torch.stack(auxes)
    # split back as the batch came (each rank keeps its rows), its
    # gradient held to that layout for the groups' reshape
    return hold_layout(out.reshape(B, S, -1), like, 0), aux.mean()
