"""Exact weight-removal transforms for skipless transformers (the paper).

Counterpart of ``repro.core.merge`` for dense serial stacks.
``merge_skipless(params, cfg, variant)`` maps a ``block_style="skipless"``
(Fig 1a) parameter tree to a mathematically identical
``block_style="skipless_merged"`` tree (Fig 1b/c/d per Table 1):

  variant "qp" (MHA/MQA/GQA):  O*_{i-1} = O_{i-1} Q_i ;  K* = Q⁻¹K ; V* = Q⁻¹V
  variant "kp" (MHA only):     O*_{i-1} = O_{i-1} K_i ;  Q* = K⁻¹Q ; V* = K⁻¹V
  variant "vp" (MHA only):     O*_{i-1} = O_{i-1} V_i ;  Q* = V⁻¹Q ; K* = V⁻¹K
  all variants:                M*_i = P_i M_i

Removing projection T_i of block i rewrites the block-i input basis
``u* = u T_i (+ b_T)``: every producer of u (the previous block's w_down,
or the embedding table for i = 0) is right-multiplied by T_i, and every
other consumer in block i (the remaining attention projections) is
left-multiplied by T_i⁻¹.  With QKV biases, consumers get
``b'_c = b_c − b_T (T⁻¹ W_c)`` and the previous block's output gains
``b_out = b_T`` (the embedding gains ``embed_bias``).

The math runs in float64 on the parameters' device, ONE LAYER AT A TIME:
the whole-stack einsums of the reference would hold (L, d, d_ff) float64
operands (15 GB at Mistral-7B width) and run without BLAS; per layer the
temporaries are a few hundred MB and freed before the next layer, and the
card's FP64 units do the products.  Results are cast back to each
weight's dtype into preallocated stacked tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layer_plan

_F64 = torch.float64


def condition_numbers(params, cfg: ModelConfig, variant: str = "qp") -> np.ndarray:
    """cond₂(T_i) per layer — the paper §4 invertibility audit."""
    conds = []
    for m in params["layers"]["attn"]["w" + variant[0]]:
        s = torch.linalg.svdvals(m.to(_F64))
        conds.append(float(s[0] / s[-1]))
    return np.asarray(conds)


def merge_skipless(params: Dict[str, Any], cfg: ModelConfig,
                   variant: str = "qp") -> Tuple[Dict[str, Any], ModelConfig]:
    """Exact (Fig 1) merge of a serial skipless dense model.  Returns
    (merged_params, merged_cfg); tensors the merge does not change are
    shared with ``params``."""
    if cfg.block_style != "skipless":
        raise ValueError("merge_skipless expects block_style='skipless'")
    if cfg.parallel_block:
        raise ValueError(
            "exact merging applies to the serial layout (paper Fig 1/2; "
            "the parallel Fig 3 forms are trainable architectures)")
    if layer_plan(cfg)["kind"] != "attn" or cfg.n_experts or \
            cfg.family != "dense":
        raise NotImplementedError(
            f"merge of family {cfg.family!r} is not ported yet (ROADMAP.md)")
    mcfg = cfg.with_(block_style="skipless_merged", merged_variant=variant)
    mcfg.validate_style()

    layers = params["layers"]
    attn = layers["attn"]
    L = attn["w" + variant[0]].shape[0]
    t = variant[0]
    consumers = [n for n in ("q", "k", "v") if n != t]
    has_bias = ("b" + t) in attn
    ffn = layers["ffn"]
    glu = "w_gate" in ffn
    f_in = ("w_gate", "w_up") if glu else ("w_in",)
    f_out = "w_down" if glu else "w_out"

    new_attn: Dict[str, torch.Tensor] = {}
    for n in consumers:
        new_attn["w" + n] = torch.empty_like(attn["w" + n])
        if has_bias or ("b" + n) in attn:
            new_attn["b" + n] = torch.empty_like(attn["w" + n][:, 0, :])
    new_ffn = {k: v for k, v in ffn.items()}
    ad = attn["wp"].shape[1]
    for name in f_in:
        w = ffn[name]
        new_ffn[name] = w.new_empty((L, ad, w.shape[2]))
    new_ffn[f_out] = torch.empty_like(ffn[f_out])
    new_layers: Dict[str, Any] = {"attn": new_attn, "ffn": new_ffn}
    if has_bias:
        new_layers["b_out"] = torch.empty_like(attn["b" + t])

    T = attn["w" + t][0].to(_F64)
    for i in range(L):
        Tinv = torch.linalg.inv(T)
        bT = attn["b" + t][i].to(_F64) if has_bias else None
        # (b) consumers of u: W' = T⁻¹ W, b' = b − b_T (T⁻¹ W)
        for n in consumers:
            w2 = Tinv @ attn["w" + n][i].to(_F64)
            new_attn["w" + n][i] = w2.to(attn["w" + n].dtype)
            if ("b" + n) in new_attn:
                b0 = attn["b" + n][i].to(_F64) if ("b" + n) in attn \
                    else torch.zeros_like(w2[0])
                if bT is not None:
                    b0 = b0 - bT @ w2
                new_attn["b" + n][i] = b0.to(new_attn["b" + n].dtype)
            del w2
        # P-fold into the FFN input matrices; w_down absorbs the next T
        P = attn["wp"][i].to(_F64)
        for name in f_in:
            new_ffn[name][i] = (P @ ffn[name][i].to(_F64)).to(ffn[name].dtype)
        del P
        T_next = attn["w" + t][i + 1].to(_F64) if i + 1 < L else None
        w_down = ffn[f_out][i].to(_F64)
        if T_next is not None:
            w_down = w_down @ T_next
        new_ffn[f_out][i] = w_down.to(ffn[f_out].dtype)
        del w_down
        if has_bias:  # the next block's folded bias enters after w_down
            nb = attn["b" + t][i + 1] if i + 1 < L \
                else torch.zeros_like(attn["b" + t][i])
            new_layers["b_out"][i] = nb
        if T_next is not None:
            T = T_next
        del Tinv

    out: Dict[str, Any] = {k: v for k, v in params.items()
                           if k not in ("layers", "embed")}
    out["layers"] = new_layers
    # fold T_0 (+ b_T0) into the embedding table
    table = params["embed"]["table"]
    T0 = attn["w" + t][0].to(_F64)
    out["embed"] = {"table": (table.to(_F64) @ T0).to(table.dtype)}
    if has_bias:
        out["embed_bias"] = attn["b" + t][0].to(table.dtype, copy=True)
    if cfg.tie_embeddings:
        # the unembedding keeps the ORIGINAL table: the basis rotation
        # applies to the input side only.  Untie.
        out["unembed"] = {"table": table}
        mcfg = mcfg.with_(tie_embeddings=False)
    return out, mcfg


def removed_weight_count(params_before, params_after) -> int:
    """Parameters the merge removed (weight-savings accounting)."""
    return sum(int(x.numel()) for x in tree_leaves(params_before)) - \
        sum(int(x.numel()) for x in tree_leaves(params_after))
