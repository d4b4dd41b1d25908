"""Exact weight-removal transforms for skipless transformers (the paper).

Counterpart of ``repro.core.merge`` for every serial family: dense,
MoE, hybrid, VLM and the audio encoder.
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
left-multiplied by T_i⁻¹.  P folds into the FFN input matrices; in an
MoE block, into the float32 router and every expert's ``w_gate`` and
``w_up`` (same shapes), and every expert's ``w_down`` absorbs the next T.
A hybrid block (attention heads beside SSM heads,
``repro.models.mamba2``) gets the Q-removal half only: its FFN reads the
fused attention+SSM stream, so P stays, and the SSM ``in_proj`` is one
more consumer of u.  A VLM's next-T chain runs self(g, s) ->
self(g, s + 1) -> cross(g) -> self(g + 1, 0); its cross blocks keep
wk/wv (they read the vision tokens, not the stream), so only "qp" is
legal there.  An encoder's continuous frames cannot fold T_0 into an
embedding table: the merge emits an explicit ``input_proj`` (= T_0)
instead.  Pure SSM stacks have no Q/K/V/P: they raise ValueError.  With QKV biases, consumers get
``b'_c = b_c − b_T (T⁻¹ W_c)`` and the previous block's output gains
``b_out = b_T`` (the embedding gains ``embed_bias``).

The math runs in float64 on the parameters' device, ONE LAYER (and in an
MoE block one expert) AT A TIME: the whole-stack einsums of the reference
would hold (L, d, d_ff) float64 operands (15 GB at Mistral-7B width; one
Phi-3.5-MoE layer's experts alone are 3.4 GB in float64) and run without
BLAS; one matrix's temporaries are a few hundred MB and freed before the
next, and the card's FP64 units do the products.  Results are cast back
to each weight's dtype into preallocated stacked tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layer_plan

_F64 = torch.float64


def _mats(w, i: int):
    """Layer ``i``'s 2-D matrices of a stacked weight: (L, a, b) -> [w[i]];
    an MoE's (L, E, a, b) -> one view per expert."""
    return [w[i]] if w.dim() == 3 else list(w[i])


def condition_numbers(params, cfg: ModelConfig, variant: str = "qp") -> np.ndarray:
    """cond₂(T_i) per layer — the paper §4 invertibility audit (a VLM: its
    self layers in order, then its cross layers)."""
    w = params["layers"]["attn"]["w" + variant[0]]
    mats = list(w.reshape(-1, *w.shape[-2:]))
    if layer_plan(cfg)["kind"] == "vlm":
        mats += list(params["cross_layers"]["attn"]["w" + variant[0]])
    conds = []
    for m in mats:
        s = torch.linalg.svdvals(m.to(_F64))
        conds.append(float(s[0] / s[-1]))
    return np.asarray(conds)


def merge_skipless(params: Dict[str, Any], cfg: ModelConfig,
                   variant: str = "qp") -> Tuple[Dict[str, Any], ModelConfig]:
    """Exact (Fig 1) merge of a serial skipless dense, MoE, hybrid, VLM or
    audio-encoder model.  Returns (merged_params, merged_cfg); tensors the
    merge does not change are shared with ``params``."""
    if cfg.block_style != "skipless":
        raise ValueError("merge_skipless expects block_style='skipless'")
    if cfg.parallel_block:
        raise ValueError(
            "exact merging applies to the serial layout (paper Fig 1/2; "
            "the parallel Fig 3 forms are trainable architectures)")
    kind = layer_plan(cfg)["kind"]
    if kind == "ssm":
        raise ValueError("pure SSM stacks have no Q/K/V/P to merge")
    if kind == "vlm":
        if variant != "qp":
            raise ValueError("VLM merge supports the qp variant (cross-attn "
                             "K/V read vision tokens, which are not "
                             "stream-basis)")
        if cfg.qkv_bias:
            raise NotImplementedError("vlm merge with QKV biases")
    mcfg = cfg.with_(block_style="skipless_merged", merged_variant=variant)
    mcfg.validate_style()
    t = variant[0]
    out: Dict[str, Any] = {k: v for k, v in params.items()
                           if k not in ("layers", "cross_layers", "embed")}

    if kind == "vlm":
        slf, crs = params["layers"], params["cross_layers"]  # (ng, spg, …)
        ng, spg = slf["attn"]["wq"].shape[:2]
        flat = tree_map(lambda x: x.reshape((ng * spg,) + x.shape[2:]), slf)
        Tq, Tc = flat["attn"]["wq"], crs["attn"]["wq"]

        def next_self(j):  # self(g, s) -> self(g, s + 1), or cross(g)
            g, s_ = divmod(j, spg)
            return (Tq[j + 1] if s_ + 1 < spg else Tc[g]).to(_F64)

        def next_cross(g):  # cross(g) -> self(g + 1, 0); identity last
            return Tq[(g + 1) * spg].to(_F64) if g + 1 < ng else None

        merged = _merge_stack(flat, variant, next_self)
        out["layers"] = tree_map(
            lambda x: x.view((ng, spg) + tuple(x.shape[1:])), merged)
        out["cross_layers"] = _merge_stack(crs, variant, next_cross,
                                           cross=True)
        T0, b0 = Tq[0], None
    else:
        attn = params["layers"]["attn"]
        T, L = attn["w" + t], attn["w" + t].shape[0]
        out["layers"] = _merge_stack(
            params["layers"], variant,
            lambda i: T[i + 1].to(_F64) if i + 1 < L else None)
        T0 = T[0]
        b0 = attn["b" + t][0] if ("b" + t) in attn else None

    # fold T_0 (+ b_T0) into the embedding table; an encoder's frames
    # cannot fold it into a table, so it keeps T_0 as an input projection
    table = params["embed"]["table"]
    if b0 is not None:
        out["embed_bias"] = b0.to(table.dtype, copy=True)
    if cfg.family == "audio":
        out["embed"] = params["embed"]
        out["input_proj"] = T0.to(table.dtype, copy=True)
        return out, mcfg
    out["embed"] = {"table": (table.to(_F64) @ T0.to(_F64)).to(table.dtype)}
    if cfg.tie_embeddings:
        # the unembedding keeps the ORIGINAL table: the basis rotation
        # applies to the input side only.  Untie.
        out["unembed"] = {"table": table}
        mcfg = mcfg.with_(tie_embeddings=False)
    return out, mcfg


def _merge_stack(layers, variant: str, T_next, cross: bool = False):
    """Merge a stacked (L, …) tree of serial blocks one layer at a time:
    layer i's remaining attention projections (the consumers of its input
    basis) become T_i⁻¹ W, its P folds into the FFN input matrices (a
    hybrid block keeps P and its SSM ``in_proj`` is one more consumer),
    and its w_down (every expert's) absorbs ``T_next(i)`` (float64, or
    None for the identity after the last block).  A VLM's cross block
    (``cross``) reads the stream only through its removed Q: it keeps
    wk/wv (they read the vision tokens) and gets no consumer step."""
    attn = layers["attn"]
    t = variant[0]
    L = attn["wp"].shape[0]
    hybrid = "ssm" in layers
    consumers = [] if cross else [n for n in ("q", "k", "v") if n != t]
    has_bias = ("b" + t) in attn
    if hybrid and has_bias:
        raise NotImplementedError("hybrid merge with QKV biases")
    f_key = "moe" if "moe" in layers else "ffn"
    ffn = layers[f_key]
    f_in = [n for n in ("router", "w_gate", "w_up", "w_in") if n in ffn]
    f_out = "w_out" if "w_out" in ffn else "w_down"

    new_attn: Dict[str, torch.Tensor] = \
        {n: attn[n] for n in ("wk", "wv")} if cross else {}
    for n in consumers:
        new_attn["w" + n] = torch.empty_like(attn["w" + n])
        if has_bias or ("b" + n) in attn:
            new_attn["b" + n] = torch.empty_like(attn["w" + n][:, 0, :])
    new_ffn = {k: v for k, v in ffn.items()}
    ad = attn["wp"].shape[1]
    if hybrid:  # P stays; the SSM in_proj is one more consumer of u
        new_attn["wp"] = attn["wp"]
        ssm = layers["ssm"]
        new_ssm = dict(ssm, in_proj=torch.empty_like(ssm["in_proj"]))
    else:
        for name in f_in:  # (L, [E,] d, f) -> (L, [E,] ad, f)
            w = ffn[name]
            new_ffn[name] = w.new_empty(w.shape[:-2] + (ad, w.shape[-1]))
    new_ffn[f_out] = torch.empty_like(ffn[f_out])
    new_layers: Dict[str, Any] = {"attn": new_attn, f_key: new_ffn}
    if hybrid:
        new_layers["ssm"] = new_ssm
    if has_bias:
        new_layers["b_out"] = torch.empty_like(attn["b" + t])

    for i in range(L):
        if consumers or hybrid:
            Tinv = torch.linalg.inv(attn["w" + t][i].to(_F64))
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
        if hybrid:
            new_ssm["in_proj"][i] = (Tinv @ ssm["in_proj"][i].to(_F64)).to(
                ssm["in_proj"].dtype)
        else:  # P-fold into the FFN input matrices (MoE: router, experts)
            P = attn["wp"][i].to(_F64)
            for name in f_in:
                for w, dst in zip(_mats(ffn[name], i),
                                  _mats(new_ffn[name], i)):
                    dst.copy_(P @ w.to(_F64))
            del P
        # w_down (every expert's) absorbs the next T
        T_next_i = T_next(i)
        for w, dst in zip(_mats(ffn[f_out], i), _mats(new_ffn[f_out], i)):
            dst.copy_(w if T_next_i is None else w.to(_F64) @ T_next_i)
        if has_bias:  # the next block's folded bias enters after w_down
            nb = attn["b" + t][i + 1] if i + 1 < L \
                else torch.zeros_like(attn["b" + t][i])
            new_layers["b_out"][i] = nb
        del T_next_i
    return new_layers


def removed_weight_count(params_before, params_after) -> int:
    """Parameters the merge removed (weight-savings accounting)."""
    return sum(int(x.numel()) for x in tree_leaves(params_before)) - \
        sum(int(x.numel()) for x in tree_leaves(params_after))
