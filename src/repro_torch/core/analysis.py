"""Weight counting + batch-1 decode speedup model (paper §3).

Counterpart of ``repro.core.analysis``.  ``weight_table(cfg)`` reproduces
the paper's table exactly for the two example configs (Pythia-6.9B,
Mistral-7B) using the paper's own formulas:

  Q+P per layer  = 2·d²
  K+V per layer  = 2·d²·n_kv/n_heads
  FFN per layer  = (2 or 3)·d·hidden           (3 for GLU variants)
  embeddings     = 2·d·vocab                   (input + output)

and extends them to the other families (MoE experts+router, SSD mixers,
hybrid, VLM cross-attn layers, conv positional embeddings).

``decode_speedup(cfg)`` is the paper's bandwidth-bound model: batch-1
autoregressive decode time ∝ bytes of weights read per token, so
speedup = total / (total − removed).  ``active_only=True`` extends it
beyond the paper for MoE (only routed experts are read per token).

``decode_ms_per_token`` takes the memory bandwidth as a required argument:
the port carries no device's rate.  The reference's ``cost_dict`` reads
XLA's compiled cost analysis, which has no PyTorch counterpart, and is
not ported.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig


def _per_layer_counts(cfg: ModelConfig) -> Dict[str, int]:
    d, f = cfg.d_model, cfg.d_ff
    c: Dict[str, int] = {}
    if cfg.has_attention:
        c["qp"] = d * cfg.attn_dim + cfg.attn_dim * d  # Q and P
        c["kv"] = 2 * d * cfg.kv_dim
        if cfg.qkv_bias:
            c["qp"] += cfg.attn_dim
            c["kv"] += 2 * cfg.kv_dim
    glu_mult = 3 if cfg.is_glu else 2
    if cfg.has_ffn:
        if cfg.n_experts:
            c["ffn"] = cfg.n_experts * glu_mult * d * f + d * cfg.n_experts
        else:
            c["ffn"] = glu_mult * d * f
    if cfg.ssm_state:
        d_inner = cfg.ssm_d_inner
        H, G, N, W = cfg.ssm_n_heads, cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_conv_width
        conv_ch = d_inner + 2 * G * N
        c["ssm"] = (d * (2 * d_inner + 2 * G * N + H)  # in_proj
                    + W * conv_ch + conv_ch            # conv kernel + bias
                    + 3 * H                            # A_log, D, dt_bias
                    + d_inner                          # gated norm
                    + d_inner * d)                     # out_proj
    return c


def weight_table(cfg: ModelConfig) -> Dict[str, float]:
    """Totals + paper-table-style rows."""
    d = cfg.d_model
    per = _per_layer_counts(cfg)
    embed = d * cfg.vocab_size * (1 if cfg.tie_embeddings else 2)
    if cfg.conv_pos_width:
        embed += cfg.conv_pos_width * d + d

    if cfg.family == "vlm":
        per_cross = cfg.n_layers // cfg.cross_attn_every
        per_self = cfg.n_layers - per_cross
        layer_total = sum(per.values())
        total = per_self * layer_total + per_cross * layer_total + embed
        n_attn_layers = cfg.n_layers
    else:
        layer_total = sum(per.values())
        total = cfg.n_layers * layer_total + embed
        n_attn_layers = cfg.n_layers if cfg.has_attention else 0

    # removable weights under the merged form (serial Fig 1b / Table 1)
    if not cfg.has_attention:
        removed = 0
    elif cfg.family == "hybrid":
        removed = cfg.n_layers * d * cfg.attn_dim  # Q only (see DESIGN §5)
    elif cfg.family == "audio":
        removed = n_attn_layers * per["qp"] - d * d  # input_proj retained
    else:
        removed = n_attn_layers * per["qp"]

    total_wo = total - removed
    return {
        "qp_per_layer": per.get("qp", 0),
        "kv_per_layer": per.get("kv", 0),
        "ffn_per_layer": per.get("ffn", 0),
        "ssm_per_layer": per.get("ssm", 0),
        "embed": embed,
        "total": total,
        "removed": removed,
        "total_without_qp": total_wo,
        "savings_frac": removed / total if total else 0.0,
        "speedup": total / total_wo if total_wo else 1.0,
    }


def active_weights_per_token(cfg: ModelConfig, with_qp: bool = True) -> int:
    """Weights read per decoded token (MoE: routed experts only)."""
    d, f = cfg.d_model, cfg.d_ff
    per = _per_layer_counts(cfg)
    glu_mult = 3 if cfg.is_glu else 2
    if cfg.n_experts:
        per = dict(per)
        per["ffn"] = cfg.experts_per_token * glu_mult * d * f + d * cfg.n_experts
    layer = sum(per.values())
    if not with_qp and cfg.has_attention:
        layer -= per.get("qp", 0) if cfg.family != "hybrid" else d * cfg.attn_dim
    # embedding: one row read + full unembedding matmul
    embed = d + d * cfg.vocab_size
    return cfg.n_layers * layer + embed


def decode_speedup(cfg: ModelConfig, active_only: bool = False) -> float:
    """Paper §3 model: batch-1, memory-bandwidth-bound decode."""
    if active_only:
        a = active_weights_per_token(cfg, with_qp=True)
        b = active_weights_per_token(cfg, with_qp=False)
        return a / b
    t = weight_table(cfg)
    return t["speedup"]


def decode_ms_per_token(n_weights: int, bytes_per_weight: int = 2, *,
                        hbm_gbps: float, chips: int = 1) -> float:
    """Lower-bound ms/token when weight streaming saturates the memory
    bandwidth ``hbm_gbps`` (GB/s per chip)."""
    return n_weights * bytes_per_weight / (hbm_gbps * 1e9 * chips) * 1e3
