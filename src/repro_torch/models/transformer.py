"""Dense, MoE, Mamba2 (SSM), hybrid, VLM and audio-encoder stacks in all
paper block styles: setup, the sequence forward, prefill into the dense
cache, a paged pool or an int8 paged pool, and one-token decode against
any of them.

Counterpart of ``repro.models.transformer`` for every plan kind: "attn"
(the dense, moe and audio families; an MoE FFN is ``models.moe``), "ssm"
(mamba2 mixer blocks), "hybrid" (attention heads in parallel with SSM
heads, mean-fused, then the FFN) and "vlm" (groups of
``cross_attn_every - 1`` self-attention layers and one cross-attention
layer whose queries come from the stream and whose K/V come from the
vision tokens, without RoPE).  The VLM's self layers are stacked
(n_groups, self_per_group, …) and its cross layers (n_groups, …); the
cache keeps the self layers' K/V flattened (n_groups · self_per_group, …)
beside the cross K/V (n_groups, B, n_vision, Hkv, Dh), written once by
the prefill.  An encoder (``causal=False``: the audio family, whose input
is frames (B, S, d_model) and whose positions come from a depthwise
convolution) runs through ``forward_seq`` only: the cache-writing entry
points refuse it, as the reference's engine does.  The paged pools serve
attention-only stacks: SSM state and vision K/V have no pages.  An MoE
FFN routes as in
the reference: whole-prompt prefill (``forward_seq``, ``forward_prefill``)
drops pairs by ``capacity_factor`` over a group of ``moe_group`` (or B·S)
tokens, padding included; chunk programs and the decode step route
dropless.  Block styles (paper mapping):
  standard         pre-norm residual blocks
  skipless         Fig 1(a): no skips / no norms, full Q,K,V,P
  skipless_merged  Fig 1(b): Q and P removed (``core.merge``)
  residual_qpfree  Fig 4: Q/P-free blocks with norms and skips
each serial or ``parallel_block`` (Fig 3).

Parameters are nested dicts of layer-stacked tensors; where JAX scans over
the layer axis the port loops over it.  Serving entry points:

  forward_prefill  whole-prompt prefill DISPATCHER over the
                   ``models.backends`` PREFILL registry (the destination
                   picks the cache_kind axis, ``prefill_style_key`` the
                   style axis)
  forward_step     one token against the dense cache or a paged pool; the
                   per-layer attention route is looked up in the
                   AttentionBackend registry keyed (cache_kind, style,
                   impl)
  forward_prefill_chunk
                   one fixed-width slice of a prompt against the serving
                   cache (the scheduler's chunked prefill), dispatched over
                   the CHUNK registry

Unlike the JAX reference, ``forward_step`` updates the cache IN PLACE (the
new K/V rows, ``kv_pos``; a paged pool's pages) and returns it with
``length`` advanced, and a paged prefill writes the prompt's pages into
the pools in place: a functional copy of a multi-GB cache per token is
what donation avoids on the TPU.  The int8 pool (``paged_q8``) is written
the same way, ints and per-(page, kv-head) scales together
(``kernels.quant``), and the decode step writes each layer's SSM state
and conv tail in place too.  The dense prefill collects the SSM states
from its one pass over the prompt (the reference runs the SSM layers a
second time for them; the blocks are the same, so are the states).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.placed import (assign_, full, head_layout,
                                             is_placed, local_pages,
                                             model_axis_size, own_pages,
                                             put_, reanchor, row_split,
                                             split_group, whole_dim)
from repro_torch.kernels import paging, quant
from repro_torch.models import attention as attn_mod
from repro_torch.models import backends
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    MetaGenerator,
    apply_conv_pos,
    apply_embedding,
    apply_rmsnorm,
    apply_rope,
    apply_unembedding,
    dense_init,
    dtype_of,
    init_conv_pos,
    init_embedding,
    init_rmsnorm,
    orthogonal_init,
)
from repro_torch.obs import get_active


def _init_fn_for(cfg: ModelConfig):
    """Orthogonal init for skipless styles (norm-preserving, cond(Q)≈1 so
    the merged runtime is numerically clean); lecun-normal otherwise."""
    if cfg.init_style == "orthogonal":
        return orthogonal_init
    if cfg.init_style == "normal":
        return dense_init
    return (orthogonal_init if cfg.block_style in ("skipless", "skipless_merged")
            else dense_init)


# ---------------------------------------------------------------------------
# layer kind layout per config
# ---------------------------------------------------------------------------

def layer_plan(cfg: ModelConfig) -> Dict[str, Any]:
    """Describes how layers are stacked for this config."""
    if cfg.family == "ssm":
        return {"kind": "ssm", "n": cfg.n_layers}
    if cfg.family == "hybrid":
        return {"kind": "hybrid", "n": cfg.n_layers}
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        return {"kind": "vlm", "n_groups": cfg.n_layers // per,
                "self_per_group": per - 1}
    return {"kind": "attn", "n": cfg.n_layers}


def _require_decoder(cfg: ModelConfig, what: str) -> None:
    """The cache-writing entry points serve decoders only: an encoder
    (``causal=False``) runs through ``forward_seq``."""
    if not cfg.causal:
        raise ValueError(f"{what} serves decoders; {cfg.name} is an encoder "
                         "(causal=False): use forward_seq")


def n_attn_layers(cfg: ModelConfig) -> int:
    """Self-attention layers holding per-token K/V (the leading axis of
    every serving cache's k/v)."""
    plan = layer_plan(cfg)
    if plan["kind"] in ("attn", "hybrid"):
        return plan["n"]
    if plan["kind"] == "vlm":
        return plan["n_groups"] * plan["self_per_group"]
    return 0


# ---------------------------------------------------------------------------
# per-layer param init
# ---------------------------------------------------------------------------

def _init_attn_proj(gen, cfg: ModelConfig, dtype, merged: bool,
                    cross: bool = False):
    """Q/K/V/P params for one attention sub-module.  Merged styles omit
    the eliminated pair per ``cfg.merged_variant`` (paper Table 1).
    Cross-attention keeps wk/wv (they read the vision tokens, which are
    not in the stream's basis), so only "qp" is legal there."""
    d, ad, kd = cfg.d_model, cfg.attn_dim, cfg.kv_dim
    init_fn = _init_fn_for(cfg)
    dev = gen.device
    p: Dict[str, Any] = {}
    variant = cfg.merged_variant if merged else ""
    if variant and cross and variant != "qp":
        raise ValueError("cross-attention supports only the qp merged "
                         "variant")
    if variant != "qp":
        p["wq"] = init_fn(gen, d, ad, dtype)
        if cfg.qkv_bias:
            p["bq"] = torch.zeros((ad,), dtype=dtype, device=dev)
    if variant != "kp":
        p["wk"] = init_fn(gen, d, kd, dtype)
        if cfg.qkv_bias:
            p["bk"] = torch.zeros((kd,), dtype=dtype, device=dev)
    if variant != "vp":
        p["wv"] = init_fn(gen, d, kd, dtype)
        if cfg.qkv_bias:
            p["bv"] = torch.zeros((kd,), dtype=dtype, device=dev)
    if not merged:
        p["wp"] = init_fn(gen, ad, d, dtype)
    return p


def _needs_norms(style: str) -> bool:
    return style in ("standard", "residual_qpfree")


def _is_merged(style: str) -> bool:
    return style in ("skipless_merged", "residual_qpfree")


def _block_kind(cfg: ModelConfig, kind: Optional[str]) -> str:
    """A block's kind: ``kind`` if given ("cross" for a VLM's cross
    layers), else the plan's, a VLM's self layers being "attn"."""
    kind = kind or layer_plan(cfg)["kind"]
    return "attn" if kind == "vlm" else kind


def init_block(gen, cfg: ModelConfig, dtype,
               kind: Optional[str] = None) -> Dict[str, Any]:
    """One block's params for the config's plan kind (or ``kind``)."""
    style = cfg.block_style
    merged = _is_merged(style)
    kind = _block_kind(cfg, kind)
    p: Dict[str, Any] = {}
    if kind in ("attn", "hybrid", "cross"):
        p["attn"] = _init_attn_proj(gen, cfg, dtype, merged,
                                    cross=kind == "cross")
    if kind == "hybrid" and "wp" not in p["attn"]:
        # the hybrid's merged style removes Q only: P stays, since the FFN
        # reads the fused attention+SSM stream
        p["attn"]["wp"] = dense_init(gen, cfg.attn_dim, cfg.d_model, dtype)
    if kind in ("ssm", "hybrid"):
        p["ssm"] = m2.init_mamba2(gen, cfg, dtype)
    if cfg.has_ffn:
        # merged serial attention stacks: FFN (or MoE) input dim is
        # attn_dim (P folded in)
        ffn_in = cfg.attn_dim if (merged and not cfg.parallel_block
                                  and kind != "hybrid") else cfg.d_model
        if cfg.n_experts and kind == "attn":
            p["moe"] = moe_mod.init_moe(gen, ffn_in, cfg.d_ff, cfg.d_model,
                                        cfg.n_experts, cfg.ffn_type, dtype)
        else:
            p["ffn"] = ffn_mod.init_ffn(gen, ffn_in, cfg.d_ff, cfg.d_model,
                                        cfg.ffn_type, dtype,
                                        init_fn=_init_fn_for(cfg),
                                        out_gain=cfg.ffn_out_gain)
    if _needs_norms(style):
        p["norm1"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
        if cfg.has_ffn:
            p["norm2"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    return p


def _init_stack(gen, cfg: ModelConfig, dtype, n: int,
                kind: Optional[str] = None):
    """``n`` blocks stacked (n, …), filled one block at a time into
    preallocated tensors."""
    first = init_block(gen, cfg, dtype, kind)
    stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)

    def put(i, block):
        for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
            dst[i].copy_(src)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_block(gen, cfg, dtype, kind))
    return stacked


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters made on ``device`` from a seeded
    ``torch.Generator`` there.  The layer stacks are filled one layer at a
    time into preallocated (L, …) tensors, so the peak is one copy of the
    model (plus one layer).  A VLM's self layers are (n_groups,
    self_per_group, …) and its cross layers ``params["cross_layers"]``
    (n_groups, …); an encoder with ``conv_pos_width`` gets
    ``params["conv_pos"]``."""
    dev = resolve_device(device)
    return _init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """``init_params``' tree on the ``meta`` device: every leaf's shape and
    dtype, no values and no allocation (the counterpart of
    ``jax.eval_shape`` over ``init_params``)."""
    return _init_params(cfg, MetaGenerator(), torch.device("meta"))


def _init_params(cfg: ModelConfig, gen, dev) -> Dict[str, Any]:
    dtype = dtype_of(cfg.param_dtype)
    plan = layer_plan(cfg)
    params: Dict[str, Any] = {}
    params["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                           dtype)
    if plan["kind"] == "vlm":
        ng, spg = plan["n_groups"], plan["self_per_group"]
        params["layers"] = tree_map(
            lambda x: x.view((ng, spg) + tuple(x.shape[1:])),
            _init_stack(gen, cfg, dtype, ng * spg))
        params["cross_layers"] = _init_stack(gen, cfg, dtype, ng, "cross")
    else:
        params["layers"] = _init_stack(gen, cfg, dtype, cfg.n_layers)
    if _needs_norms(cfg.block_style):
        params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if cfg.conv_pos_width:
        params["conv_pos"] = init_conv_pos(gen, cfg.d_model,
                                           cfg.conv_pos_width, dtype)
    return params


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def layer_params(params, i: int):
    """Layer ``i``'s slice (views) of the stacked layer tree."""
    return tree_map(lambda x: x[i], params["layers"])


def block_sequence(params, cfg: ModelConfig):
    """The blocks in the order the stream runs through them: (kind, block
    params (views), index) where ``index`` is the block's row in the
    cache's self-attention K/V (k/v's leading axis) or, for a VLM's cross
    block, its group (cross_k/cross_v's leading axis).  A VLM runs
    self(g, 0) … self(g, spg - 1), cross(g) for each group g."""
    plan = layer_plan(cfg)
    if plan["kind"] != "vlm":
        for i in range(cfg.n_layers):
            yield plan["kind"], layer_params(params, i), i
        return
    spg = plan["self_per_group"]
    for g in range(plan["n_groups"]):
        for s in range(spg):
            yield "attn", tree_map(lambda x: x[g, s], params["layers"]), \
                g * spg + s
        yield "cross", tree_map(lambda x: x[g], params["cross_layers"]), g


# ---------------------------------------------------------------------------
# attention sub-module apply (projections + rope + core)
# ---------------------------------------------------------------------------

def _project_qkv(lp, cfg: ModelConfig, u, kv_src, merged: bool):
    """u: (B,S,d) query-side stream; kv_src: (B,Sk,d) key/value source.  In
    merged styles the projection named by ``cfg.merged_variant`` is the
    identity: the stream is already in its output basis (Fig 2b/c/d).
    Under a mesh whose model axis does not split the heads
    (``sharding.heads_split``) each projection's column split is gathered
    before the reshape into heads (``placed.head_layout``)."""
    Dh = cfg.d_head
    variant = cfg.merged_variant if merged else ""

    def proj(name, src):
        y = src @ lp["w" + name].to(u.dtype)
        if "b" + name in lp:
            y = y + lp["b" + name].to(u.dtype)
        return y

    q = u if variant == "qp" else proj("q", u)
    k = kv_src if variant == "kp" else proj("k", kv_src)
    v = kv_src if variant == "vp" else proj("v", kv_src)
    B, Sq, Sk = u.shape[0], u.shape[1], kv_src.shape[1]
    Hkv = cfg.n_kv_heads
    return (head_layout(q, Hkv).reshape(B, Sq, cfg.n_heads, Dh),
            head_layout(k, Hkv).reshape(B, Sk, Hkv, Dh),
            head_layout(v, Hkv).reshape(B, Sk, Hkv, Dh))


def _rope(cfg: ModelConfig, x, positions):
    return apply_rope(x, positions, style=cfg.rope_style, theta=cfg.rope_theta,
                      fraction=cfg.rope_fraction)


def _self_attention_seq(lp, cfg: ModelConfig, u, positions, merged: bool,
                        impl: str, merged_core: bool = False,
                        cache_kind: str = "dense", q8_block: int = 0,
                        q8_true_len=None, qkv_sharding=None):
    """``merged_core`` selects the stream-as-query core (merged qp layouts:
    q is an identity view of u, so every tensor stays in its native
    layout — the prefill twin of the merged decode fast path).

    ``q8_block`` > 0 (the int8 pool's prefill) quantizes K/V at pool
    granularity, one scale per ``q8_block`` tokens and kv head, positions
    >= ``q8_true_len`` zeroed first, and attends over the QUANTIZED view
    (dequantized in the kernel on the merged route, upstream otherwise), so
    the prompt's logits see exactly the bits ``_finish_paged_q8`` stores.
    What is collected is then those bits, (k ints, k scales, v ints,
    v scales), not the float K/V: the finish step writes them as they
    are.

    ``qkv_sharding`` (a spec, under a mesh) re-anchors q/k/v to the head
    placement: merged styles have no wq matmul to propagate it from."""
    q, k, v = _qkv_reanchor(qkv_sharding, *_project_qkv(lp, cfg, u, u,
                                                         merged))
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    B, S = u.shape[0], u.shape[1]
    if q8_block:
        valid = None if q8_true_len is None else \
            positions < q8_true_len[:, None]
        # whole K/V under a mesh: page-sized blocks of a sequence that
        # DTensor may hold split (or as a pending sum) do not reshape
        kq, ksc = quant.q8_quantize_seq(full(k), q8_block, valid)
        vq, vsc = quant.q8_quantize_seq(full(v), q8_block, valid)
        if merged_core:
            out = attn_mod.attention_core_merged(
                q.reshape(B, S, cfg.attn_dim), kq, vq, q_positions=positions,
                kv_positions=positions, n_kv_heads=cfg.n_kv_heads,
                causal=cfg.causal, sliding_window=cfg.sliding_window,
                impl=impl, query_chunk=cfg.query_chunk or S,
                cache_kind=cache_kind, k_scale=ksc, v_scale=vsc)
            return out, (kq, ksc, vq, vsc)
        out = attn_mod.attention_core(
            q, quant.q8_dequant_seq(kq, ksc, k.dtype),
            quant.q8_dequant_seq(vq, vsc, v.dtype), q_positions=positions,
            kv_positions=positions, causal=cfg.causal,
            sliding_window=cfg.sliding_window, impl=impl,
            query_chunk=cfg.query_chunk or S)
        return out.reshape(B, S, cfg.attn_dim), (kq, ksc, vq, vsc)
    if merged_core:
        out = attn_mod.attention_core_merged(
            q.reshape(B, S, cfg.attn_dim), k, v, q_positions=positions,
            kv_positions=positions, n_kv_heads=cfg.n_kv_heads,
            causal=cfg.causal, sliding_window=cfg.sliding_window, impl=impl,
            query_chunk=cfg.query_chunk or S, cache_kind=cache_kind)
        return out, (k, v)
    out = attn_mod.attention_core(
        q, k, v, q_positions=positions, kv_positions=positions,
        causal=cfg.causal, sliding_window=cfg.sliding_window, impl=impl,
        query_chunk=cfg.query_chunk or S)
    return out.reshape(B, S, cfg.attn_dim), (k, v)


def _qkv_reanchor(spec, q, k, v):
    """q/k/v redistributed to ``spec`` (``sharding.qkv_pspec``) when they
    are DTensors: the counterpart of the reference's
    ``with_sharding_constraint`` on merged layouts.  Where the kv heads do
    not divide the model axis (``sharding.heads_split``) they stay whole,
    and so do the query heads: a split of each kv head's query group is
    not a layout the grouped attention below can keep (DTensor cannot
    flatten it)."""
    if spec is None or not is_placed(k):
        return q, k, v
    kv_spec = shd.evenly(spec, k, k.device_mesh)
    if not shd.heads_split(k.shape[2], model_axis_size(k)):
        spec = kv_spec = shd.P(kv_spec[0], None, None, None)
    return reanchor(q, spec), reanchor(k, kv_spec), reanchor(v, kv_spec)


def _cross_attention_seq(lp, cfg: ModelConfig, u, vision, merged: bool,
                         impl: str):
    """Cross-attention over a sequence: queries from the stream u (B,S,d),
    K/V from the vision tokens (B,nv,d), no RoPE, every query attending
    every vision token (``causal=False``: on ``impl="cuda"`` the generic
    flash kernel's non-causal branch, Sk = nv).  Returns (cat (B,S,ad),
    (k, v)), k/v (B, nv, Hkv, Dh): what the cache keeps as cross K/V."""
    q, k, v = _project_qkv(lp, cfg, u, vision, merged)
    B, S, nv = u.shape[0], u.shape[1], vision.shape[1]
    dev = u.device
    qpos = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
    kpos = torch.arange(nv, dtype=torch.int32, device=dev).expand(B, nv)
    out = attn_mod.attention_core(q, k, v, q_positions=qpos, kv_positions=kpos,
                                  causal=False, sliding_window=0, impl=impl,
                                  query_chunk=cfg.query_chunk or S)
    return out.reshape(B, S, cfg.attn_dim), (k, v)


def _attn_out_proj(lp, cat):
    """cat (B, S, attn_dim) @ wp.  Under a mesh ``cat`` is split as wp's
    rows are first (``placed.row_split``): heads the model axis does not
    split come whole out of the cores, and their gradient then goes back
    whole, into the reshapes that made them."""
    w = lp["wp"]
    return row_split(cat, w) @ w.to(cat.dtype)


def _apply_ffn(p, cfg: ModelConfig, x, dropless: bool = False):
    """The dense FFN or the MoE -> (out, aux_loss); ``dropless`` routes
    every (token, choice) pair (chunk and decode programs).  A dense FFN's
    aux is the Python float 0.0: a device zero would be one more launch
    per layer and decode step.  The profiler range ``model::ffn`` while
    the serving engine's observer is armed and a profiler records."""
    with get_active().range("model::ffn"):
        if "moe" in p:
            return moe_mod.apply_moe(
                p["moe"], x, n_experts=cfg.n_experts,
                experts_per_token=cfg.experts_per_token,
                capacity_factor=cfg.capacity_factor, ffn_type=cfg.ffn_type,
                dropless=dropless, impl=cfg.moe_impl,
                group_size=cfg.moe_group or x.shape[0] * x.shape[1])
        return ffn_mod.apply_ffn(p["ffn"], x, cfg.ffn_type), 0.0


def _ranged_mixer(mixer_fn):
    """``mixer_fn`` under the profiler range ``model::attn`` (as
    ``_apply_ffn``'s ``model::ffn``)."""
    def mixer(x):
        with get_active().range("model::attn"):
            return mixer_fn(x)
    return mixer


def _apply_style(p, cfg: ModelConfig, u, mixer_fn, dropless: bool = False):
    """The block-style wiring shared by the sequence and the step paths:
    where the norms, skips, mixer and FFN sit (paper Figs 1, 3, 4) ->
    (out, aux_loss)."""
    style = cfg.block_style
    mixer_fn = _ranged_mixer(mixer_fn)
    if style in ("standard", "residual_qpfree"):
        if cfg.parallel_block:
            n = apply_rmsnorm(p["norm1"], u)
            f, aux = _apply_ffn(p, cfg, n, dropless)
            return u + mixer_fn(n) + f, aux
        h = u + mixer_fn(apply_rmsnorm(p["norm1"], u))
        f, aux = _apply_ffn(p, cfg, apply_rmsnorm(p["norm2"], h), dropless)
        return h + f, aux
    if style in ("skipless", "skipless_merged"):
        if cfg.parallel_block:
            f, aux = _apply_ffn(p, cfg, u, dropless)
            out = mixer_fn(u) + f
        else:
            out, aux = _apply_ffn(p, cfg, mixer_fn(u), dropless)
        if style == "skipless_merged" and "b_out" in p:
            # folded b_q of the NEXT block (affine merge)
            out = out + p["b_out"].to(out.dtype)
        return out, aux
    raise ValueError(style)


def apply_block_seq(p, cfg: ModelConfig, u, ctx, kind: Optional[str] = None):
    """One block over a sequence -> (out_stream, aux_loss, kv, state).
    ``kind`` is the plan's by default ("cross" for a VLM's cross block,
    which reads ``ctx["vision"]``).
    ``aux_loss`` is the MoE load-balance loss (the float 0.0 without
    experts); the MoE drops pairs by ``capacity_factor``.  ``kv`` is
    (k, v), or (k ints, k scales, v ints, v scales) under
    ``ctx["q8_block"]``, for blocks with attention (a cross block's over
    the vision tokens), else None; ``state`` is the SSM mixer's
    ``SSMState`` after the last position (final scan state and conv tail)
    for blocks with one, else None."""
    merged = _is_merged(cfg.block_style)
    kind = _block_kind(cfg, kind)
    kv, st = [None], [None]

    def ssm_fn(x):
        out, st[0] = m2.apply_mamba2_seq(p["ssm"], x, cfg, return_state=True,
                                         impl=ctx["impl"])
        return out

    if kind == "ssm":
        if cfg.block_style != "standard":  # skipless: no skip, no norm
            return ssm_fn(u), 0.0, None, st[0]
        x = apply_rmsnorm(p["norm1"], u) if "norm1" in p else u
        return u + ssm_fn(x), 0.0, None, st[0]

    def mixer_fn(x):
        if kind == "cross":
            cat, kv[0] = _cross_attention_seq(p["attn"], cfg, x,
                                              ctx["vision"], merged,
                                              ctx["impl"])
            return cat if merged else _attn_out_proj(p["attn"], cat)
        cat, kv[0] = _self_attention_seq(
            p["attn"], cfg, x, ctx["positions"], merged, ctx["impl"],
            merged_core=ctx.get("merged_core", False),
            cache_kind=ctx.get("cache_kind", "dense"),
            q8_block=ctx.get("q8_block", 0),
            q8_true_len=ctx.get("q8_true_len"),
            qkv_sharding=ctx.get("qkv_sharding"))
        if kind == "hybrid":  # P stays: mean-fuse with the SSM heads
            return 0.5 * (_attn_out_proj(p["attn"], cat) + ssm_fn(x))
        return cat if merged else _attn_out_proj(p["attn"], cat)

    out, aux = _apply_style(p, cfg, u, mixer_fn)
    return out, aux, kv[0], st[0]


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def embed_inputs(params, cfg: ModelConfig, tokens_or_frames):
    cdt = dtype_of(cfg.dtype)
    if not torch.is_floating_point(tokens_or_frames):
        h = apply_embedding(params["embed"], tokens_or_frames, cdt)
        if cfg.block_style in ("skipless", "skipless_merged"):
            # skipless stacks have no residual to carry scale and GLU FFNs
            # attenuate sub-unit signals quadratically, so 0.02-std
            # embeddings collapse; scale them to the GLU fixed point
            h = h * (2.0 / 0.02)
    else:
        h = tokens_or_frames.to(cdt)  # stubbed modality frontend output
    if "conv_pos" in params:
        h = apply_conv_pos(params["conv_pos"], h)
    # merged models: frame inputs cannot fold Q_0 into a table, so the
    # merge keeps Q_0 as an explicit input projection
    if "input_proj" in params:
        h = h @ params["input_proj"].to(h.dtype)
    if "embed_bias" in params:  # folded b_q of the first block (affine merge)
        h = h + params["embed_bias"].to(h.dtype)
    return h


def _logits(params, cfg: ModelConfig, h):
    if "final_norm" in params:
        h = apply_rmsnorm(params["final_norm"], h)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return apply_unembedding(table, h)


# the ops whose outputs remat="dots" keeps (the counterpart of JAX's
# ``checkpoint_policies.dots_saveable``): every matmul the blocks run
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _DOT_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(block_fn, h, remat):
    """``block_fn(h) -> (h, aux)`` under the activation checkpointing
    ``remat`` asks for: False runs it as it is; True keeps only the
    block's input and recomputes the rest in the backward pass; "dots"
    also keeps every matmul output and recomputes the cheap elementwise
    and softmax work between them."""
    if not remat:
        return block_fn(h)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if remat == "dots":
        return checkpoint(block_fn, h, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _dots_saveable))
    if remat is not True:
        raise ValueError(f"remat must be False, True or 'dots', got "
                         f"{remat!r}")
    return checkpoint(block_fn, h, use_reentrant=False)


def _run_stack(params, cfg: ModelConfig, inputs, *, positions=None,
               vision=None, impl: str = "torch", collect: bool = False,
               merged_core: bool = False, cache_kind: str = "dense",
               q8_block: int = 0, q8_true_len=None, remat=False,
               qkv_sharding=None, stream_sharding=None):
    """Embed, every block, the logits -> (logits, aux, kvs, states):
    ``aux`` sums the layers' MoE load-balance losses (0.0 without
    experts).  With
    ``collect``: ``kvs`` stacks the self-attention layers' K/V (None
    without attention), followed on a VLM by its cross layers' K/V over
    the vision tokens, and ``states`` the SSM layers' ``SSMState``s,
    (L, B, …) each (None without SSM layers).  ``vision`` (B, nv, d) is
    required by a VLM and refused by every other stack.  ``remat``
    (False, True or "dots", ``_remat_block``) checkpoints each block for
    training; it collects nothing, so it cannot be combined with
    ``collect``.  Under a mesh ``qkv_sharding`` re-anchors each layer's
    q/k/v and ``stream_sharding`` the stream after each block (specs;
    ``reanchor``)."""
    if collect and remat:
        raise ValueError("remat keeps no K/V or SSM state: it cannot be "
                         "combined with collect")
    if (vision is not None) != (layer_plan(cfg)["kind"] == "vlm"):
        raise ValueError(
            f"{cfg.name}: vision tokens are " +
            ("required (a VLM's cross-attention layers read them)"
             if vision is None else "only for a VLM's cross-attention"))
    B, S = inputs.shape[0], inputs.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=inputs.device).expand(B, S)
    h = embed_inputs(params, cfg, inputs)
    ctx = {"positions": positions, "impl": impl, "merged_core": merged_core,
           "cache_kind": cache_kind, "q8_block": q8_block,
           "q8_true_len": q8_true_len, "qkv_sharding": qkv_sharding,
           "vision": None if vision is None else vision.to(h.dtype)}
    kv_layers, cross_layers, st_layers = [], [], []
    aux = 0.0
    for kind, lp, _ in block_sequence(params, cfg):
        if remat:
            # the checkpointed function returns only (h, aux), so that no
            # block's K/V outlives its forward
            h, a = _remat_block(
                lambda x, lp=lp, kind=kind:
                apply_block_seq(lp, cfg, x, ctx, kind)[:2], h, remat)
            kv = st = None
        else:
            h, a, kv, st = apply_block_seq(lp, cfg, h, ctx, kind)
        h = reanchor(h, stream_sharding)
        aux = aux + a
        if collect and kv is not None:
            (cross_layers if kind == "cross" else kv_layers).append(kv)
        if collect and st is not None:
            st_layers.append(st)
    kvs = tuple(torch.stack(t) for t in zip(*kv_layers)) \
        + tuple(torch.stack(t) for t in zip(*cross_layers)) \
        if kv_layers else None
    states = m2.SSMState(*(torch.stack(t) for t in zip(*st_layers))) \
        if st_layers else None
    return _logits(params, cfg, h), aux, kvs, states


def forward_seq(params, cfg: ModelConfig, inputs, *, positions=None,
                vision=None, impl: str = "torch", collect_kv: bool = False,
                merged_core: bool = False, cache_kind: str = "dense",
                q8_block: int = 0, q8_true_len=None, remat=False,
                qkv_sharding=None, stream_sharding=None):
    """Full-sequence forward over int tokens (B,S), or an encoder's frames
    (B,S,d_model), -> (logits, aux, kvs).  A VLM takes ``vision``
    (B, nv, d_model) patch embeddings, which its cross layers attend; an
    encoder (``causal=False``) attends non-causally.

    ``aux`` is the sum of the layers' MoE load-balance losses (0 without
    experts); the MoE drops pairs by ``capacity_factor`` over groups of
    ``moe_group`` (or B·S) tokens, as whole-prompt prefill does.

    ``kvs`` is (k, v), each (L, B, S, Hkv, Dh), when ``collect_kv`` on a
    stack with attention (None otherwise); a VLM's is (k, v, cross_k,
    cross_v), its self layers flattened (n_groups · self_per_group, B, S,
    Hkv, Dh) and its cross layers' (n_groups, B, nv, Hkv, Dh).
    ``merged_core`` routes self-attention through the stream-as-query
    merged core (prefill backends set it for merged qp layouts).
    ``q8_block``/``q8_true_len`` (the int8 pool's prefill) make every
    layer attend over its pool-granularity QUANTIZED K/V, and ``kvs`` is
    then those bits: (k ints, k scales, v ints, v scales), the ints
    (L, B, S, Hkv, Dh) int8 and the scales (L, B, S // q8_block, Hkv)
    float32 (``_self_attention_seq``).
    ``remat`` (False, True or "dots") checkpoints each block for training,
    as the reference's ``_scan_blocks_seq`` does; with ``collect_kv`` it
    raises ValueError.  ``qkv_sharding`` / ``stream_sharding``: specs that
    re-anchor q/k/v and the stream under a mesh (``_run_stack``)."""
    logits, aux, kvs, _ = _run_stack(
        params, cfg, inputs, positions=positions, vision=vision, impl=impl,
        collect=collect_kv, merged_core=merged_core, cache_kind=cache_kind,
        q8_block=q8_block, q8_true_len=q8_true_len, remat=remat,
        qkv_sharding=qkv_sharding, stream_sharding=stream_sharding)
    if not torch.is_tensor(aux):
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, kvs


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *,
            z_loss: float = 1e-4, ignore_index: int = -100,
            vocab_size: int = 0) -> torch.Tensor:
    """Token-mean cross entropy (float32) + z-loss ``z_loss * lse**2``;
    labels (B, S) int, ``ignore_index`` positions left out of the mean.

    ``vocab_size``: the logical vocab: logits of padded ids (>=
    vocab_size) are masked out of the softmax (``ModelConfig.
    padded_vocab``).  At a full vocab each float32 (B, S, V) buffer is
    GBs: the masked copy is made only when there is padding, and what
    autograd keeps is logsumexp's input and output."""
    logits = logits.float()
    V = logits.shape[-1]
    if vocab_size and vocab_size < V:
        pad = torch.arange(V, device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    # a vocab split over the mesh is gathered for the label pick (DTensor
    # cannot gather along a split dim)
    gold = whole_dim(logits, -1).gather(
        -1, labels.clamp_min(0).long()[..., None])[..., 0]
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    mask = (labels != ignore_index).float()
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    k: Optional[torch.Tensor]  # (L, B, Sc, Hkv, Dh), Sc = window or max_len
    v: Optional[torch.Tensor]  # (k, v and kv_pos are None for ssm stacks)
    kv_pos: Optional[torch.Tensor]  # (B, Sc) int32, -1 = empty (all layers)
    length: torch.Tensor  # (B,) int32 — tokens so far (= next position)
    ssm: Optional[m2.SSMState] = None  # stacked (L, …) for ssm / hybrid
    cross_k: Optional[torch.Tensor] = None  # VLM: (n_groups, B, nv, Hkv, Dh)
    cross_v: Optional[torch.Tensor] = None


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shapes and dtypes of an empty cache: k, v and kv_pos for stacks
    with self-attention (a VLM's self layers flattened), ssm (a dict of
    the state and the conv tail) for stacks with SSM layers, cross_k and
    cross_v for a VLM."""
    plan = layer_plan(cfg)
    n, n_attn = cfg.n_layers, n_attn_layers(cfg)
    cdt = dtype_of(cfg.dtype)
    spec: Dict[str, Any] = {}
    if n_attn:
        Sc = min(max_len, cfg.sliding_window) if cfg.sliding_window \
            else max_len
        kv = ((n_attn, batch, Sc, cfg.n_kv_heads, cfg.d_head), cdt)
        spec.update(k=kv, v=kv, kv_pos=((batch, Sc), torch.int32))
    spec["length"] = ((batch,), torch.int32)
    if cfg.ssm_state:
        spec["ssm"] = {
            "ssm": ((n, batch, cfg.ssm_n_heads, cfg.ssm_head_dim,
                     cfg.ssm_state), torch.float32),
            "conv": ((n, batch, cfg.ssm_conv_width - 1,
                      m2.conv_channels(cfg)), torch.float32)}
    if plan["kind"] == "vlm":
        cross = ((plan["n_groups"], batch, cfg.n_vision_tokens,
                  cfg.n_kv_heads, cfg.d_head), cdt)
        spec.update(cross_k=cross, cross_v=cross)
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> DecodeCache:
    _require_decoder(cfg, "the decode cache")
    dev = resolve_device(device)
    spec = cache_spec(cfg, batch, max_len)

    def full(name, fill, sub=spec):
        if name not in sub:
            return None
        shape, dt = sub[name]
        return torch.full(shape, fill, dtype=dt, device=dev)

    ssm = None if "ssm" not in spec else m2.SSMState(
        ssm=full("ssm", 0, spec["ssm"]), conv=full("conv", 0, spec["ssm"]))
    return DecodeCache(k=full("k", 0), v=full("v", 0),
                       kv_pos=full("kv_pos", -1), length=full("length", 0),
                       ssm=ssm, cross_k=full("cross_k", 0),
                       cross_v=full("cross_v", 0))


# ---------------------------------------------------------------------------
# paged decode cache: pools of physical pages behind per-slot block tables
# (the serving layer allocates and frees pages on the host,
# ``serving.paged_kv_cache``; this module only consumes the device view)
# ---------------------------------------------------------------------------

class PagedDecodeCache(NamedTuple):
    """Device view of the paged KV cache (attention-only stacks).

    ``k``/``v`` are pools of physical pages shared by every serving slot;
    ``block_tables[b, j]`` maps slot b's logical block j to a physical
    page (-1 = unmapped).  Sliding-window configs bound the table at
    ``ceil(window/bs)+1`` RING slots (absolute block j lives at slot
    j % ring and out-of-window pages are recycled in place); readers
    rebuild each slot's absolute positions from ``length``
    (``kernels.paging``).  Page content beyond a slot's ``length`` may be
    stale (freed, reused or recycled pages are not scrubbed): the causal
    mask hides it, and decode always writes position ``length`` before
    attending.  ``forward_step`` writes the pools in place."""
    k: torch.Tensor  # (L, n_blocks, block_size, Hkv, Dh) — physical pages
    v: torch.Tensor
    block_tables: torch.Tensor  # (B, MB) int32 page ids, -1 unmapped
    length: torch.Tensor  # (B,) int32 — tokens so far (= next position)


def paged_table_blocks(cfg: ModelConfig, block_size: int, max_len: int) -> int:
    """Block-table width for one serving slot: ``ceil(max_len/bs)`` slots
    in absolute addressing, or the ring bound ``ceil(window/bs)+1`` when a
    sliding window makes that strictly smaller (``kernels.paging``)."""
    mb = -(-max_len // block_size)
    r = paging.paged_ring_blocks(cfg.sliding_window, block_size)
    return r if 0 < r < mb else mb


def paged_cache_spec(cfg: ModelConfig, n_blocks: int, block_size: int,
                     n_slots: int, max_len: int):
    """Shapes and dtypes of an empty paged cache."""
    plan = layer_plan(cfg)
    if plan["kind"] != "attn":
        raise ValueError(
            f"paged KV cache supports attention-only stacks, not "
            f"{plan['kind']!r} (family {cfg.family!r})")
    mb = paged_table_blocks(cfg, block_size, max_len)
    pool = ((plan["n"], n_blocks, block_size, cfg.n_kv_heads, cfg.d_head),
            dtype_of(cfg.dtype))
    return {"k": pool, "v": pool,
            "block_tables": ((n_slots, mb), torch.int32),
            "length": ((n_slots,), torch.int32)}


def init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                     n_slots: int, max_len: int,
                     device="cuda") -> PagedDecodeCache:
    """An empty paged cache.  The pools are zeros, never uninitialised
    memory: the plain route gathers page 0 for unmapped entries and masks
    it, and a NaN there would survive the mask (NaN * 0)."""
    spec = paged_cache_spec(cfg, n_blocks, block_size, n_slots, max_len)
    dev = resolve_device(device)

    def full(name, fill):
        shape, dt = spec[name]
        return torch.full(shape, fill, dtype=dt, device=dev)

    return PagedDecodeCache(k=full("k", 0), v=full("v", 0),
                            block_tables=full("block_tables", -1),
                            length=full("length", 0))


class PagedQ8DecodeCache(NamedTuple):
    """Device view of the int8 paged KV cache: the ``PagedDecodeCache``
    contract with int8 pools and per-(page, kv-head) float32 scales
    (``kernels.quant``).  A page's scale rows are part of the page:
    copy-on-write copies them with the ints
    (``serving.paged_kv_cache.copy_block_q8``), and a recycled page's stale
    scale is hidden like its stale ints (decode resets the scale when it
    enters the page at offset 0).  ``forward_step`` writes pools and
    scales in place."""
    k: torch.Tensor  # (L, n_blocks, block_size, Hkv, Dh) int8 pages
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, n_blocks, Hkv) float32
    v_scale: torch.Tensor
    block_tables: torch.Tensor  # (B, MB) int32 page ids, -1 unmapped
    length: torch.Tensor  # (B,) int32 — tokens so far (= next position)


def paged_q8_cache_spec(cfg: ModelConfig, n_blocks: int, block_size: int,
                        n_slots: int, max_len: int):
    """Shapes and dtypes of an empty int8 paged cache."""
    spec = paged_cache_spec(cfg, n_blocks, block_size, n_slots, max_len)
    pool = (spec["k"][0], torch.int8)
    scale = ((spec["k"][0][0], n_blocks, cfg.n_kv_heads), torch.float32)
    return {"k": pool, "v": pool, "k_scale": scale, "v_scale": scale,
            "block_tables": spec["block_tables"], "length": spec["length"]}


def init_paged_q8_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                        n_slots: int, max_len: int,
                        device="cuda") -> PagedQ8DecodeCache:
    """An empty int8 paged cache: zero ints and zero scales (an unmapped
    page gathered by the plain route dequantizes to finite zeros)."""
    spec = paged_q8_cache_spec(cfg, n_blocks, block_size, n_slots, max_len)
    dev = resolve_device(device)

    def full(name, fill):
        shape, dt = spec[name]
        return torch.full(shape, fill, dtype=dt, device=dev)

    return PagedQ8DecodeCache(
        k=full("k", 0), v=full("v", 0), k_scale=full("k_scale", 0),
        v_scale=full("v_scale", 0), block_tables=full("block_tables", -1),
        length=full("length", 0))


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the cache
# ---------------------------------------------------------------------------

def _last_logits_and_length(logits, true_len, B, S):
    """The last REAL position's logits (bucketed prompts are right-padded;
    causality keeps positions < true_len exact)."""
    dev = logits.device
    if true_len is None:
        return logits[:, -1, :], torch.full((B,), S, dtype=torch.int32,
                                            device=dev)
    true_len = torch.as_tensor(true_len, dtype=torch.int32, device=dev)
    true_len = true_len.reshape(-1).expand(B)
    last = logits[torch.arange(B, device=dev), true_len.long() - 1]
    return last, true_len.clone()


class DensePrefillDest(NamedTuple):
    """Destination of a dense prefill: a fresh ``DecodeCache`` of
    ``cache_len`` positions.  ``full_cache`` keeps it ``cache_len`` long
    even for sliding-window configs (whose serving cache is a window-sized
    ring)."""
    cache_len: int
    full_cache: bool = False


class PagedPrefillDest(NamedTuple):
    """Destination of a direct-to-page paged prefill: the prompt's KV is
    written straight into the mapped physical blocks of the pools, in
    place — no worst-case-length intermediate cache.

    ``k_pool``/``v_pool`` are (L, NB, bs, Hkv, Dh) page pools;
    ``block_ids`` is a (ceil(S/bs),) int tensor mapping this request's
    logical (absolute) block j to its physical page, with -1 for blocks
    that must NOT be written: prefix-shared pages already holding the
    prefix (possibly extended by another live request's decoded tokens),
    bucket-padding blocks past the prompt, and, under a sliding window,
    prompt blocks wholly out of every future query's window (a windowed
    request's table is a ring of ceil(window/bs)+1 recycled slots and only
    the live window's blocks are mapped — ``kernels.paging``)."""
    k_pool: Any
    v_pool: Any
    block_ids: Any


class PagedQ8PrefillDest(NamedTuple):
    """Destination of a direct-to-page prefill into the int8 pool: the
    ``PagedPrefillDest`` contract over int8 pools (L, NB, bs, Hkv, Dh) and
    their (L, NB, Hkv) float32 scales.  The prefill quantizes the prompt's
    KV at pool granularity and writes ints AND scales of the mapped blocks
    only, in place: no float pool exists.  The (padded) prompt length must
    be a multiple of the page size: pages are quantized whole."""
    k_pool: Any
    v_pool: Any
    k_scale: Any
    v_scale: Any
    block_ids: Any


def prefill_style_key(cfg: ModelConfig) -> str:
    """Style axis of the PREFILL registry key: "merged" iff every layer can
    run the stream-as-query core (qp variant of the merged styles on
    attention stacks); kp/vp stay "generic" (their eliminated projection
    is an identity inside ``_project_qkv``), and so do ssm, hybrid and
    vlm stacks (the hybrid keeps P; the VLM's cross layers attend vision
    tokens, so a merged VLM decodes merged but prefills generic)."""
    if layer_plan(cfg)["kind"] != "attn":
        return "generic"
    if cfg.block_style in ("skipless_merged", "residual_qpfree") \
            and cfg.merged_variant == "qp":
        return "merged"
    return "generic"


def _prefill_seq(params, cfg: ModelConfig, inputs, ctx, *,
                 merged_core: bool, cache_kind: str):
    """The full-sequence pass every prefill backend starts with ->
    (logits, kvs, SSM states) (``_run_stack``)."""
    logits, _, kvs, states = _run_stack(
        params, cfg, inputs, vision=ctx.get("vision"),
        impl=ctx.get("impl", "torch"), collect=True,
        merged_core=merged_core, cache_kind=cache_kind,
        qkv_sharding=ctx.get("qkv_sharding"))
    return logits, kvs, states


def _finish_dense(params, cfg: ModelConfig, inputs, logits, kvs, states,
                  dest: DensePrefillDest, ctx, B: int, S: int):
    """Place the collected prompt KV into a fresh ``DecodeCache`` (ring-
    phased under a sliding window) beside the SSM layers' states after the
    last position (a VLM: beside its cross K/V over the vision tokens, in
    their native (n_groups, B, nv, Hkv, Dh) layout), and gather the last
    real logits.  SSM state is not
    position-masked: a right-padded prompt would carry its padding into
    it, so the engine never buckets stacks with SSM layers."""
    true_len = ctx.get("true_len")
    last_logits, length = _last_logits_and_length(logits, true_len, B, S)
    if kvs is None:  # attention-free: the SSM states are the whole cache
        return last_logits, DecodeCache(k=None, v=None, kv_pos=None,
                                        length=length, ssm=states)
    cache_cfg = cfg.with_(sliding_window=0) if dest.full_cache else cfg
    (_, _, Sc, _, _), kv_dtype = cache_spec(cache_cfg, B, dest.cache_len)["k"]

    def place(kv_stacked):
        # (L, B, S, Hkv, Dh) -> the last Sc positions ROLLED into ring
        # phase: decode writes position p at slot p % Sc, so position
        # S-Sc+i must land at index (S-Sc+i) % Sc
        if S >= Sc:
            kept = kv_stacked[:, :, S - Sc:]
            shift = (S - Sc) % Sc
            return torch.roll(kept, shift, dims=2) if shift else kept
        out = kv_stacked.new_zeros(kv_stacked.shape[:2] + (Sc,) +
                                   kv_stacked.shape[3:])
        put_(out, (slice(None), slice(None), slice(0, S)), kv_stacked)
        return out

    ks, vs = kvs[:2]
    cross = {} if len(kvs) == 2 else {
        "cross_k": kvs[2].to(kv_dtype).contiguous(),
        "cross_v": kvs[3].to(kv_dtype).contiguous()}
    k = place(ks).to(kv_dtype)
    v = place(vs).to(kv_dtype)
    pos = torch.arange(Sc, dtype=torch.int32, device=inputs.device)[None, :] \
        + max(S - Sc, 0)
    limit = S if true_len is None else length[:, None]
    kvp = torch.where(pos < limit, pos, -1).to(torch.int32).expand(B, Sc)
    if S >= Sc and (S - Sc) % Sc:  # match place()'s ring phase
        kvp = torch.roll(kvp, (S - Sc) % Sc, dims=1)
    return last_logits, DecodeCache(k=k.contiguous(), v=v.contiguous(),
                                    kv_pos=kvp.contiguous(), length=length,
                                    ssm=states, **cross)


def _finish_paged(cfg: ModelConfig, logits, kvs, dest: PagedPrefillDest, ctx,
                  B: int, S: int):
    """Write the collected prompt KV direct-to-page, in place, and gather
    the last real position's logits.  JAX drops the -1 destinations with
    ``mode="drop"``; torch has no such mode (an out-of-range index raises
    or corrupts), so only the blocks with a destination >= 0 are selected
    and written: shared-prefix pages, bucket-padding blocks and
    out-of-window blocks are never touched.  Under a mesh the pools are
    DTensors and each rank writes the pages it holds (``_kept_pages``)
    from the whole prompt KV."""
    k_pool, v_pool, block_ids = dest
    last_logits, _ = _last_logits_and_length(logits, ctx.get("true_len"), B, S)
    ks, vs = (full(x) for x in kvs)  # (L, 1, S, Hkv, Dh)
    L, bs = k_pool.shape[0], k_pool.shape[2]
    nbk = block_ids.shape[0]
    (k_l, v_l), keep, dst = _kept_pages((k_pool, v_pool), block_ids)

    def blocks(x):  # (L, 1, S, Hkv, Dh) -> the kept (L, n, bs, Hkv, Dh)
        x = torch.nn.functional.pad(x[:, 0], (0, 0, 0, 0, 0, nbk * bs - S))
        return x.reshape(L, nbk, bs, *x.shape[2:])[:, keep]

    k_l[:, dst] = blocks(ks).to(k_l.dtype)
    v_l[:, dst] = blocks(vs).to(v_l.dtype)
    return last_logits, (k_pool, v_pool)


def _kept_pages(pools, block_ids):
    """What a prefill or a chunk writes on this rank: the local tensors of
    ``pools`` (stacked (L, NB, ...) pools and scales), the indices of the
    blocks whose destination this rank holds (``keep``) and their local
    pages (``dst``).  A plain pool holds every page, so ``keep`` is the
    blocks with a destination >= 0.  One host sync (``nonzero``)."""
    local, lo, n = zip(*(local_pages(p) for p in pools))
    ids = own_pages(block_ids, lo[0], n[0]) if is_placed(pools[0]) \
        else block_ids
    keep = torch.nonzero(ids >= 0).flatten()
    return local, keep, ids[keep].long()


def _finish_paged_q8(cfg: ModelConfig, logits, kvs, dest: PagedQ8PrefillDest,
                     ctx, B: int, S: int):
    """Write the prompt's int8 K/V and scales, as the prefill attention
    quantized and attended over them (``_self_attention_seq``), into the
    mapped blocks of the pools in place, and gather the last real
    position's logits.  So the pool holds exactly the bits the prompt's
    logits saw.  A mapped block past the prompt (S is a whole number of
    pages) gets what quantizing zeros gives: ints 0, scale ``Q8_EPS``."""
    k_pool, v_pool, k_scale, v_scale, block_ids = dest
    last_logits, _ = _last_logits_and_length(logits, ctx.get("true_len"),
                                             B, S)
    L, bs = k_pool.shape[0], k_pool.shape[2]
    nbk, npb = block_ids.shape[0], S // bs
    (k_pool, v_pool, k_scale, v_scale), keep, dst = _kept_pages(
        dest[:4], block_ids)
    # (L, 1, S, Hkv, Dh) int8, (L, 1, S/bs, Hkv)
    kq, ksc, vq, vsc = (full(x) for x in kvs)

    def blocks(ints, sc):  # -> the kept (L, n, bs, Hkv, Dh), (L, n, Hkv)
        ints = ints[:, 0].reshape(L, npb, bs, *ints.shape[3:])
        ints = torch.nn.functional.pad(ints, (0, 0, 0, 0, 0, 0, 0,
                                              nbk - npb))
        sc = torch.nn.functional.pad(sc[:, 0], (0, 0, 0, nbk - npb),
                                     value=quant.Q8_EPS)
        return ints[:, keep], sc[:, keep]

    for pool, scale, ints, sc in ((k_pool, k_scale, kq, ksc),
                                  (v_pool, v_scale, vq, vsc)):
        pool[:, dst], scale[:, dst] = blocks(ints, sc)
    return last_logits, tuple(dest[:4])


def _prefill_dense_generic(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("dense", "generic"): projects q/k/v as
    the config dictates (kp/vp merged variants pass through)."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, kvs, states = _prefill_seq(params, cfg, inputs, ctx,
                                       merged_core=False, cache_kind="dense")
    return _finish_dense(params, cfg, inputs, logits, kvs, states, dest, ctx,
                         B, S)


def _prefill_dense_merged(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("dense", "merged"): the Q/P-removed
    prefill fast path — every layer runs the stream-as-query core, reads no
    Q or P weights and makes no head-major transposes; the filled cache is
    the same layout as the generic backend's."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, kvs, states = _prefill_seq(params, cfg, inputs, ctx,
                                       merged_core=True, cache_kind="dense")
    return _finish_dense(params, cfg, inputs, logits, kvs, states, dest, ctx,
                         B, S)


def _prefill_paged_generic(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("paged", "generic"): generic projection
    path, prompt KV written direct-to-page into the mapped pool blocks."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, kvs, _ = _prefill_seq(params, cfg, inputs, ctx,
                                  merged_core=False, cache_kind="paged")
    return _finish_paged(cfg, logits, kvs, dest, ctx, B, S)


def _prefill_paged_merged(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("paged", "merged"): stream-as-query
    attention AND direct-to-page KV writes."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, kvs, _ = _prefill_seq(params, cfg, inputs, ctx,
                                  merged_core=True, cache_kind="paged")
    return _finish_paged(cfg, logits, kvs, dest, ctx, B, S)


def _prefill_seq_q8(params, cfg: ModelConfig, inputs,
                    dest: PagedQ8PrefillDest, ctx, *, merged_core: bool):
    """``_prefill_seq`` for the int8 pool: the pool's page size and the
    prompt's true length go into the stack so that every layer attends
    over its K/V quantized at pool granularity."""
    true_len = ctx.get("true_len")
    q8_true_len = None if true_len is None else torch.as_tensor(
        true_len, dtype=torch.int32, device=inputs.device).reshape(
            inputs.shape[0])
    return forward_seq(params, cfg, inputs, impl=ctx.get("impl", "torch"),
                       collect_kv=True, merged_core=merged_core,
                       cache_kind="paged_q8",
                       q8_block=int(dest.k_pool.shape[2]),
                       q8_true_len=q8_true_len)


def _prefill_paged_q8_generic(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("paged_q8", "generic"): the generic
    projection path attending over the dequantized int8 K/V, the prompt's
    KV quantized and written direct-to-page as ints and scales."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, _, kvs = _prefill_seq_q8(params, cfg, inputs, dest, ctx,
                                     merged_core=False)
    return _finish_paged_q8(cfg, logits, kvs, dest, ctx, B, S)


def _prefill_paged_q8_merged(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("paged_q8", "merged"): stream-as-query
    attention over the int8 K*/V*, dequantized inside the kernel, and
    int8 direct-to-page writes."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, _, kvs = _prefill_seq_q8(params, cfg, inputs, dest, ctx,
                                     merged_core=True)
    return _finish_paged_q8(cfg, logits, kvs, dest, ctx, B, S)


backends.register_prefill_backend("dense", "generic", _prefill_dense_generic)
backends.register_prefill_backend("dense", "merged", _prefill_dense_merged,
                                  fast_path=True)
backends.register_prefill_backend("paged", "generic", _prefill_paged_generic)
backends.register_prefill_backend("paged", "merged", _prefill_paged_merged,
                                  fast_path=True)
backends.register_prefill_backend("paged_q8", "generic",
                                  _prefill_paged_q8_generic)
backends.register_prefill_backend("paged_q8", "merged",
                                  _prefill_paged_q8_merged, fast_path=True)


def forward_prefill(params, cfg: ModelConfig, inputs, dest, *,
                    vision=None, impl: str = "torch", true_len=None,
                    qkv_sharding=None):
    """Cache-aware prefill: the single dispatcher over the PREFILL
    registry.  ``dest`` names the destination and selects the cache_kind
    axis of the registry key:

    * ``DensePrefillDest(cache_len, full_cache)`` returns
      (last_token_logits (B, V), ``DecodeCache``);
    * ``PagedPrefillDest(k_pool, v_pool, block_ids)`` writes the prompt's
      KV into the mapped pages of the pools in place and returns
      (last_token_logits (B, V), (k_pool, v_pool));
    * ``PagedQ8PrefillDest(k_pool, v_pool, k_scale, v_scale, block_ids)``
      quantizes it into the int8 pools and their scales, in place, and
      returns (last_token_logits (B, V), (k_pool, v_pool, k_scale,
      v_scale)).

    ``true_len`` (B,) int supports bucketed prompts: ``inputs`` may be
    right-padded, the logits are gathered at ``true_len - 1`` and the
    cache marks padded positions empty (dense: kv_pos = -1; paged: in-page
    positions past the request's length, hidden by the causal mask) with
    ``length = true_len``.  A VLM takes its (B, n_vision_tokens, d_model)
    ``vision`` here (dense cache only: its cross K/V have no pages).
    Invalid requests (an encoder, vision missing or misshapen, paged on a
    non-attention stack, paged batch > 1, too few mapped blocks, an int8
    prompt that is not a whole number of pages, a non-positive dense
    cache_len) raise ValueError; unknown (cache_kind, style, impl) combos
    raise the registry's KeyError.  ``qkv_sharding``: a spec re-anchoring
    q/k/v under a mesh."""
    _require_decoder(cfg, "forward_prefill")
    B, S = int(inputs.shape[0]), int(inputs.shape[1])
    if vision is not None and tuple(vision.shape) != (
            B, cfg.n_vision_tokens, cfg.d_model):
        raise ValueError(f"vision must be (B, n_vision_tokens, d_model) = "
                         f"{(B, cfg.n_vision_tokens, cfg.d_model)}, got "
                         f"{tuple(vision.shape)}")
    if isinstance(dest, (PagedPrefillDest, PagedQ8PrefillDest)):
        quantized = isinstance(dest, PagedQ8PrefillDest)
        kind = "paged_q8" if quantized else "paged"
        plan = layer_plan(cfg)
        if plan["kind"] != "attn":
            raise ValueError(f"paged prefill supports attention-only stacks, "
                             f"not {plan['kind']!r} (family {cfg.family!r})")
        if B != 1:
            raise ValueError(f"paged prefill inserts one request at a time, "
                             f"got batch size {B}")
        nbk, bs = int(dest.block_ids.shape[0]), int(dest.k_pool.shape[2])
        if nbk * bs < S:
            raise ValueError(f"{type(dest).__name__}.block_ids maps {nbk} "
                             f"blocks of {bs} tokens: too few for a {S}-token "
                             "prompt")
        if quantized and S % bs:
            # the prefill quantizes whole pages: the bucket must tile them
            raise ValueError(f"paged_q8 prefill needs the (padded) prompt "
                             f"length to be a multiple of the page size: "
                             f"{S} % {bs} != 0")
    elif isinstance(dest, DensePrefillDest):
        kind = "dense"
        if dest.cache_len <= 0:
            raise ValueError("dense prefill needs DensePrefillDest.cache_len "
                             f"> 0, got {dest.cache_len!r}")
    else:
        raise ValueError(
            f"unknown prefill destination {type(dest).__name__!r}; expected "
            "DensePrefillDest, PagedPrefillDest or PagedQ8PrefillDest")
    backend = backends.get_prefill_backend(kind, prefill_style_key(cfg), impl)
    ctx = {"impl": impl, "true_len": true_len, "vision": vision,
           "qkv_sharding": qkv_sharding}
    return backend.run(params, cfg, inputs, dest, ctx)


# ---------------------------------------------------------------------------
# decode: one token against the cache
# ---------------------------------------------------------------------------

def _rope_and_insert(cfg: ModelConfig, q, k_new, v_new, k_layer, v_layer,
                     length):
    """RoPE the step's q/k at position ``length`` and write the new k/v
    into ring slot ``length % Sc`` of the layer's cache, IN PLACE.
    Returns (q, k_layer, v_layer)."""
    pos = length[:, None]
    q = _rope(cfg, q, pos)
    k_new = _rope(cfg, k_new, pos)
    B, Sc = k_layer.shape[0], k_layer.shape[1]
    rows = torch.arange(B, device=length.device)
    slot = (length % Sc).long()
    put_(k_layer, (rows, slot), k_new[:, 0].to(k_layer.dtype))
    put_(v_layer, (rows, slot), v_new[:, 0].to(v_layer.dtype))
    return q, k_layer, v_layer


def _attn_step_dense(lp, cfg: ModelConfig, u1, k_layer, v_layer, ctx):
    """Registered backend ("dense", "generic"): projects q/k/v as the config
    dictates.  u1 (B,1,d); k_layer/v_layer (B,Sc,Hkv,Dh)."""
    B, length = u1.shape[0], ctx["length"]
    merged = _is_merged(cfg.block_style)
    q, k_new, v_new = _qkv_reanchor(ctx.get("qkv_sharding"), *_project_qkv(
        lp, cfg, u1, u1, merged))
    q, k_layer, v_layer = _rope_and_insert(cfg, q, k_new, v_new,
                                           k_layer, v_layer, length)
    out = attn_mod.decode_attention_core_positions(
        q[:, 0], k_layer, v_layer, kv_positions=ctx["kv_pos"],
        q_position=length, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_layer, v_layer


def _attn_step_dense_merged(lp, cfg: ModelConfig, u1, k_layer, v_layer, ctx):
    """Registered backend ("dense", "merged"): the Q/P-removed decode fast
    path (paper Fig 1b at serve time).  The stream is the query basis, so
    the only attention weights read per token are K*/V*, and the output
    lands in the FFN-input basis (the kernel also reads the cache in its
    native layout)."""
    B, length = u1.shape[0], ctx["length"]
    # variant "qp": _project_qkv returns the stream itself as q
    q, k_new, v_new = _qkv_reanchor(ctx.get("qkv_sharding"), *_project_qkv(
        lp, cfg, u1, u1, True))
    q, k_layer, v_layer = _rope_and_insert(cfg, q, k_new, v_new,
                                           k_layer, v_layer, length)
    out = attn_mod.decode_attention_core_merged(
        q.reshape(B, cfg.attn_dim), k_layer, v_layer,
        kv_positions=ctx["kv_pos"], q_position=length,
        n_kv_heads=cfg.n_kv_heads, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_layer, v_layer


class AppendSlots(NamedTuple):
    """Where one decode step writes its new K/V rows
    (``paged_append_slots``): one write per batch row, each (B,)."""
    src: torch.Tensor  # (B,) batch row whose new K/V the write carries
    dst: torch.Tensor  # (B,) page * bs + off: row in a (NB*bs, Hkv, Dh) view
    page: torch.Tensor  # (B,) physical page
    off: torch.Tensor  # (B,) in-page offset
    live: torch.Tensor  # () bool: some batch row's page is mapped


def paged_append_slots(cfg: ModelConfig, block_tables, length,
                       block_size: int, pages=None) -> AppendSlots:
    """Where this step's new K/V rows go in every layer's pool, without
    reading device data on the host: each batch row's page
    (table[length // bs], the table index wrapping for ring-addressed
    windowed tables; ``kernels.paging``), in-page offset and flat row.
    ``pages`` = (lo, n): the pool is split (a mesh) and this rank holds
    pages lo .. lo + n - 1; a row whose page lies elsewhere counts as
    idle here, and ``page``/``dst`` are indices into the rank's pages.

    JAX drops the writes of idle rows (table all -1) with ``mode="drop"``;
    torch has no such scatter, and selecting the mapped rows
    (``torch.nonzero``) would sync the host every step.  So every batch
    row writes, and an idle row is aimed at the first mapped row's
    destination with that row's K/V: duplicate indices carry identical
    values, whichever lands last.  When no row is mapped (``live`` false)
    every write goes to page 0 at one offset and carries what that row
    already holds (``_rope_and_insert_paged``, ``quant.q8_append_token``).
    Computed once per step, not once per layer."""
    MB = block_tables.shape[1]
    ring = paging.paged_ring_active(cfg.sliding_window, block_size, MB)
    lb = length.long() // block_size
    lb = lb % ring if ring else lb.clamp(max=MB - 1)
    blk = block_tables.long().gather(1, lb[:, None])[:, 0]
    if pages is not None:
        blk = own_pages(blk, *pages)
    valid = blk >= 0
    rows = torch.arange(blk.shape[0], device=blk.device)
    src = torch.where(valid, rows, valid.int().argmax())
    page = blk[src].clamp_min(0)
    off = length.long()[src] % block_size
    return AppendSlots(src, page * block_size + off, page, off, valid.any())


def _rope_and_insert_paged(cfg: ModelConfig, q, k_new, v_new, k_pool, v_pool,
                           length, append, whole):
    """RoPE the step's q/k at position ``length`` and write the new k/v
    rows (``append`` = ``paged_append_slots``) into the layer's pools, IN
    PLACE: a step with no mapped row writes back what the target row
    holds.  ``whole`` takes the new rows to the whole batch (under a mesh:
    gathered over the data axes, so every replica of the pool takes every
    row; ``forward_step``); the write lands on this rank's pages.
    Returns (q, k_pool, v_pool)."""
    pos = length[:, None]
    q = _rope(cfg, q, pos)
    k_new = _rope(cfg, k_new, pos)
    for pool, new in ((k_pool, k_new), (v_pool, v_new)):
        local = local_pages(pool, 0)[0]
        flat = local.view(-1, *local.shape[2:])  # (NB*bs, Hkv, Dh)
        rows = torch.where(append.live,
                           whole(new)[append.src, 0].to(local.dtype),
                           flat[append.dst])
        flat.index_copy_(0, append.dst, rows)
    return q, k_pool, v_pool


def _attn_step_paged(lp, cfg: ModelConfig, u1, k_pool, v_pool, ctx):
    """Registered backend ("paged", "generic"): decode step against a
    paged pool.  u1 (B,1,d); k_pool/v_pool (NB,bs,Hkv,Dh)."""
    B, length = u1.shape[0], ctx["length"]
    merged = _is_merged(cfg.block_style)
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, merged)
    q, k_pool, v_pool = _rope_and_insert_paged(cfg, q, k_new, v_new, k_pool,
                                               v_pool, length, ctx["append"],
                                               ctx["whole"])
    out = attn_mod.decode_attention_core_paged(
        q[:, 0], k_pool, v_pool, block_tables=ctx["block_tables"],
        q_position=length, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_pool, v_pool


def _attn_step_paged_merged(lp, cfg: ModelConfig, u1, k_pool, v_pool, ctx):
    """Registered backend ("paged", "merged"): the Q/P-removed fast path
    against a paged pool — per token the attention side reads K*/V*
    weights and the slot's mapped pages, no Q/P weights and no dense
    worst-case-length cache."""
    B, length = u1.shape[0], ctx["length"]
    # variant "qp": _project_qkv returns the stream itself as q
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, True)
    q, k_pool, v_pool = _rope_and_insert_paged(cfg, q, k_new, v_new, k_pool,
                                               v_pool, length, ctx["append"],
                                               ctx["whole"])
    out = attn_mod.decode_attention_core_paged_merged(
        q.reshape(B, cfg.attn_dim), k_pool, v_pool,
        block_tables=ctx["block_tables"], q_position=length,
        n_kv_heads=cfg.n_kv_heads, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_pool, v_pool


def _rope_and_insert_paged_q8(cfg: ModelConfig, q, k_new, v_new, k_store,
                              v_store, length, append, whole):
    """``_rope_and_insert_paged`` over the int8 pool: RoPE, then quantize
    the new token into each write's page under the page's monotone scale
    merge (``quant.q8_append_token``), ints and scale row in place.
    The same torch ops on every route, so pool bits do not depend on
    ``impl``.  ``whole`` as in ``_rope_and_insert_paged``: the write
    lands on this rank's pages and their scale rows.  Returns q."""
    pos = length[:, None]
    q = _rope(cfg, q, pos)
    k_new = _rope(cfg, k_new, pos)
    for (pool, scale), new in ((k_store, k_new), (v_store, v_new)):
        quant.q8_append_token(local_pages(pool, 0)[0],
                              local_pages(scale, 0)[0],
                              whole(new)[append.src, 0], append.page,
                              append.off, live=append.live)
    return q


def _attn_step_paged_q8(lp, cfg: ModelConfig, u1, k_store, v_store, ctx):
    """Registered backend ("paged_q8", "generic"): decode step against the
    int8 pool.  The stores are (pool, scale) pairs, (NB,bs,Hkv,Dh) int8
    and (NB,Hkv) float32; ``apply_block_step`` passes them through."""
    B, length = u1.shape[0], ctx["length"]
    merged = _is_merged(cfg.block_style)
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, merged)
    q = _rope_and_insert_paged_q8(cfg, q, k_new, v_new, k_store, v_store,
                                  length, ctx["append"], ctx["whole"])
    out = attn_mod.decode_attention_core_paged_q8(
        q[:, 0], k_store[0], v_store[0], k_store[1], v_store[1],
        block_tables=ctx["block_tables"], q_position=length,
        sliding_window=cfg.sliding_window, impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_store, v_store


def _attn_step_paged_q8_merged(lp, cfg: ModelConfig, u1, k_store, v_store,
                               ctx):
    """Registered backend ("paged_q8", "merged"): the Q/P-removed fast path
    against the int8 pool — per token the attention side reads K*/V*
    weights and one byte per attended pooled element (the kernel
    dequantizes as it loads; no float view of the pool exists)."""
    B, length = u1.shape[0], ctx["length"]
    # variant "qp": _project_qkv returns the stream itself as q
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, True)
    q = _rope_and_insert_paged_q8(cfg, q, k_new, v_new, k_store, v_store,
                                  length, ctx["append"], ctx["whole"])
    out = attn_mod.decode_attention_core_paged_q8_merged(
        q.reshape(B, cfg.attn_dim), k_store[0], v_store[0], k_store[1],
        v_store[1], block_tables=ctx["block_tables"], q_position=length,
        n_kv_heads=cfg.n_kv_heads, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_store, v_store


backends.register_backend("dense", "generic", _attn_step_dense)
backends.register_backend("dense", "merged", _attn_step_dense_merged,
                          fast_path=True)
backends.register_backend("paged", "generic", _attn_step_paged)
backends.register_backend("paged", "merged", _attn_step_paged_merged,
                          fast_path=True)
backends.register_backend("paged_q8", "generic", _attn_step_paged_q8)
backends.register_backend("paged_q8", "merged", _attn_step_paged_q8_merged,
                          fast_path=True)


def _cross_attn_step(lp, cfg: ModelConfig, u1, ck, cv, merged: bool, ctx):
    """One token's cross-attention over the vision K/V ck/cv (B, nv, Hkv,
    Dh), read in place, every vision token attended (positions
    ``ctx["cross_pos"]``: arange(nv), queried at nv + 1).  Merged (qp):
    the stream is the query."""
    B = u1.shape[0]
    q = u1
    if not merged:
        q = u1 @ lp["wq"].to(u1.dtype)
        if "bq" in lp:
            q = q + lp["bq"].to(u1.dtype)
    kv_pos, q_pos = ctx["cross_pos"]
    q = head_layout(q, cfg.n_kv_heads)
    out = attn_mod.decode_attention_core_cross(
        q.reshape(B, cfg.n_heads, cfg.d_head), ck, cv, kv_positions=kv_pos,
        q_position=q_pos, impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim)


def apply_block_step(p, cfg: ModelConfig, u1, k_layer, v_layer, ctx,
                     state: Optional[m2.SSMState] = None,
                     kind: Optional[str] = None):
    """One block, one token (the cache rows, and the layer's SSM ``state``
    views, are written in place); the chunk programs pass a chunk's C
    tokens.  An MoE routes dropless here, as in the reference's step and
    chunk programs.  On the int8 pool ``k_layer``/``v_layer`` are (pool,
    scale) pairs, passed through to the backend step as they are; for a
    VLM's cross block (``kind="cross"``) they are its group's vision K/V,
    only read."""
    merged = _is_merged(cfg.block_style)
    kind = _block_kind(cfg, kind)

    def ssm_fn(x):
        out, new = m2.apply_mamba2_step(p["ssm"], x[:, 0], cfg, state)
        assign_(state.ssm, new.ssm)
        assign_(state.conv, new.conv)
        return out[:, None]

    if kind == "ssm":
        if cfg.block_style != "standard":  # skipless: no skip, no norm
            return ssm_fn(u1)
        x = apply_rmsnorm(p["norm1"], u1) if "norm1" in p else u1
        return u1 + ssm_fn(x)

    def mixer_fn(x):
        if kind == "cross":
            cat = _cross_attn_step(p["attn"], cfg, x, k_layer, v_layer,
                                   merged, ctx)
            return cat if merged else _attn_out_proj(p["attn"], cat)
        cat, _, _ = ctx["backend"].step(p["attn"], cfg, x, k_layer, v_layer,
                                        ctx)
        if kind == "hybrid":  # P stays: mean-fuse with the SSM heads
            return 0.5 * (_attn_out_proj(p["attn"], cat) + ssm_fn(x))
        return cat if merged else _attn_out_proj(p["attn"], cat)

    return _apply_style(p, cfg, u1, mixer_fn, dropless=True)[0]


def serving_style_key(cfg: ModelConfig) -> str:
    """Style axis of the decode registry key: "merged" iff the per-token
    step can skip every eliminated projection (qp variant of the merged
    styles on attention and vlm stacks: a merged VLM's self layers take
    the fast path); kp/vp decode token-identically through "generic", and
    so do ssm and hybrid stacks (the hybrid's merge keeps P, so the fast
    path's contract does not hold)."""
    if layer_plan(cfg)["kind"] not in ("attn", "vlm"):
        return "generic"
    if cfg.block_style in ("skipless_merged", "residual_qpfree") \
            and cfg.merged_variant == "qp":
        return "merged"
    return "generic"


def forward_step(params, cfg: ModelConfig, token, cache, *,
                 impl: str = "torch", qkv_sharding=None, rows=None):
    """One decode step: token (B,) int -> (logits (B, V), cache).

    ``cache`` is a ``DecodeCache``, a ``PagedDecodeCache`` or a
    ``PagedQ8DecodeCache``: its type selects the cache_kind axis of the
    backend registry key and the config the style axis
    (``serving_style_key``), so merged "qp" models take the fast path:
    per-token attention reads only K*/V* weights and the merged ``b_out``
    bias is applied in-stream after the FFN.  Unknown (cache_kind, style,
    impl) combos raise KeyError from the registry before any compute, and
    a paged cache on a stack without attention only, or an encoder,
    raises ValueError.  The cache is updated in place: K/V rows,
    positions, and on ssm / hybrid stacks every layer's SSM state and conv
    tail; a VLM's cross K/V are only read.  ``qkv_sharding``: a spec
    re-anchoring the step's q/k/v under a mesh.

    A paged cache under a mesh: the pools are DTensors whose pages may
    split over the model axis, the tables and lengths DTensors split over
    the data axes; every rank writes the step's new rows of the WHOLE
    batch into the pages it holds (the data ranks hold replicas of the
    pool, which stay bitwise equal).  ``rows`` (``placed.row_gather``) is
    for a step on this rank's local rows of a placed paged cache (the
    engine's model-axis-1 route): it gathers a plain tensor's rows to the
    whole batch."""
    paged_q8 = isinstance(cache, PagedQ8DecodeCache)
    paged = paged_q8 or isinstance(cache, PagedDecodeCache)
    if not paged and not isinstance(cache, DecodeCache):
        raise ValueError(f"forward_step serves a DecodeCache, a "
                         f"PagedDecodeCache or a PagedQ8DecodeCache, got "
                         f"{type(cache).__name__}")
    _require_decoder(cfg, "forward_step")
    plan = layer_plan(cfg)
    if paged and plan["kind"] != "attn":
        raise ValueError(f"paged decode supports attention-only stacks, not "
                         f"{plan['kind']!r} (family {cfg.family!r})")
    kind = "paged_q8" if paged_q8 else ("paged" if paged else "dense")
    backend = backends.get_backend(kind, serving_style_key(cfg), impl)
    # embed through the same front end as the sequence path (skipless
    # scale, merged embed_bias / input_proj)
    h = embed_inputs(params, cfg, token[:, None])
    length = cache.length
    ctx = {"length": length, "impl": impl, "backend": backend,
           "qkv_sharding": qkv_sharding}
    if paged:
        ctx["block_tables"] = cache.block_tables

        def whole(x):  # the whole batch of a step's rows
            return full(x) if is_placed(x) else x if rows is None \
                else rows(x)

        pages = local_pages(cache.k)[1:] if is_placed(cache.k) else None
        ctx["whole"] = whole
        ctx["append"] = paged_append_slots(
            cfg, whole(cache.block_tables), whole(length), cache.k.shape[2],
            pages)
    elif cache.kv_pos is not None:
        # mark the new token's slot valid BEFORE attention so it attends
        # to itself (ring slot = length % Sc under a sliding window)
        kv_pos = cache.kv_pos
        rows = torch.arange(kv_pos.shape[0], device=kv_pos.device)
        put_(kv_pos, (rows, (length % kv_pos.shape[1]).long()), length)
        ctx["kv_pos"] = kv_pos
    if plan["kind"] == "vlm":  # every vision token, once per step
        B, nv = cache.cross_k.shape[1], cache.cross_k.shape[2]
        dev = length.device
        ctx["cross_pos"] = (
            torch.arange(nv, dtype=torch.int32, device=dev).expand(B, nv),
            torch.full((B,), nv + 1, dtype=torch.int32, device=dev))
    ssm = None if paged else cache.ssm
    for kind, lp, i in block_sequence(params, cfg):
        st = None
        if kind == "cross":
            k_i, v_i = cache.cross_k[i], cache.cross_v[i]
        elif paged_q8:
            k_i, v_i = (cache.k[i], cache.k_scale[i]), \
                (cache.v[i], cache.v_scale[i])
        elif cache.k is not None:
            k_i, v_i = cache.k[i], cache.v[i]
        else:
            k_i = v_i = None
        if kind != "cross" and ssm is not None:
            st = m2.SSMState(ssm.ssm[i], ssm.conv[i])
        h = apply_block_step(lp, cfg, h, k_i, v_i, ctx, st, kind)
    logits = _logits(params, cfg, h)[:, 0, :]
    return logits, cache._replace(length=length + 1)


# ---------------------------------------------------------------------------
# chunked prefill: fixed-width prompt slices against the SERVING cache, the
# third program of the backend registry (``serving.sched`` interleaves
# these with decode steps inside one engine iteration)
# ---------------------------------------------------------------------------

# causal-mask sentinel for kv positions that must never be attended (empty
# dense entries, unmapped pages): larger than any real position, so the
# causal test kv_pos <= q_pos excludes them without a separate validity
# mask (attention_core_merged has no kv_valid parameter)
_CHUNK_POS_SENTINEL = 2 ** 30


class DenseChunkDest(NamedTuple):
    """Destination of one dense prefill chunk: batch row ``slot`` (an int)
    of the BATCHED serving ``DecodeCache``, written in place at positions
    [start, start+C) of that row."""
    cache: Any
    slot: int


class PagedChunkDest(NamedTuple):
    """Destination of one paged prefill chunk, written direct-to-page, in
    place.

    ``block_table`` is THIS slot's (1, MB) table row (the true mapping, not
    the shield-masked decode view); ``block_ids`` maps the chunk's C//bs
    logical blocks to physical pages, -1 = do not write (prefix-shared
    pages already holding the prefix, and blocks wholly past the prompt on
    a padded final chunk: the ``PagedPrefillDest.block_ids`` contract, per
    chunk)."""
    k_pool: Any
    v_pool: Any
    block_table: Any
    block_ids: Any


class PagedQ8ChunkDest(NamedTuple):
    """Destination of one int8 paged prefill chunk: the ``PagedChunkDest``
    contract over int8 pools and per-(page, kv-head) float32 scales; the
    chunk quantizes its K/V at page granularity and writes the ints and the
    scale rows of the same pages together."""
    k_pool: Any
    v_pool: Any
    k_scale: Any
    v_scale: Any
    block_table: Any
    block_ids: Any


def _chunk_last_logits(logits, start: int, true_len: int, C: int):
    """The last REAL position's logits within the chunk: index
    true_len-1-start clipped into [0, C), meaningful on the final chunk
    (where the prompt's last token lies in [start, start+C))."""
    idx = min(max(true_len - 1 - start, 0), C - 1)
    return logits[:, idx, :]


def _chunk_block_scan(params, cfg: ModelConfig, h, chunk_attn, k_stack,
                      v_stack, impl: str):
    """Run the block stack over a chunk stream with ``chunk_attn`` as the
    attention route of every layer, a Python loop over layers where the
    reference scans (``apply_block_step``'s backend seam is shape-agnostic
    in the stream's sequence extent, so the block wiring, styles, b_out,
    norms and FFN, is reused as it is).  ``k_stack``/``v_stack`` are the
    layer-stacked stores (int8 pool: (pools, scales) pairs), written in
    place by ``chunk_attn``.  Returns the chunk's logits (1, C, V)."""
    ctx = {"impl": impl,
           "backend": backends.AttentionBackend(
               cache_kind="chunk", style="chunk", impl=impl,
               step=chunk_attn)}
    q8 = isinstance(k_stack, tuple)
    for i in range(cfg.n_layers):
        k_i = (k_stack[0][i], k_stack[1][i]) if q8 else k_stack[i]
        v_i = (v_stack[0][i], v_stack[1][i]) if q8 else v_stack[i]
        h = apply_block_step(layer_params(params, i), cfg, h, k_i, v_i, ctx)
    return _logits(params, cfg, h)


def _chunk_rope(cfg: ModelConfig, q, k_new, positions):
    return _rope(cfg, q, positions), _rope(cfg, k_new, positions)


def _chunk_core(cfg: ModelConfig, q, k_row, v_row, pos, kv_eff,
                merged_core: bool, cache_kind: str):
    """Attention of the chunk's C queries at positions ``pos`` over the
    slot's whole row.  This is the port of the reference's positions-based
    XLA core, which its chunk programs run for every impl
    (``repro/models/transformer.py``, ``_chunk_dense``): the flash kernels
    assume arange positions, and a chunk's queries sit at [start, start+C)
    over keys [0, start+C).  So ``impl="torch"`` here is the chunk
    program's own computation on the tensors' device, not a kernel's plain
    version standing in for it; no fused chunk kernel exists in either
    package."""
    C = q.shape[1]
    if merged_core:
        return attn_mod.attention_core_merged(
            q.reshape(1, C, cfg.attn_dim), k_row, v_row, q_positions=pos,
            kv_positions=kv_eff, n_kv_heads=cfg.n_kv_heads,
            causal=cfg.causal, sliding_window=cfg.sliding_window,
            query_chunk=C, impl="torch", cache_kind=cache_kind)
    out = attn_mod.attention_core(
        q, k_row, v_row, q_positions=pos, kv_positions=kv_eff,
        causal=cfg.causal, sliding_window=cfg.sliding_window, query_chunk=C,
        impl="torch")
    return out.reshape(1, C, cfg.attn_dim)


def _chunk_dense(params, cfg: ModelConfig, chunk, dest: DenseChunkDest, ctx,
                 *, merged_core: bool):
    """Shared body of both dense chunk routes.

    Per layer: write the chunk's K/V into the slot's rows at [start,
    start+C) FIRST, then attend over the whole row: the chunk attends to
    itself and every earlier chunk, and overwrites the garbage a
    concurrent batched decode step parked at the chunk frontier (the
    scheduler holds a mid-prefill slot's length at its frontier).  kv_pos
    validity rides the causal mask through a sentinel beyond every real
    position.  A padded final chunk's positions get kv_pos = their
    absolute position >= true_len: no earlier query attends them and
    decode overwrites them in order.  Writes the cache in place and sets
    the slot's length to min(start+C, true_len)."""
    cache, slot = dest.cache, int(dest.slot)
    start, true_len = ctx["start"], ctx["true_len"]
    C = chunk.shape[1]
    Sc = cache.k.shape[2]
    if start + C > Sc:
        raise ValueError(f"chunk [{start}, {start + C}) runs past the "
                         f"{Sc}-position cache")
    merged = _is_merged(cfg.block_style)
    dev = chunk.device
    pos = torch.arange(start, start + C, dtype=torch.int32,
                       device=dev)[None, :]  # (1, C)
    put_(cache.kv_pos, (slot, slice(start, start + C)), pos[0])
    kv_row = cache.kv_pos[slot:slot + 1]
    kv_eff = torch.where(kv_row >= 0, kv_row, _CHUNK_POS_SENTINEL)

    def chunk_attn(lp, cfg_, x, k_layer, v_layer, actx):
        q, k_new, v_new = _qkv_reanchor(ctx.get("qkv_sharding"),
                                        *_project_qkv(lp, cfg_, x, x, merged))
        q, k_new = _chunk_rope(cfg_, q, k_new, pos)
        put_(k_layer, (slot, slice(start, start + C)),
             k_new[0].to(k_layer.dtype))
        put_(v_layer, (slot, slice(start, start + C)),
             v_new[0].to(v_layer.dtype))
        out = _chunk_core(cfg_, q, k_layer[slot:slot + 1],
                          v_layer[slot:slot + 1], pos, kv_eff, merged_core,
                          "dense")
        return out, k_layer, v_layer

    h = embed_inputs(params, cfg, chunk)
    logits = _chunk_block_scan(params, cfg, h, chunk_attn, cache.k, cache.v,
                               ctx["impl"])
    put_(cache.length, (slot,), min(start + C, true_len))
    return _chunk_last_logits(logits, start, true_len, C), cache


class _ChunkPages(NamedTuple):
    """A paged chunk's view of its pools on this rank
    (``_chunk_paged_common``)."""
    pos: Any  # (1, C) the chunk's positions
    kv_eff: Any  # (1, MB*bs) kv positions of the page view, sentinel off it
    keep: Any  # indices of the chunk's blocks this rank writes
    dst: Any  # their local pages
    table: Any  # (1, MB) the table row as this rank's page indices
    group: Any  # the model axis's process group where it splits the pages


def _chunk_paged_common(cfg: ModelConfig, chunk, table, block_ids, bs: int,
                        start: int, pools):
    """What both paged chunk bodies share: the chunk's positions (1, C),
    the kv positions of the slot's densified page view with the sentinel
    on unmapped entries, and the blocks to write (``keep``: indices of the
    chunk's blocks whose destination is >= 0, ``dst``: their pages).
    JAX drops the -1 destinations with ``mode="drop"``; torch has none,
    so only the kept blocks are selected and written (one host sync per
    chunk).  ``pools`` (the stacked pools, and scales) may be DTensors
    whose pages split over the model axis: the positions come from the
    GLOBAL table, then the pages this rank does not hold leave its view
    (sentinel) and its writes.  Returns the local pools and a
    ``_ChunkPages``."""
    C = chunk.shape[1]
    dev = chunk.device
    MB = table.shape[1]
    pos = torch.arange(start, start + C, dtype=torch.int32,
                       device=dev)[None, :]
    ring = paging.paged_ring_active(cfg.sliding_window, bs, MB)
    q_last = torch.full((1,), start + C - 1, dtype=torch.int32, device=dev)
    kvpos = attn_mod.paged_kv_positions(table, bs, q_last, ring)
    local, keep, dst = _kept_pages(pools, block_ids)
    group = split_group(pools[0], 1)
    if group is not None:
        _, lo, n = local_pages(pools[0])
        table = own_pages(table, lo, n)
        kvpos = torch.where(table.repeat_interleave(bs, dim=1) >= 0, kvpos,
                            -1)
    kv_eff = torch.where(kvpos >= 0, kvpos, _CHUNK_POS_SENTINEL)
    return local, _ChunkPages(pos, kv_eff, keep, dst, table, group)


def _chunk_attend(cfg: ModelConfig, q, k_view, v_view, cp: _ChunkPages,
                  merged_core: bool, cache_kind: str):
    """The chunk's attention over the slot's page view (``_chunk_core``);
    where the model axis splits the pages, over the pages this rank holds
    (q gathered to whole heads), the partial states combined across the
    model axis and the result, the same on every rank, placed back as a
    replicated DTensor."""
    if cp.group is None:
        return _chunk_core(cfg, q, k_view, v_view, cp.pos, cp.kv_eff,
                           merged_core, cache_kind)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = q.device_mesh
    ql = full(q)
    C = ql.shape[1]
    bias = attn_mod._mask_bias(cp.pos, cp.kv_eff, causal=cfg.causal,
                               sliding_window=cfg.sliding_window,
                               kv_valid=None)
    states = attn_mod.attention_partial(
        ql.reshape(1, C, -1, cfg.d_head), k_view, v_view, bias)
    out = attn_mod.combined_heads(states, cp.group).to(v_view.dtype)
    return DTensor.from_local(out.reshape(1, C, cfg.attn_dim), mesh,
                              [Replicate()] * mesh.ndim, run_check=False)


def _chunk_paged(params, cfg: ModelConfig, chunk, dest: PagedChunkDest, ctx,
                 *, merged_core: bool):
    """Shared body of both paged chunk routes: write the chunk's pages
    (the ``PagedChunkDest.block_ids`` contract), then attend over the
    slot's densified page view (1, MB*bs), the extent of the plain paged
    decode core.  Ring (sliding-window) tables: the dispatcher pins C to
    the block size, so the whole chunk lives in one ring slot and the
    positions rebuilt at the chunk's last query hold for every query in
    it.  Writes the pools in place."""
    k_pool, v_pool, table, bids = dest
    start, true_len = ctx["start"], ctx["true_len"]
    C = chunk.shape[1]
    bs = k_pool.shape[2]
    nbk = C // bs
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    merged = _is_merged(cfg.block_style)
    (k_l, v_l), cp = _chunk_paged_common(cfg, chunk, table, bids, bs, start,
                                         (k_pool, v_pool))
    qkv = ctx.get("qkv_sharding")

    def chunk_attn(lp, cfg_, x, kp, vp, actx):
        q, k_new, v_new = _qkv_reanchor(qkv, *_project_qkv(lp, cfg_, x, x,
                                                            merged))
        q, k_new = _chunk_rope(cfg_, q, k_new, cp.pos)
        for pool, new in ((kp, k_new), (vp, v_new)):
            pool[cp.dst] = full(new)[0].to(pool.dtype).reshape(
                nbk, bs, Hkv, Dh)[cp.keep]
        out = _chunk_attend(cfg_, q, attn_mod._paged_gather(kp, cp.table),
                            attn_mod._paged_gather(vp, cp.table), cp,
                            merged_core, "paged")
        return out, kp, vp

    h = embed_inputs(params, cfg, chunk)
    logits = _chunk_block_scan(params, cfg, h, chunk_attn, k_l, v_l,
                               ctx["impl"])
    return _chunk_last_logits(logits, start, true_len, C), (k_pool, v_pool)


def _chunk_paged_q8(params, cfg: ModelConfig, chunk, dest: PagedQ8ChunkDest,
                    ctx, *, merged_core: bool):
    """Shared body of both paged_q8 chunk routes: ``_chunk_paged`` over the
    int8 pool.  The chunk's K/V are quantized at page granularity
    (positions >= true_len zeroed first: the same ``q8_quantize_seq`` call
    the whole-prompt q8 prefill makes, so a chunked prompt lands the same
    pool bits), the ints and the scale rows of the kept pages written
    together, and the attention view is the dequantized page gather, as
    the plain q8 decode core reconstructs it."""
    k_pool, v_pool, k_scale, v_scale, table, bids = dest
    start, true_len = ctx["start"], ctx["true_len"]
    C = chunk.shape[1]
    bs = k_pool.shape[2]
    nbk = C // bs
    Hkv, Dh = cfg.n_kv_heads, cfg.d_head
    merged = _is_merged(cfg.block_style)
    (k_l, v_l, ks_l, vs_l), cp = _chunk_paged_common(
        cfg, chunk, table, bids, bs, start, (k_pool, v_pool, k_scale,
                                             v_scale))
    valid = cp.pos < true_len  # (1, C)
    qkv = ctx.get("qkv_sharding")

    def chunk_attn(lp, cfg_, x, kst, vst, actx):
        q, k_new, v_new = _qkv_reanchor(qkv, *_project_qkv(lp, cfg_, x, x,
                                                            merged))
        q, k_new = _chunk_rope(cfg_, q, k_new, cp.pos)
        gathered = []
        for (pool, scale), new in ((kst, k_new), (vst, v_new)):
            ints, sc = quant.q8_quantize_seq(full(new), bs, valid)
            pool[cp.dst] = ints[0].reshape(nbk, bs, Hkv, Dh)[cp.keep]
            scale[cp.dst] = sc[0][cp.keep]
            gathered.append(attn_mod._paged_gather_q8(
                pool, scale, cp.table, x.dtype))
        out = _chunk_attend(cfg_, q, *gathered, cp, merged_core, "paged_q8")
        return out, kst, vst

    h = embed_inputs(params, cfg, chunk)
    logits = _chunk_block_scan(params, cfg, h, chunk_attn, (k_l, ks_l),
                               (v_l, vs_l), ctx["impl"])
    return (_chunk_last_logits(logits, start, true_len, C),
            (k_pool, v_pool, k_scale, v_scale))


# --- the six registered chunk routes (each for both impls) -----------------

def _chunk_dense_generic(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("dense", "generic")."""
    return _chunk_dense(params, cfg, chunk, dest, ctx, merged_core=False)


def _chunk_dense_merged(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("dense", "merged"): the Q/P-removed fast
    path chunk by chunk; the program reads no Q or P weights."""
    return _chunk_dense(params, cfg, chunk, dest, ctx, merged_core=True)


def _chunk_paged_generic(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("paged", "generic")."""
    return _chunk_paged(params, cfg, chunk, dest, ctx, merged_core=False)


def _chunk_paged_merged(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("paged", "merged"): stream-as-query
    attention and direct-to-page chunk writes."""
    return _chunk_paged(params, cfg, chunk, dest, ctx, merged_core=True)


def _chunk_paged_q8_generic(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("paged_q8", "generic")."""
    return _chunk_paged_q8(params, cfg, chunk, dest, ctx, merged_core=False)


def _chunk_paged_q8_merged(params, cfg: ModelConfig, chunk, dest, ctx):
    """Registered chunk backend ("paged_q8", "merged"): stream-as-query
    attention and int8 direct-to-page chunk writes."""
    return _chunk_paged_q8(params, cfg, chunk, dest, ctx, merged_core=True)


backends.register_chunk_backend("dense", "generic", _chunk_dense_generic)
backends.register_chunk_backend("dense", "merged", _chunk_dense_merged,
                                fast_path=True)
backends.register_chunk_backend("paged", "generic", _chunk_paged_generic)
backends.register_chunk_backend("paged", "merged", _chunk_paged_merged,
                                fast_path=True)
backends.register_chunk_backend("paged_q8", "generic",
                                _chunk_paged_q8_generic)
backends.register_chunk_backend("paged_q8", "merged", _chunk_paged_q8_merged,
                                fast_path=True)


def forward_prefill_chunk(params, cfg: ModelConfig, chunk, dest, *,
                          start: int, true_len: int, impl: str = "torch",
                          max_len: Optional[int] = None, qkv_sharding=None):
    """One fixed-width prefill chunk against the SERVING cache: the single
    dispatcher over the ``models.backends`` CHUNK registry.

    ``chunk`` is (1, C) int: tokens [start, start+C) of ONE stream's
    prompt, right-padded past ``true_len`` on the final chunk; ``start``
    and ``true_len`` are host ints.  Returns (last_logits (1, V), the
    prompt's last real position, meaningful on the final chunk, and the
    filled destination), mirroring ``forward_prefill``:

    * ``DenseChunkDest(cache, slot)`` writes rows [start, start+C) of
      batch row ``slot`` in place and returns the ``DecodeCache``.  A
      BINDING dense window (window < ``max_len``) is refused: the
      window-sized ring cache cannot hold a partial prompt at absolute
      positions (the scheduler takes monolithic jobs there);
    * ``PagedChunkDest`` / ``PagedQ8ChunkDest`` write the chunk's pages
      in place and return the pools (and scales).  C must be a multiple
      of the page size, and exactly one page on a ring (windowed) table.

    Attention-only stacks only (SSM state has no mid-prompt checkpoint).
    The attention inside a chunk is the positions-based plain core on
    every impl, as in the reference (``_chunk_core``); ``impl`` selects
    the registry entry.  Invalid requests raise ValueError; unknown
    (cache_kind, style, impl) combos raise the registry's KeyError."""
    B, C = int(chunk.shape[0]), int(chunk.shape[1])
    if B != 1:
        raise ValueError(f"chunked prefill feeds one stream at a time, got "
                         f"batch size {B}")
    plan = layer_plan(cfg)
    if plan["kind"] != "attn":
        raise ValueError(
            f"chunked prefill supports attention-only stacks, not "
            f"{plan['kind']!r} (family {cfg.family!r})")
    _require_decoder(cfg, "forward_prefill_chunk")
    if isinstance(dest, (PagedChunkDest, PagedQ8ChunkDest)):
        kind = "paged_q8" if isinstance(dest, PagedQ8ChunkDest) else "paged"
        bs = int(dest.k_pool.shape[2])
        MB = int(dest.block_table.shape[1])
        if C % bs:
            raise ValueError(f"chunk width {C} must be a multiple of the "
                             f"page size {bs}")
        if paging.paged_ring_active(cfg.sliding_window, bs, MB) and C != bs:
            raise ValueError(
                f"ring (sliding-window) paged chunks must be exactly one "
                f"block: chunk width {C} != block size {bs}")
        if int(dest.block_ids.shape[0]) != C // bs:
            raise ValueError(
                f"{type(dest).__name__}.block_ids maps "
                f"{int(dest.block_ids.shape[0])} blocks; a {C}-token chunk "
                f"over {bs}-token pages needs {C // bs}")
    elif isinstance(dest, DenseChunkDest):
        kind = "dense"
        # a window >= max_len never masks or wraps anything and chunks like
        # window 0; the cache alone cannot tell the two apart (Sc =
        # min(max_len, window)), so the max_len hint carries the check
        if cfg.sliding_window and max_len is not None \
                and cfg.sliding_window < max_len:
            raise ValueError(
                "dense sliding-window chunked prefill is unsupported (the "
                "window-sized ring cache can't park a partial prompt at "
                "absolute positions); use the scheduler's monolithic "
                "fallback or the paged cache")
    else:
        raise ValueError(
            f"unknown chunk destination {type(dest).__name__!r}; expected "
            "DenseChunkDest, PagedChunkDest or PagedQ8ChunkDest")
    backend = backends.get_chunk_backend(kind, prefill_style_key(cfg), impl)
    ctx = {"start": int(start), "true_len": int(true_len), "impl": impl,
           "qkv_sharding": qkv_sharding}
    return backend.run(params, cfg, chunk, dest, ctx)
