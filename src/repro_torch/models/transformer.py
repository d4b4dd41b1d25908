"""Dense attention stacks in all paper block styles: setup, the sequence
forward, prefill into the dense cache, and one-token decode.

Counterpart of ``repro.models.transformer`` for plan kind "attn" on the
dense family (other plan kinds and families raise NotImplementedError; see
ROADMAP.md).  Block styles (paper mapping):
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
  forward_step     one token against the dense cache; the per-layer
                   attention route is looked up in the AttentionBackend
                   registry keyed (cache_kind, style, impl)

Unlike the JAX reference, ``forward_step`` updates the cache IN PLACE (the
new K/V rows, ``kv_pos``) and returns it with ``length`` advanced: a
functional copy of a multi-GB cache per token is what donation avoids on
the TPU.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import backends
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import (
    apply_embedding,
    apply_rmsnorm,
    apply_rope,
    apply_unembedding,
    dense_init,
    dtype_of,
    init_embedding,
    init_rmsnorm,
    orthogonal_init,
)

_NOT_PORTED = ("not ported yet: the port's first slice serves dense "
               "attention stacks (see ROADMAP.md, 'Modules to port')")


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


def _require_dense(cfg: ModelConfig) -> None:
    if layer_plan(cfg)["kind"] != "attn" or cfg.n_experts or \
            cfg.conv_pos_width or cfg.family not in ("dense",):
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) is {_NOT_PORTED}")


# ---------------------------------------------------------------------------
# per-layer param init
# ---------------------------------------------------------------------------

def _init_attn_proj(gen, cfg: ModelConfig, dtype, merged: bool):
    """Q/K/V/P params for one attention sub-module.  Merged styles omit
    the eliminated pair per ``cfg.merged_variant`` (paper Table 1)."""
    d, ad, kd = cfg.d_model, cfg.attn_dim, cfg.kv_dim
    init_fn = _init_fn_for(cfg)
    dev = gen.device
    p: Dict[str, Any] = {}
    variant = cfg.merged_variant if merged else ""
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


def init_block(gen, cfg: ModelConfig, dtype) -> Dict[str, Any]:
    """One attention block's params (plan kind "attn")."""
    style = cfg.block_style
    merged = _is_merged(style)
    p: Dict[str, Any] = {"attn": _init_attn_proj(gen, cfg, dtype, merged)}
    if cfg.has_ffn:
        # merged serial: FFN input dim is attn_dim (P folded in)
        ffn_in = cfg.attn_dim if (merged and not cfg.parallel_block) \
            else cfg.d_model
        p["ffn"] = ffn_mod.init_ffn(gen, ffn_in, cfg.d_ff, cfg.d_model,
                                    cfg.ffn_type, dtype,
                                    init_fn=_init_fn_for(cfg),
                                    out_gain=cfg.ffn_out_gain)
    if _needs_norms(style):
        p["norm1"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
        if cfg.has_ffn:
            p["norm2"] = init_rmsnorm(cfg.d_model, dtype, gen.device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device="cuda") -> Dict[str, Any]:
    """Random parameters made on ``device`` from a seeded
    ``torch.Generator`` there.  The layer stack is filled one layer at a
    time into preallocated (L, …) tensors, so the peak is one copy of the
    model (plus one layer)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    params: Dict[str, Any] = {}
    params["embed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = init_embedding(gen, cfg.padded_vocab, cfg.d_model,
                                           dtype)
    first = init_block(gen, cfg, dtype)
    n = cfg.n_layers
    stacked = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), first)

    def put(i, block):
        for dst, src in zip(tree_leaves(stacked), tree_leaves(block)):
            dst[i].copy_(src)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_block(gen, cfg, dtype))
    params["layers"] = stacked
    if _needs_norms(cfg.block_style):
        params["final_norm"] = init_rmsnorm(cfg.d_model, dtype, dev)
    return params


def count_params(params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))


def layer_params(params, i: int):
    """Layer ``i``'s slice (views) of the stacked layer tree."""
    return tree_map(lambda x: x[i], params["layers"])


# ---------------------------------------------------------------------------
# attention sub-module apply (projections + rope + core)
# ---------------------------------------------------------------------------

def _project_qkv(lp, cfg: ModelConfig, u, kv_src, merged: bool):
    """u: (B,S,d) query-side stream; kv_src: (B,Sk,d) key/value source.  In
    merged styles the projection named by ``cfg.merged_variant`` is the
    identity: the stream is already in its output basis (Fig 2b/c/d)."""
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
    return (q.reshape(B, Sq, cfg.n_heads, Dh),
            k.reshape(B, Sk, cfg.n_kv_heads, Dh),
            v.reshape(B, Sk, cfg.n_kv_heads, Dh))


def _rope(cfg: ModelConfig, x, positions):
    return apply_rope(x, positions, style=cfg.rope_style, theta=cfg.rope_theta,
                      fraction=cfg.rope_fraction)


def _self_attention_seq(lp, cfg: ModelConfig, u, positions, merged: bool,
                        impl: str, merged_core: bool = False,
                        cache_kind: str = "dense"):
    """``merged_core`` selects the stream-as-query core (merged qp layouts:
    q is an identity view of u, so every tensor stays in its native
    layout — the prefill twin of the merged decode fast path)."""
    q, k, v = _project_qkv(lp, cfg, u, u, merged)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    B, S = u.shape[0], u.shape[1]
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


def _attn_out_proj(lp, cat):
    return cat @ lp["wp"].to(cat.dtype)


def _apply_ffn(p, cfg: ModelConfig, x):
    return ffn_mod.apply_ffn(p["ffn"], x, cfg.ffn_type)


def _apply_style(p, cfg: ModelConfig, u, mixer_fn):
    """The block-style wiring shared by the sequence and the step paths:
    where the norms, skips, mixer and FFN sit (paper Figs 1, 3, 4)."""
    style = cfg.block_style
    if style in ("standard", "residual_qpfree"):
        if cfg.parallel_block:
            n = apply_rmsnorm(p["norm1"], u)
            return u + mixer_fn(n) + _apply_ffn(p, cfg, n)
        h = u + mixer_fn(apply_rmsnorm(p["norm1"], u))
        return h + _apply_ffn(p, cfg, apply_rmsnorm(p["norm2"], h))
    if style in ("skipless", "skipless_merged"):
        if cfg.parallel_block:
            out = mixer_fn(u) + _apply_ffn(p, cfg, u)
        else:
            out = _apply_ffn(p, cfg, mixer_fn(u))
        if style == "skipless_merged" and "b_out" in p:
            # folded b_q of the NEXT block (affine merge)
            out = out + p["b_out"].to(out.dtype)
        return out
    raise ValueError(style)


def apply_block_seq(p, cfg: ModelConfig, u, ctx):
    """One attention block over a sequence -> (out_stream, (k, v))."""
    merged = _is_merged(cfg.block_style)
    kv = []

    def mixer_fn(x):
        cat, kv_ = _self_attention_seq(
            p["attn"], cfg, x, ctx["positions"], merged, ctx["impl"],
            merged_core=ctx.get("merged_core", False),
            cache_kind=ctx.get("cache_kind", "dense"))
        kv.append(kv_)
        return cat if merged else _attn_out_proj(p["attn"], cat)

    out = _apply_style(p, cfg, u, mixer_fn)
    return out, kv[0]


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


def forward_seq(params, cfg: ModelConfig, inputs, *, positions=None,
                impl: str = "torch", collect_kv: bool = False,
                merged_core: bool = False, cache_kind: str = "dense"):
    """Full-sequence forward over int tokens (B,S) -> (logits, aux, kvs).

    ``kvs`` is (k, v), each (L, B, S, Hkv, Dh), when ``collect_kv``.
    ``merged_core`` routes self-attention through the stream-as-query
    merged core (prefill backends set it for merged qp layouts)."""
    _require_dense(cfg)
    B, S = inputs.shape[0], inputs.shape[1]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=inputs.device).expand(B, S)
    h = embed_inputs(params, cfg, inputs)
    ctx = {"positions": positions, "impl": impl, "merged_core": merged_core,
           "cache_kind": cache_kind}
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = apply_block_seq(layer_params(params, i), cfg, h, ctx)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return _logits(params, cfg, h), aux, kvs


# ---------------------------------------------------------------------------
# decode cache
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    k: torch.Tensor  # (L, B, Sc, Hkv, Dh) — Sc = window or max_len
    v: torch.Tensor
    kv_pos: torch.Tensor  # (B, Sc) int32, -1 = empty (shared across layers)
    length: torch.Tensor  # (B,) int32 — tokens so far (= next position)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shapes and dtypes of an empty cache."""
    Sc = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kv = ((cfg.n_layers, batch, Sc, cfg.n_kv_heads, cfg.d_head),
          dtype_of(cfg.dtype))
    return {"k": kv, "v": kv, "kv_pos": ((batch, Sc), torch.int32),
            "length": ((batch,), torch.int32)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> DecodeCache:
    _require_dense(cfg)
    dev = resolve_device(device)
    spec = cache_spec(cfg, batch, max_len)

    def full(name, fill):
        shape, dt = spec[name]
        return torch.full(shape, fill, dtype=dt, device=dev)

    return DecodeCache(k=full("k", 0), v=full("v", 0), kv_pos=full("kv_pos", -1),
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


def prefill_style_key(cfg: ModelConfig) -> str:
    """Style axis of the PREFILL registry key: "merged" iff every layer can
    run the stream-as-query core (qp variant of the merged styles on
    attention stacks); kp/vp stay "generic" (their eliminated projection
    is an identity inside ``_project_qkv``)."""
    if layer_plan(cfg)["kind"] != "attn":
        return "generic"
    if cfg.block_style in ("skipless_merged", "residual_qpfree") \
            and cfg.merged_variant == "qp":
        return "merged"
    return "generic"


def _prefill_seq(params, cfg: ModelConfig, inputs, ctx, *,
                 merged_core: bool, cache_kind: str):
    """The full-sequence pass every prefill backend starts with."""
    return forward_seq(params, cfg, inputs, impl=ctx.get("impl", "torch"),
                       collect_kv=True, merged_core=merged_core,
                       cache_kind=cache_kind)


def _finish_dense(params, cfg: ModelConfig, inputs, logits, kvs,
                  dest: DensePrefillDest, ctx, B: int, S: int):
    """Place the collected prompt KV into a fresh ``DecodeCache`` (ring-
    phased under a sliding window) and gather the last real logits."""
    true_len = ctx.get("true_len")
    cache_cfg = cfg.with_(sliding_window=0) if dest.full_cache else cfg
    cache = init_cache(cache_cfg, B, dest.cache_len, device=inputs.device)
    Sc = cache.k.shape[2]

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
        out[:, :, :S] = kv_stacked
        return out

    last_logits, length = _last_logits_and_length(logits, true_len, B, S)
    ks, vs = kvs
    k = place(ks).to(cache.k.dtype)
    v = place(vs).to(cache.v.dtype)
    pos = torch.arange(Sc, dtype=torch.int32, device=inputs.device)[None, :] \
        + max(S - Sc, 0)
    limit = S if true_len is None else length[:, None]
    kvp = torch.where(pos < limit, pos, -1).to(torch.int32).expand(B, Sc)
    if S >= Sc and (S - Sc) % Sc:  # match place()'s ring phase
        kvp = torch.roll(kvp, (S - Sc) % Sc, dims=1)
    return last_logits, DecodeCache(k=k.contiguous(), v=v.contiguous(),
                                    kv_pos=kvp.contiguous(), length=length)


def _prefill_dense_generic(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("dense", "generic"): projects q/k/v as
    the config dictates (kp/vp merged variants pass through)."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, _, kvs = _prefill_seq(params, cfg, inputs, ctx,
                                  merged_core=False, cache_kind="dense")
    return _finish_dense(params, cfg, inputs, logits, kvs, dest, ctx, B, S)


def _prefill_dense_merged(params, cfg: ModelConfig, inputs, dest, ctx):
    """Registered prefill backend ("dense", "merged"): the Q/P-removed
    prefill fast path — every layer runs the stream-as-query core, reads no
    Q or P weights and makes no head-major transposes; the filled cache is
    the same layout as the generic backend's."""
    B, S = inputs.shape[0], inputs.shape[1]
    logits, _, kvs = _prefill_seq(params, cfg, inputs, ctx,
                                  merged_core=True, cache_kind="dense")
    return _finish_dense(params, cfg, inputs, logits, kvs, dest, ctx, B, S)


backends.register_prefill_backend("dense", "generic", _prefill_dense_generic)
backends.register_prefill_backend("dense", "merged", _prefill_dense_merged,
                                  fast_path=True)


def forward_prefill(params, cfg: ModelConfig, inputs, dest, *,
                    impl: str = "torch", true_len=None):
    """Cache-aware prefill: the single dispatcher over the PREFILL
    registry.  ``dest`` is a ``DensePrefillDest(cache_len, full_cache)``;
    returns (last_token_logits (B, V), ``DecodeCache``).

    ``true_len`` (B,) int supports bucketed prompts: ``inputs`` may be
    right-padded, the logits are gathered at ``true_len - 1`` and the
    cache marks padded positions empty (kv_pos = -1) with ``length =
    true_len``.  Invalid destinations raise ValueError; unknown (cache_kind,
    style, impl) combos raise the registry's KeyError."""
    if not isinstance(dest, DensePrefillDest):
        raise ValueError(
            f"unknown prefill destination {type(dest).__name__!r}; the port "
            "serves DensePrefillDest (paged caches: ROADMAP.md)")
    if dest.cache_len <= 0:
        raise ValueError("dense prefill needs DensePrefillDest.cache_len > 0,"
                         f" got {dest.cache_len!r}")
    backend = backends.get_prefill_backend("dense", prefill_style_key(cfg),
                                           impl)
    ctx = {"impl": impl, "true_len": true_len}
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
    k_layer[rows, slot] = k_new[:, 0].to(k_layer.dtype)
    v_layer[rows, slot] = v_new[:, 0].to(v_layer.dtype)
    return q, k_layer, v_layer


def _attn_step_dense(lp, cfg: ModelConfig, u1, k_layer, v_layer, ctx):
    """Registered backend ("dense", "generic"): projects q/k/v as the config
    dictates.  u1 (B,1,d); k_layer/v_layer (B,Sc,Hkv,Dh)."""
    B, length = u1.shape[0], ctx["length"]
    merged = _is_merged(cfg.block_style)
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, merged)
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
    q, k_new, v_new = _project_qkv(lp, cfg, u1, u1, True)
    q, k_layer, v_layer = _rope_and_insert(cfg, q, k_new, v_new,
                                           k_layer, v_layer, length)
    out = attn_mod.decode_attention_core_merged(
        q.reshape(B, cfg.attn_dim), k_layer, v_layer,
        kv_positions=ctx["kv_pos"], q_position=length,
        n_kv_heads=cfg.n_kv_heads, sliding_window=cfg.sliding_window,
        impl=ctx["impl"])
    return out.reshape(B, 1, cfg.attn_dim), k_layer, v_layer


backends.register_backend("dense", "generic", _attn_step_dense)
backends.register_backend("dense", "merged", _attn_step_dense_merged,
                          fast_path=True)


def apply_block_step(p, cfg: ModelConfig, u1, k_layer, v_layer, ctx):
    """One block, one token (the cache rows are written in place)."""
    merged = _is_merged(cfg.block_style)

    def mixer_fn(x):
        cat, _, _ = ctx["backend"].step(p["attn"], cfg, x, k_layer, v_layer,
                                        ctx)
        return cat if merged else _attn_out_proj(p["attn"], cat)

    return _apply_style(p, cfg, u1, mixer_fn)


def serving_style_key(cfg: ModelConfig) -> str:
    """Style axis of the decode registry key: "merged" iff the per-token
    step can skip every eliminated projection (qp variant of the merged
    styles); kp/vp decode token-identically through "generic"."""
    if layer_plan(cfg)["kind"] not in ("attn", "vlm"):
        return "generic"
    if cfg.block_style in ("skipless_merged", "residual_qpfree") \
            and cfg.merged_variant == "qp":
        return "merged"
    return "generic"


def forward_step(params, cfg: ModelConfig, token, cache: DecodeCache, *,
                 impl: str = "torch"):
    """One decode step: token (B,) int -> (logits (B, V), cache).

    The config selects the style axis (``serving_style_key``), so merged
    "qp" models take the fast path: per-token attention reads only K*/V*
    weights and the merged ``b_out`` bias is applied in-stream after the
    FFN.  Unknown (cache_kind, style, impl) combos raise KeyError from the
    registry before any compute.  The cache is updated in place."""
    if not isinstance(cache, DecodeCache):
        raise ValueError(f"forward_step serves a DecodeCache, got "
                         f"{type(cache).__name__} (paged caches: ROADMAP.md)")
    _require_dense(cfg)
    backend = backends.get_backend("dense", serving_style_key(cfg), impl)
    # embed through the same front end as the sequence path (skipless
    # scale, merged embed_bias / input_proj)
    h = embed_inputs(params, cfg, token[:, None])
    # mark the new token's slot valid BEFORE attention so it attends to
    # itself (ring slot = length % Sc under a sliding window)
    length, kv_pos = cache.length, cache.kv_pos
    Sc = kv_pos.shape[1]
    rows = torch.arange(kv_pos.shape[0], device=kv_pos.device)
    kv_pos[rows, (length % Sc).long()] = length
    ctx = {"length": length, "kv_pos": kv_pos, "impl": impl,
           "backend": backend}
    for i in range(cfg.n_layers):
        h = apply_block_step(layer_params(params, i), cfg, h, cache.k[i],
                             cache.v[i], ctx)
    logits = _logits(params, cfg, h)[:, 0, :]
    return logits, cache._replace(length=length + 1)
