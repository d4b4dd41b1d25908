"""Built-in lint rules: the paper's structural claims plus the bug
classes the serving stack has shipped, each as a checkable invariant.

Counterpart of ``repro.lint.builtin``: the same seven rule names, judged
on traced PyTorch graphs (``repro_torch.lint.walker``).  A kernel call is
ONE opaque node (an operator of the ``repro_torch`` namespace, on the
card and on the CPU alike): the rules judge its operands and results,
never its body, where the reference's walk enters ``pallas_call`` kernel
bodies.

  NoForbiddenMatmul       merged (qp) programs hold exactly two fewer
                          matrix products per attention layer than their
                          unmerged source — the Q and P projections are
                          gone from the program, not just from the param
                          tree ("KV-weights are all you need", per
                          registered combo).  The graph unrolls the layer
                          loop, so the delta is 2 x layers where the
                          reference's scanned jaxpr shows 2
  NoOversizedBuffer       paged prefill materializes NO max_len-sized
                          intermediate (direct-to-page prefill)
  DonationEffective       the cache leaves the serving adapter hands over
                          are written in place and returned as the same
                          storage, never copied out of place — the
                          counterpart of a donation that aliases its
                          output
  NoDtypePromotionDrift   no cache-sized buffer at a float dtype wider
                          than the cache dtype (a float32 shadow of a
                          bf16 cache doubles the memory the layout saves)
  NoHostTransferInStepLoop  the decode step makes no host sync
                          (``walker.HOST_SYNC_OPS``, boolean-mask
                          indexing, copies to the CPU): one host round
                          trip per token serializes every stream
  NoHostTransferInObsHooks  re-tracing a serving program with the
                          ``repro_torch.obs`` observer ACTIVE adds zero
                          host syncs — the observer's hooks stay on the
                          host
  NoDequantizedPoolBuffer paged_q8 programs never materialize a
                          pool-shaped buffer wider than int8 — dequant
                          happens per tile (inside the kernel) or per
                          gathered table row, never as a full-precision
                          shadow of the int8 pool
"""
from __future__ import annotations

import collections
from typing import List

import torch

from repro_torch.lint import walker
from repro_torch.lint.rules import LintRule, LintTarget, register_rule


class NoForbiddenMatmul(LintRule):
    """Merged programs must drop exactly the wq and wp products.

    The qp-merged rewrite of a model differs from its unmerged source by
    the Q and P projections of each attention layer and nothing else, so
    the merged program must count exactly ``2 * n_attn_layers`` fewer
    matrix-product nodes (``walker.MATMUL_OPS``) than the same
    phase/cache/impl program of the source model.  The traced graph
    unrolls the layers (the reference's jaxpr scans one layer body, hence
    its delta of two).  Counting the delta (not absolute counts) keeps the
    rule valid as layers gain products; requiring equality (not <=)
    catches a "merged" route that silently re-projects Q elsewhere."""

    name = "NoForbiddenMatmul"
    description = ("merged program has exactly two fewer matmuls per "
                   "attention layer than its unmerged source")

    def applies(self, t: LintTarget) -> bool:
        return t.style == "merged" and t.source_graph is not None

    def check(self, t: LintTarget) -> List:
        n_src = walker.count_matmuls(t.source_graph)
        n_merged = walker.count_matmuls(t.graph)
        want = n_src - 2 * t.n_attn_layers
        if n_merged != want:
            return [self.finding(
                t, f"merged program has {n_merged} matmuls, unmerged source "
                   f"has {n_src}; expected exactly {want} (wq and wp of "
                   f"{t.n_attn_layers} attention layers eliminated, nothing "
                   f"else)",
                detail={"merged": n_merged, "source": n_src,
                        "n_attn_layers": t.n_attn_layers})]
        return []


class NoOversizedBuffer(LintRule):
    """Paged prefill must not materialize a max_len-sized buffer.

    Direct-to-page prefill's point is that the program's sequence extents
    are bounded by the prompt bucket, never by the serving max_len; one
    max_len-sized intermediate resurrects the worst-case allocation the
    paged pool exists to delete.  The sweep picks a ``max_len`` that
    collides with no model/pool dimension, so any hit is real."""

    name = "NoOversizedBuffer"
    description = "no max_len-sized intermediate in paged prefill"

    def applies(self, t: LintTarget) -> bool:
        return t.phase == "prefill" \
            and t.cache_kind in ("paged", "paged_q8") \
            and t.max_len is not None

    def check(self, t: LintTarget) -> List:
        offending = walker.values_with_dim(t.graph, t.max_len)
        if offending:
            shapes = sorted({tuple(v.shape) for v in offending})
            return [self.finding(
                t, f"{len(offending)} max_len({t.max_len})-sized buffers "
                   f"in the program, e.g. {shapes[:3]}",
                detail={"max_len": t.max_len,
                        "shapes": [list(s) for s in shapes[:10]]})]
        return []


#: ops that copy a tensor out of place: one of these producing a value of
#: a handed-over cache leaf's shape and dtype is a whole-cache copy
COPY_OPS = frozenset({"aten.clone", "aten._to_copy", "aten.cat",
                      "aten.stack", "aten.copy"})


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            and tuple(a.shape) == tuple(b.shape) and a.dtype == b.dtype)


class DonationEffective(LintRule):
    """The cache leaves a serving adapter hands over must be written in
    place.

    The reference donates its caches to the jitted step and checks that
    each donation aliases an output; an ineffective donation silently
    copies the whole pool every token.  The port has no jit: the program
    writes the cache in place.  Its counterpart checks each handed-over
    K/V, pool, scale, position or table leaf (``LintTarget.donated``):
    the program returns it as the SAME storage, and no node copies it out
    of place (``COPY_OPS``) into a value of its shape and dtype.  The
    decode step's (B,) ``length`` counter is not among them: it comes back
    as a NEW tensor (``length + 1``), a few bytes, as the reference's
    step returns a new one."""

    name = "DonationEffective"
    description = ("every handed-over cache leaf is written in place and "
                   "returned as the same storage")

    def applies(self, t: LintTarget) -> bool:
        return bool(t.donated)

    def check(self, t: LintTarget) -> List:
        dead = [name for name, given, back in t.donated
                if back is None or not _same_storage(given, back)]
        leaf = {(tuple(g.shape), g.dtype): name for name, g, _ in t.donated}
        copies = sorted({
            (leaf[(tuple(v.shape), v.dtype)], walker.op_name(n))
            for n in walker.iter_nodes(t.graph)
            if walker.op_name(n) in COPY_OPS
            for v in walker.tensors_of(n.meta.get("val"))
            if (tuple(v.shape), v.dtype) in leaf})
        out = []
        if dead:
            out.append(self.finding(
                t, f"{len(dead)}/{len(t.donated)} handed-over cache leaves "
                   f"come back as new storage ({dead}) — the in-place write "
                   f"silently became a copy",
                detail={"not_in_place": dead,
                        "declared": [n for n, _, _ in t.donated]}))
        if copies:
            out.append(self.finding(
                t, f"{len(copies)} whole-leaf copies of handed-over cache "
                   f"leaves in the program: {copies[:4]}",
                detail={"copies": [list(c) for c in copies]}))
        return out


def _wider_float(a: torch.dtype, than: torch.dtype) -> bool:
    return (a.is_floating_point and than.is_floating_point
            and torch.finfo(a).bits > torch.finfo(than).bits)


class NoDtypePromotionDrift(LintRule):
    """No cache-sized buffer at a float dtype wider than the cache dtype.

    Float32 accumulation over TILES is by design (inside the kernels, or
    a per-row softmax) — that is not drift.  Drift is a whole
    cache/pool-shaped value appearing at float32 when the cache is bf16:
    a silent 2x of exactly the memory the merged layout and the paged pool
    are engineered to save.  The rule scans every value for the cache
    leaves' (layer-stacked) shapes at a wider float dtype; kernel
    operators are opaque, so their tiles are not values of the graph.
    Only live at sub-fp32 cache dtypes, which is why the sweep traces at
    bfloat16."""

    name = "NoDtypePromotionDrift"
    description = "no cache-shaped buffer wider than the cache dtype"

    def applies(self, t: LintTarget) -> bool:
        return bool(t.cache_shapes) and t.cache_dtype is not None

    def check(self, t: LintTarget) -> List:
        shapes = {tuple(s) for s in t.cache_shapes}
        hits = [v for v in walker.iter_values(t.graph)
                if tuple(v.shape) in shapes
                and _wider_float(v.dtype, t.cache_dtype)]
        if hits:
            seen = sorted({(tuple(v.shape), str(v.dtype)) for v in hits})
            return [self.finding(
                t, f"{len(hits)} cache-shaped buffers wider than the "
                   f"{t.cache_dtype} cache, e.g. {seen[:3]}",
                detail={"cache_dtype": str(t.cache_dtype),
                        "hits": [[list(s), d] for s, d in seen[:10]]})]
        return []


class NoHostTransferInStepLoop(LintRule):
    """The decode step program must be host-silent.

    Every serving stream in the batch shares one step; one host sync
    anywhere in it (a value read on the host, an output whose shape
    depends on device data, a copy to the CPU) stalls the host on the
    device once per decoded token and serializes the whole batch on host
    latency — and rules out capturing the step as one CUDA graph."""

    name = "NoHostTransferInStepLoop"
    description = "no host sync in the decode step program"

    def applies(self, t: LintTarget) -> bool:
        return t.phase == "decode"

    def check(self, t: LintTarget) -> List:
        bad = sorted(set(walker.host_sync_nodes(t.graph)))
        if bad:
            return [self.finding(
                t, f"host-sync ops in the step program: {bad}",
                detail={"ops": bad})]
        return []


def _host_sync_counts(graph) -> dict:
    return dict(collections.Counter(walker.host_sync_nodes(graph)))


class NoHostTransferInObsHooks(LintRule):
    """Instrumentation must never reach into the device program.

    The observer's discipline is host-side hooks at the engine's Python
    seams; the temptation it guards against is a forward path consulting
    ``repro_torch.obs.get_active()`` and reading a device value when
    observability is on — which would turn "obs on" into a per-token host
    round trip.  The sweep re-traces every serving program with an ACTIVE
    observer into ``instrumented_graph``; this rule diffs host-sync counts
    against the plain trace and demands ZERO new ones.  (Count diff, not
    absence: a program legitimately holding one is
    ``NoHostTransferInStepLoop``'s business, not ours.)"""

    name = "NoHostTransferInObsHooks"
    description = ("active-observer re-trace adds zero host syncs to the "
                   "serving program")

    def applies(self, t: LintTarget) -> bool:
        return t.instrumented_graph is not None

    def check(self, t: LintTarget) -> List:
        base = _host_sync_counts(t.graph)
        instr = _host_sync_counts(t.instrumented_graph)
        new = {n: c - base.get(n, 0) for n, c in instr.items()
               if c > base.get(n, 0)}
        if new:
            return [self.finding(
                t, f"instrumented program makes host syncs the plain "
                   f"program does not: {new} — obs hooks must stay "
                   f"host-side",
                detail={"new": new, "base": base, "instrumented": instr})]
        return []


class NoDequantizedPoolBuffer(LintRule):
    """paged_q8 programs must never hold a full-precision pool shadow.

    The int8 pool's whole point is 2x (vs bf16) / 4x (vs fp32) memory on
    the largest buffers in a serve; the tempting bug is a convenience
    ``pool.float()`` somewhere in a forward path, which silently
    materializes the very buffer the format deleted.  Dequant is only
    legal per tile (inside the kernel) or on table-GATHERED rows (bounded
    by the request's live pages, not the pool) — so no value in a
    paged_q8 program may have a pool shape (layer-stacked OR per-layer,
    both are in ``cache_shapes``) at any dtype wider than one byte.
    Itemsize — not float-ness — is the test: an int32 shadow would be
    just as fatal."""

    name = "NoDequantizedPoolBuffer"
    description = ("no pool-shaped buffer wider than int8 in a paged_q8 "
                   "program")

    def applies(self, t: LintTarget) -> bool:
        return t.cache_kind == "paged_q8" and bool(t.cache_shapes)

    def check(self, t: LintTarget) -> List:
        shapes = {tuple(s) for s in t.cache_shapes}
        hits = [v for v in walker.iter_values(t.graph)
                if tuple(v.shape) in shapes and v.element_size() > 1]
        if hits:
            seen = sorted({(tuple(v.shape), str(v.dtype)) for v in hits})
            return [self.finding(
                t, f"{len(hits)} pool-shaped buffers wider than int8 in a "
                   f"paged_q8 program, e.g. {seen[:3]} — a dequantized "
                   f"shadow of the quantized pool",
                detail={"hits": [[list(s), d] for s, d in seen[:10]]})]
        return []


BUILTIN_RULES = (NoForbiddenMatmul(), NoOversizedBuffer(),
                 DonationEffective(), NoDtypePromotionDrift(),
                 NoHostTransferInStepLoop(), NoHostTransferInObsHooks(),
                 NoDequantizedPoolBuffer())

for _rule in BUILTIN_RULES:
    register_rule(_rule)
