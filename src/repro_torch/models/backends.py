"""Backend registries: the seam between the model and its KV cache.

Counterpart of ``repro.models.backends``.  Every serving route is a
registered backend keyed ``(cache_kind, style, impl)``:

  cache_kind  "dense" (per-slot ring buffer, ``DecodeCache``), "paged"
              (block-table page pool, ``PagedDecodeCache``) or "paged_q8"
              (the same pool as int8 pages with per-(page, kv-head)
              scales, ``PagedQ8DecodeCache``)
  style       "generic" (projects q/k/v as the config dictates, covering
              unmerged models and the kp/vp merged variants) or "merged"
              (the qp fast path: the residual stream IS the query, no Q or
              P weights exist to read)
  impl        "cuda" (the hand-written kernels) or "torch" (the plain
              PyTorch versions, which run on the CPU)

Three serving programs have one dispatcher each looking their route up
here: decode — :class:`AttentionBackend` (a per-layer, per-token
attention step) behind ``models.transformer.forward_step``; prefill —
:class:`PrefillBackend` (a whole-sequence program) behind
``models.transformer.forward_prefill``; chunked prefill —
:class:`ChunkBackend` (one fixed-width slice of a prompt against the
serving cache) behind ``models.transformer.forward_prefill_chunk``.
Registering a route::

    def my_step(lp, cfg, u1, k_layer, v_layer, ctx):
        # u1 (B,1,d) stream; ctx carries "length", "impl" and the cache
        # kind's own keys ("kv_pos"; paged and paged_q8: "block_tables",
        # "append"; paged_q8 k_layer/v_layer are (pool, scale) pairs)
        return cat, k_layer, v_layer

    backends.register_backend("dense", "generic", my_step)

Lookups of unregistered combinations fail loudly with the list of
registered keys; there is no silent fallback path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

CACHE_KINDS = ("dense", "paged", "paged_q8")
STYLES = ("generic", "merged")
IMPLS = ("cuda", "torch")

# step(lp, cfg, u1, k_layer, v_layer, ctx) -> (cat, k_layer, v_layer)
StepFn = Callable[..., Tuple]


@dataclasses.dataclass(frozen=True)
class AttentionBackend:
    """One registered (cache_kind, style, impl) decode-attention route.
    ``fast_path`` is True when the per-token step reads no Q or P weights
    (the paper's merged qp layout cashed in at serve time)."""
    cache_kind: str
    style: str
    impl: str
    step: StepFn
    fast_path: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.cache_kind, self.style, self.impl)


_REGISTRY: Dict[Tuple[str, str, str], AttentionBackend] = {}


def register_backend(cache_kind: str, style: str, step: StepFn, *,
                     impls: Tuple[str, ...] = IMPLS,
                     fast_path: bool = False) -> None:
    """Register ``step`` under (cache_kind, style) for each impl in
    ``impls``.  Re-registration overwrites (latest wins)."""
    for impl in impls:
        _REGISTRY[(cache_kind, style, impl)] = AttentionBackend(
            cache_kind=cache_kind, style=style, impl=impl, step=step,
            fast_path=fast_path)


def get_backend(cache_kind: str, style: str, impl: str) -> AttentionBackend:
    """Look up one combo; unknown combos raise KeyError naming the
    offending key and every registered one."""
    try:
        return _REGISTRY[(cache_kind, style, impl)]
    except KeyError:
        raise KeyError(
            f"no AttentionBackend registered for (cache_kind={cache_kind!r}, "
            f"style={style!r}, impl={impl!r}); registered combos: "
            f"{registered_backends()}") from None


def registered_backends() -> List[Tuple[str, str, str]]:
    return sorted(_REGISTRY)


# run(params, cfg, inputs, dest, ctx) -> (last_logits, filled destination)
PrefillFn = Callable[..., Tuple]


@dataclasses.dataclass(frozen=True)
class PrefillBackend:
    """One registered (cache_kind, style, impl) prefill route: run the
    stack over the prompt, collect per-layer KV and write it into the
    destination.  ``fast_path`` is True when the program reads no Q or P
    weights."""
    cache_kind: str
    style: str
    impl: str
    run: PrefillFn
    fast_path: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.cache_kind, self.style, self.impl)


_PREFILL_REGISTRY: Dict[Tuple[str, str, str], PrefillBackend] = {}


def register_prefill_backend(cache_kind: str, style: str, run: PrefillFn, *,
                             impls: Tuple[str, ...] = IMPLS,
                             fast_path: bool = False) -> None:
    """Register ``run`` under (cache_kind, style) for each impl in
    ``impls``.  Re-registration overwrites (latest wins)."""
    for impl in impls:
        _PREFILL_REGISTRY[(cache_kind, style, impl)] = PrefillBackend(
            cache_kind=cache_kind, style=style, impl=impl, run=run,
            fast_path=fast_path)


def get_prefill_backend(cache_kind: str, style: str,
                        impl: str) -> PrefillBackend:
    """Look up one prefill combo; unknown combos raise KeyError naming the
    offending key and every registered one."""
    try:
        return _PREFILL_REGISTRY[(cache_kind, style, impl)]
    except KeyError:
        raise KeyError(
            f"no PrefillBackend registered for (cache_kind={cache_kind!r}, "
            f"style={style!r}, impl={impl!r}); registered prefill combos: "
            f"{registered_prefill_backends()}") from None


def registered_prefill_backends() -> List[Tuple[str, str, str]]:
    return sorted(_PREFILL_REGISTRY)


# ---------------------------------------------------------------------------
# chunk: fixed-width prompt-slice prefill programs, same key space
# ---------------------------------------------------------------------------

# run(params, cfg, chunk, dest, ctx) -> (last_logits, filled destination)
ChunkFn = Callable[..., Tuple]


@dataclasses.dataclass(frozen=True)
class ChunkBackend:
    """One registered (cache_kind, style, impl) chunked-prefill route: run
    the stack over ONE fixed-width slice ``[start, start+C)`` of a single
    prompt, attending to everything the slot holds so far (earlier chunks
    and the slice itself), and write the slice's KV into the batched
    cache or the pool's pages in place.  ``fast_path`` is True when the
    program reads no Q or P weights (the merged qp layout, chunk by
    chunk)."""
    cache_kind: str
    style: str
    impl: str
    run: ChunkFn
    fast_path: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.cache_kind, self.style, self.impl)


_CHUNK_REGISTRY: Dict[Tuple[str, str, str], ChunkBackend] = {}


def register_chunk_backend(cache_kind: str, style: str, run: ChunkFn, *,
                           impls: Tuple[str, ...] = IMPLS,
                           fast_path: bool = False) -> None:
    """Register ``run`` under (cache_kind, style) for each impl in
    ``impls``.  Re-registration overwrites (latest wins)."""
    for impl in impls:
        _CHUNK_REGISTRY[(cache_kind, style, impl)] = ChunkBackend(
            cache_kind=cache_kind, style=style, impl=impl, run=run,
            fast_path=fast_path)


def get_chunk_backend(cache_kind: str, style: str, impl: str) -> ChunkBackend:
    """Look up one chunk combo; unknown combos raise KeyError naming the
    offending key and every registered one."""
    try:
        return _CHUNK_REGISTRY[(cache_kind, style, impl)]
    except KeyError:
        raise KeyError(
            f"no ChunkBackend registered for (cache_kind={cache_kind!r}, "
            f"style={style!r}, impl={impl!r}); registered chunk combos: "
            f"{registered_chunk_backends()}") from None


def registered_chunk_backends() -> List[Tuple[str, str, str]]:
    return sorted(_CHUNK_REGISTRY)
