"""Registry-wide invariant sweep: lint every registered backend combo.

Counterpart of ``repro.lint.sweep``.  ``sweep()`` enumerates the LIVE
``models.backends`` registries — every registered ``(cache_kind, style,
impl)`` decode, prefill and chunk backend — builds each combo's serving
program at reduced shape through the dispatchers the engine serves with
(``forward_step`` / ``forward_prefill`` / ``forward_prefill_chunk``),
traces it (``walker.trace``: ``make_fx`` on real tensors) and runs every
applicable registered rule on the graph.  Registering a new backend combo
gets it linted with no new test code; registering a new rule sweeps the
whole grid with no new per-combo code.

Programs run at **bfloat16**: ``NoDtypePromotionDrift`` hunts float32
shadows of the cache, invisible when the cache itself is float32.

``device``: ``"cpu"`` traces both impls on the CPU, where a ``"cuda"``
combo's kernel operators run their plain versions inside one opaque node
each.  ``"cuda"`` traces the ``"cuda"`` combos on the card — their
kernels launch inside the trace — and the ``"torch"`` combos on the CPU
(the plain route runs on CPU tensors only).  Each target records the
kernel nodes of its graph and the launches its trace made.

Coverage is loud, not best-effort: a registered cache kind or style the
sweep has no target builder for yields an ERROR finding (rather than a
silently unlinted combo), and the sweep asserts its target count equals
the registry's.  New cache kinds extend the sweep with
``register_sweep_builders(cache_kind, decode=…, prefill=…, chunk=…)``.

Shapes: ``SWEEP_MAX_LEN`` is chosen to collide with no model or pool
dimension (asserted for every swept model, ``check_max_len``), so any
max_len-sized value a rule finds is a real worst-case intermediate.  The
sweep model is the reference's recipe (reduced skipless Mistral-7B with 4
kv heads, and its qp merge) at a head dim the kernels take
(``SWEEP_D_HEAD``), so the same programs run on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import merge_skipless
from repro_torch.kernels import launch_counts
from repro_torch.lint import walker
from repro_torch.lint.rules import Finding, LintRule, LintTarget, run_rules
from repro_torch.models import (DenseChunkDest, DensePrefillDest,
                                PagedChunkDest, PagedPrefillDest,
                                PagedQ8ChunkDest, PagedQ8PrefillDest,
                                backends, forward_prefill,
                                cache_spec, forward_prefill_chunk,
                                forward_step, init_cache, init_paged_cache,
                                init_paged_q8_cache, init_params,
                                paged_table_blocks)
from repro_torch.models.transformer import n_attn_layers

SWEEP_DTYPE = "bfloat16"   # sub-fp32 so promotion drift is observable
SWEEP_MAX_LEN = 160        # collides with no model/pool dim (check_max_len)
SWEEP_BLOCK = 8
SWEEP_POOL_BLOCKS = 21     # 21*8 = 168 != SWEEP_MAX_LEN
SWEEP_BUCKET = 16
SWEEP_DECODE_LEN = 32
SWEEP_CHUNK = 8            # chunk width (ring paged pins it to the block)
SWEEP_CHUNK_LEN = 16       # dense chunk cache len: == the reduced configs'
#                            sliding window, so the window is NON-binding
#                            and dense chunking is legal (cf. adapters)
SWEEP_D_HEAD = 64          # a head dim every attention kernel takes


@dataclasses.dataclass
class TargetReport:
    """One swept combo: which rules ran, what they found, its matrix
    products (``walker.count_matmuls``), its host syncs
    (``walker.host_sync_nodes``: judged in decode only; the paged prefill
    and chunk programs select their pages with ``torch.nonzero``, as the
    reference's drop with ``mode="drop"``) and its kernel calls: the
    graph's ``repro_torch`` nodes and the launches its trace made (0 on
    the CPU, where the operators run their plain versions)."""
    key: str
    phase: str
    cache_kind: str
    style: str
    impl: str
    rules_run: List[str]
    findings: List[Finding]
    device: str = "cpu"
    n_kernel_nodes: int = 0
    launches: int = 0
    n_attn_layers: int = 0
    n_matmuls: int = 0
    host_syncs: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {"key": self.key, "phase": self.phase,
                "cache_kind": self.cache_kind, "style": self.style,
                "impl": self.impl, "rules_run": self.rules_run,
                "findings": [f.to_dict() for f in self.findings],
                "device": self.device,
                "n_kernel_nodes": self.n_kernel_nodes,
                "launches": self.launches,
                "n_attn_layers": self.n_attn_layers,
                "n_matmuls": self.n_matmuls, "host_syncs": self.host_syncs}


@dataclasses.dataclass
class SweepReport:
    targets: List[TargetReport]
    n_decode_backends: int
    n_prefill_backends: int
    n_chunk_backends: int = 0

    @property
    def findings(self) -> List[Finding]:
        return [f for t in self.targets for f in t.findings]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def ok(self) -> bool:
        return not self.errors

    @property
    def n_decode_targets(self) -> int:
        return sum(1 for t in self.targets if t.phase == "decode")

    @property
    def n_prefill_targets(self) -> int:
        return sum(1 for t in self.targets if t.phase == "prefill")

    @property
    def n_chunk_targets(self) -> int:
        return sum(1 for t in self.targets if t.phase == "chunk")

    def to_dict(self) -> Dict[str, Any]:
        return {"targets": [t.to_dict() for t in self.targets],
                "n_decode_backends": self.n_decode_backends,
                "n_prefill_backends": self.n_prefill_backends,
                "n_chunk_backends": self.n_chunk_backends,
                "ok": self.ok}


# ---------------------------------------------------------------------------
# target builders, keyed by cache_kind — the extension point new cache
# kinds register alongside their adapter/backends
# ---------------------------------------------------------------------------

# builder(cfg, params, impl) -> dict of LintTarget fields
#   {"graph": …, "instrumented_graph": …, "donated": …, "max_len": …,
#    "cache_shapes": …, "cache_dtype": …, "launches": …}
# on the device the params lie on
TargetBuilder = Callable[..., Dict[str, Any]]

_DECODE_BUILDERS: Dict[str, TargetBuilder] = {}
_PREFILL_BUILDERS: Dict[str, TargetBuilder] = {}
_CHUNK_BUILDERS: Dict[str, TargetBuilder] = {}


def register_sweep_builders(cache_kind: str, *,
                            decode: Optional[TargetBuilder] = None,
                            prefill: Optional[TargetBuilder] = None,
                            chunk: Optional[TargetBuilder] = None) -> None:
    """Register how the sweep builds ``cache_kind``'s reduced-shape
    programs (latest wins, like every registry here)."""
    if decode is not None:
        _DECODE_BUILDERS[cache_kind] = decode
    if prefill is not None:
        _PREFILL_BUILDERS[cache_kind] = prefill
    if chunk is not None:
        _CHUNK_BUILDERS[cache_kind] = chunk


def _float_cache_fields(cache) -> Tuple[Tuple[Tuple[int, ...], ...], Any]:
    """(shapes, dtype) of the cache's float leaves (layer-stacked) — what
    ``NoDtypePromotionDrift`` guards against wider shadows of."""
    leaves = [t for t in cache if isinstance(t, torch.Tensor)
              and t.is_floating_point()]
    return (tuple(tuple(t.shape) for t in leaves),
            leaves[0].dtype if leaves else None)


def _q8_pool_fields(cache) -> Tuple[Tuple[Tuple[int, ...], ...], Any]:
    """(shapes, dtype) of the q8 cache's INT8 pool leaves — layer-stacked
    AND per-layer, so ``NoDequantizedPoolBuffer`` catches a dequantized
    shadow of one layer's pool too.  The float scale rows are excluded:
    they are supposed to be float."""
    pools = [t for t in cache if isinstance(t, torch.Tensor)
             and t.dtype == torch.int8]
    shapes = tuple(tuple(t.shape) for t in pools) \
        + tuple(tuple(t.shape[1:]) for t in pools)
    return shapes, (pools[0].dtype if pools else None)


def _program(fn, *args) -> Dict[str, Any]:
    """Trace ``fn(*args)`` twice: plainly (the graph, what it returned
    and the kernel launches the trace made) and with the
    ``repro_torch.obs`` observer ACTIVE (``instrumented_graph``): any
    forward-path code consulting ``obs.get_active()`` takes its obs-on
    branch there, so ``NoHostTransferInObsHooks`` can diff the two."""
    from repro_torch.obs import Observer, activated

    box: List[Any] = []

    def run(*a):
        box.append(fn(*a))
        return box[-1]

    before = sum(launch_counts().values())
    graph = walker.trace(run, *args)
    launches = sum(launch_counts().values()) - before
    with activated(Observer(trace_capacity=64)):
        instrumented = walker.trace(fn, *args)
    return {"graph": graph, "instrumented_graph": instrumented,
            "launches": launches, "returned": box[0]}


def _donated(names, given, returned) -> Tuple[Tuple[str, Any, Any], ...]:
    """(name, the leaf passed in, the leaf returned in its place)."""
    return tuple((n, g, r) for n, g, r in zip(names, given, returned))


def _device(params) -> torch.device:
    return params["embed"]["table"].device


def _row(*vals, device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int32, device=device)


def _tokens(cfg, n, device) -> torch.Tensor:
    return (torch.arange(n, dtype=torch.int32, device=device) * 7 + 3) \
        % cfg.vocab_size


def _mapped(cache, device):
    """The cache with slot 0's table mapped to pages 1.. and 11 tokens
    written, so the step's write lands in a mapped page."""
    mb = cache.block_tables.shape[1]
    return cache._replace(
        block_tables=torch.arange(1, mb + 1, dtype=torch.int32,
                                  device=device)[None],
        length=_row(11, device=device))


def _build_decode_dense(cfg, params, impl) -> Dict[str, Any]:
    dev = _device(params)
    cache = init_cache(cfg, 1, SWEEP_DECODE_LEN, device=dev)

    def fn(p, t, c):
        return forward_step(p, cfg, t, c, impl=impl)

    prog = _program(fn, params, _tokens(cfg, 1, dev), cache)
    shapes, dtype = _float_cache_fields(cache)
    # the engine writes the cache in place (the reference donates it)
    names = ("k", "v", "kv_pos")
    back = prog.pop("returned")[1]
    return dict(prog, cache_shapes=shapes, cache_dtype=dtype,
                donated=_donated(names, [getattr(cache, n) for n in names],
                                 [getattr(back, n) for n in names]))


def _build_decode_paged(cfg, params, impl, q8: bool = False):
    dev = _device(params)
    init = init_paged_q8_cache if q8 else init_paged_cache
    cache = _mapped(init(cfg, SWEEP_POOL_BLOCKS, SWEEP_BLOCK, 1,
                         SWEEP_DECODE_LEN, device=dev), dev)

    def fn(p, t, c):
        return forward_step(p, cfg, t, c, impl=impl)

    prog = _program(fn, params, _tokens(cfg, 1, dev), cache)
    shapes, dtype = (_q8_pool_fields if q8 else _float_cache_fields)(cache)
    names = ("k", "v", "k_scale", "v_scale") if q8 else ("k", "v")
    back = prog.pop("returned")[1]
    return dict(prog, cache_shapes=shapes, cache_dtype=dtype,
                donated=_donated(names, [getattr(cache, n) for n in names],
                                 [getattr(back, n) for n in names]))


def _build_decode_paged_q8(cfg, params, impl) -> Dict[str, Any]:
    return _build_decode_paged(cfg, params, impl, q8=True)


def _build_prefill_dense(cfg, params, impl) -> Dict[str, Any]:
    dev = _device(params)

    def fn(p, t, n):
        return forward_prefill(p, cfg, t, DensePrefillDest(SWEEP_DECODE_LEN),
                               impl=impl, true_len=n)

    prog = _program(fn, params, _tokens(cfg, SWEEP_BUCKET, dev)[None],
                    _row(SWEEP_BUCKET - 3, device=dev))
    prog.pop("returned")
    spec = cache_spec(cfg, 1, SWEEP_DECODE_LEN)
    shapes = tuple(spec[n][0] for n in ("k", "v"))
    dtype = spec["k"][1]
    # dense prefill hands over no cache (it BUILDS the fresh one)
    return dict(prog, cache_shapes=shapes, cache_dtype=dtype)


def _build_prefill_paged(cfg, params, impl, q8: bool = False):
    dev = _device(params)
    init = init_paged_q8_cache if q8 else init_paged_cache
    pool = init(cfg, SWEEP_POOL_BLOCKS, SWEEP_BLOCK, 1, SWEEP_MAX_LEN,
                device=dev)
    bids = _row(*range(1, SWEEP_BUCKET // SWEEP_BLOCK + 1), device=dev)
    if q8:
        names = ("k", "v", "k_scale", "v_scale")

        def fn(p, t, n, k, v, ks, vs, b):
            return forward_prefill(p, cfg, t,
                                   PagedQ8PrefillDest(k, v, ks, vs, b),
                                   impl=impl, true_len=n)
    else:
        names = ("k", "v")

        def fn(p, t, n, k, v, b):
            return forward_prefill(p, cfg, t, PagedPrefillDest(k, v, b),
                                   impl=impl, true_len=n)

    leaves = [getattr(pool, n) for n in names]
    prog = _program(fn, params, _tokens(cfg, SWEEP_BUCKET, dev)[None],
                    _row(SWEEP_BUCKET - 3, device=dev), *leaves, bids)
    shapes, dtype = (_q8_pool_fields if q8 else _float_cache_fields)(pool)
    # the paged adapters hand the pools (and scales) over to be written
    return dict(prog, max_len=SWEEP_MAX_LEN, cache_shapes=shapes,
                cache_dtype=dtype,
                donated=_donated(names, leaves, prog.pop("returned")[1]))


def _build_prefill_paged_q8(cfg, params, impl) -> Dict[str, Any]:
    return _build_prefill_paged(cfg, params, impl, q8=True)


def _build_chunk_dense(cfg, params, impl) -> Dict[str, Any]:
    dev = _device(params)
    cache = init_cache(cfg, 1, SWEEP_CHUNK_LEN, device=dev)

    def fn(p, t, c):
        return forward_prefill_chunk(p, cfg, t, DenseChunkDest(c, 0),
                                     start=0, true_len=SWEEP_CHUNK - 2,
                                     impl=impl, max_len=SWEEP_CHUNK_LEN)

    prog = _program(fn, params, _tokens(cfg, SWEEP_CHUNK, dev)[None], cache)
    shapes, dtype = _float_cache_fields(cache)
    names = ("k", "v", "kv_pos")
    back = prog.pop("returned")[1]
    return dict(prog, cache_shapes=shapes, cache_dtype=dtype,
                donated=_donated(names, [getattr(cache, n) for n in names],
                                 [getattr(back, n) for n in names]))


def _build_chunk_paged(cfg, params, impl, q8: bool = False):
    dev = _device(params)
    init = init_paged_q8_cache if q8 else init_paged_cache
    pool = init(cfg, SWEEP_POOL_BLOCKS, SWEEP_BLOCK, 1, SWEEP_MAX_LEN,
                device=dev)
    mb = paged_table_blocks(cfg, SWEEP_BLOCK, SWEEP_MAX_LEN)
    trow = torch.full((1, mb), -1, dtype=torch.int32, device=dev)
    trow[0, 0] = 1
    bids = _row(1, device=dev)  # (SWEEP_CHUNK // SWEEP_BLOCK,) pages
    if q8:
        names = ("k", "v", "k_scale", "v_scale")

        def fn(p, t, k, v, ks, vs, tr, b):
            return forward_prefill_chunk(
                p, cfg, t, PagedQ8ChunkDest(k, v, ks, vs, tr, b), start=0,
                true_len=SWEEP_CHUNK - 2, impl=impl)
    else:
        names = ("k", "v")

        def fn(p, t, k, v, tr, b):
            return forward_prefill_chunk(
                p, cfg, t, PagedChunkDest(k, v, tr, b), start=0,
                true_len=SWEEP_CHUNK - 2, impl=impl)

    leaves = [getattr(pool, n) for n in names]
    prog = _program(fn, params, _tokens(cfg, SWEEP_CHUNK, dev)[None],
                    *leaves, trow, bids)
    shapes, dtype = (_q8_pool_fields if q8 else _float_cache_fields)(pool)
    return dict(prog, cache_shapes=shapes, cache_dtype=dtype,
                donated=_donated(names, leaves, prog.pop("returned")[1]))


def _build_chunk_paged_q8(cfg, params, impl) -> Dict[str, Any]:
    return _build_chunk_paged(cfg, params, impl, q8=True)


register_sweep_builders("dense", decode=_build_decode_dense,
                        prefill=_build_prefill_dense,
                        chunk=_build_chunk_dense)
register_sweep_builders("paged", decode=_build_decode_paged,
                        prefill=_build_prefill_paged,
                        chunk=_build_chunk_paged)
register_sweep_builders("paged_q8", decode=_build_decode_paged_q8,
                        prefill=_build_prefill_paged_q8,
                        chunk=_build_chunk_paged_q8)


# ---------------------------------------------------------------------------
# the sweep itself
# ---------------------------------------------------------------------------

def sweep_models(device="cpu") -> Dict[str, Tuple[Any, Any]]:
    """style-key -> (cfg, params) at reduced shape and dtype
    ``SWEEP_DTYPE`` on ``device``: "generic" is the unmerged skipless
    model, "merged" its qp (Q/P-free) rewrite — the reference's recipe,
    at head dim ``SWEEP_D_HEAD``."""
    cfg = reduce_config(get_config("mistral-7b"))
    cfg = cfg.with_(block_style="skipless", n_kv_heads=4,
                    d_head=SWEEP_D_HEAD, d_model=cfg.n_heads * SWEEP_D_HEAD,
                    dtype=SWEEP_DTYPE, param_dtype=SWEEP_DTYPE)
    params = init_params(cfg, seed=0, device=device)
    mparams, mcfg = merge_skipless(params, cfg, "qp")
    return {"generic": (cfg, params), "merged": (mcfg, mparams)}


def check_max_len(cfg) -> None:
    """Raise ValueError if ``SWEEP_MAX_LEN`` equals a dimension of ``cfg``
    or of the sweep's pools: a max_len-sized value would then not be a
    worst-case buffer."""
    dims = {cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.sliding_window,
            cfg.n_heads * cfg.d_head, SWEEP_POOL_BLOCKS, SWEEP_BLOCK,
            SWEEP_POOL_BLOCKS * SWEEP_BLOCK, SWEEP_BUCKET, SWEEP_DECODE_LEN,
            SWEEP_CHUNK, SWEEP_CHUNK_LEN,
            paged_table_blocks(cfg, SWEEP_BLOCK, SWEEP_MAX_LEN)}
    if SWEEP_MAX_LEN in dims:
        raise ValueError(f"SWEEP_MAX_LEN {SWEEP_MAX_LEN} collides with a "
                         f"dimension of {cfg.name} or of the sweep's pools")


def _uncovered(phase: str, key: Tuple[str, str, str], why: str
               ) -> TargetReport:
    ck, st, impl = key
    return TargetReport(key=f"{phase}:{ck}/{st}/{impl}", phase=phase,
                        cache_kind=ck, style=st, impl=impl, rules_run=[],
                        findings=[Finding(
                            rule="SweepCoverage",
                            target=f"{phase}:{ck}/{st}/{impl}",
                            message=f"registered backend NOT linted: {why} "
                                    f"— register a sweep builder/model so "
                                    f"this combo is covered",
                        )])


def _sweep_phase(phase: str, keys: List[Tuple[str, str, str]],
                 models: Dict[str, Dict[str, Tuple[Any, Any]]],
                 builders: Dict[str, TargetBuilder],
                 rules: Optional[List[LintRule]],
                 progress: Optional[Callable[[str], None]]
                 ) -> List[TargetReport]:
    # trace each (cache_kind, style, impl) program once, keeping the
    # generic programs around as the merged targets' diff baselines
    out: List[TargetReport] = []
    generic_graphs: Dict[Tuple[str, str], Any] = {}
    for ck, st, impl in sorted(keys, key=lambda k: (k[0], k[2], k[1])):
        if st not in models[impl]:
            out.append(_uncovered(phase, (ck, st, impl),
                                  f"no sweep model for style {st!r}"))
            continue
        if ck not in builders:
            out.append(_uncovered(phase, (ck, st, impl),
                                  f"no sweep builder for cache kind {ck!r}"))
            continue
        cfg, params = models[impl][st]
        if progress:
            progress(f"{phase}:{ck}/{st}/{impl}")
        built = builders[ck](cfg, params, impl)
        launches = built.pop("launches")
        if st == "generic":
            generic_graphs[(ck, impl)] = built["graph"]
        target = LintTarget(phase=phase, cache_kind=ck, style=st, impl=impl,
                            cfg=cfg,
                            source_graph=generic_graphs.get((ck, impl)),
                            n_attn_layers=n_attn_layers(cfg),
                            device=_device(params).type, **built)
        ran, findings = run_rules(target, rules)
        out.append(TargetReport(
            key=target.key, phase=phase, cache_kind=ck, style=st, impl=impl,
            rules_run=ran, findings=findings, device=target.device,
            n_kernel_nodes=len(walker.kernel_nodes(target.graph)),
            launches=launches, n_attn_layers=target.n_attn_layers,
            n_matmuls=walker.count_matmuls(target.graph),
            host_syncs=walker.host_sync_nodes(target.graph)))
    return out


def sweep(rules: Optional[List[LintRule]] = None,
          progress: Optional[Callable[[str], None]] = None, *,
          device="cpu", models: Optional[Dict[str, Tuple[Any, Any]]] = None,
          impls: Optional[Tuple[str, ...]] = None) -> SweepReport:
    """Lint every registered decode, prefill and chunk backend.

    ``rules`` defaults to every registered rule; ``progress`` (if given)
    is called with each target key as it is traced.  ``device``: where the
    ``"cuda"`` combos run ("cpu": their operators run the plain versions;
    "cuda" raises without a card); the ``"torch"`` combos always run on
    the CPU.  ``models`` (style -> (cfg, params), default
    ``sweep_models()`` on each impl's device) replaces the sweep models
    for every impl swept; ``impls`` (default every registered impl)
    restricts the sweep to those impls.  The returned report covers
    EXACTLY the live registries' combos of the swept impls — one target
    per combo, asserted — with loud findings for combos the sweep cannot
    build."""
    import repro_torch.lint.builtin  # noqa: F401  (ensure built-ins registered)
    impls = tuple(impls or backends.IMPLS)
    card = resolve_device(device)
    where = {impl: card if impl == "cuda" else torch.device("cpu")
             for impl in impls}
    if models is None:
        by_dev: Dict[torch.device, Dict[str, Tuple[Any, Any]]] = {}
        for dev in set(where.values()):
            by_dev[dev] = sweep_models(dev)
        per_impl = {impl: by_dev[where[impl]] for impl in impls}
    else:
        per_impl = {impl: models for impl in impls}
    for ms in per_impl.values():
        for cfg, _ in ms.values():
            check_max_len(cfg)

    def mine(keys):
        return [k for k in keys if k[2] in impls]

    dkeys = mine(backends.registered_backends())
    pkeys = mine(backends.registered_prefill_backends())
    ckeys = mine(backends.registered_chunk_backends())
    targets = _sweep_phase("decode", dkeys, per_impl, _DECODE_BUILDERS,
                           rules, progress)
    targets += _sweep_phase("prefill", pkeys, per_impl, _PREFILL_BUILDERS,
                            rules, progress)
    targets += _sweep_phase("chunk", ckeys, per_impl, _CHUNK_BUILDERS,
                            rules, progress)
    report = SweepReport(targets=targets, n_decode_backends=len(dkeys),
                         n_prefill_backends=len(pkeys),
                         n_chunk_backends=len(ckeys))
    assert report.n_decode_targets == len(dkeys), (
        report.n_decode_targets, len(dkeys))
    assert report.n_prefill_targets == len(pkeys), (
        report.n_prefill_targets, len(pkeys))
    assert report.n_chunk_targets == len(ckeys), (
        report.n_chunk_targets, len(ckeys))
    return report
