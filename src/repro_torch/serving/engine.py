"""Serving engine: prefill + batched decode over a fixed set of slots.

Counterpart of ``repro.serving.engine`` for the dense cache, the paged
pool and the int8 paged pool.  A VLM request brings its vision tokens to
``submit(req, vision=)`` (``generate(..., vision=)``: one array per
prompt); they are prefilled once into the slot's cross K/V on the dense
cache (the paged pools refuse them).  An encoder (``causal=False``) has
no engine.  The engine drives exactly two seams:

  * a ``KVCacheAdapter`` (``serving.adapters``) owning the cache: device
    state, admission, the prefill-insert path and room for each next
    token (paged: map, copy-on-write or recycle the page it falls in);
  * the ``models.backends`` registries keyed (cache_kind, style, impl):
    decode is ONE function, ``models.forward_step``, which looks up its
    per-layer attention route in the AttentionBackend registry, and the
    adapter's prefill is ONE dispatcher, ``models.forward_prefill``.
    Merged (Q/P-removed) "qp" models take the fast path in both phases
    (``merged_fast_path`` / ``merged_prefill_fast_path``); kp/vp merged
    variants route through the generic backends.  Unknown combos fail at
    construction with the registry's KeyError, not mid-serve.

``impl="cuda"`` runs the hand-written kernels and needs ``device="cuda"``;
``impl="torch"`` runs the plain PyTorch versions and needs
``device="cpu"``.  Any other pairing raises ValueError at construction;
``device="cuda"`` without a card raises RuntimeError.

Prompt lengths are bucketed (padded with token 0 to the next power of
two, exact logits and cache via ``true_len``;
``ServeConfig.bucket_prompts=False`` turns it off) except for stacks with
SSM layers, whose prefill state is not position-masked (a padded tail
would run through the scan), and for sliding-window configs on the dense
cache, whose window-sized ring would drop real positions under a padded
tail: those prompts reach prefill at their own length (the paged pool
stores absolute positions, so it buckets windowed configs too; it serves
attention-only stacks).  Every prompt is padded up to the adapter's ``bucket_align``,
bucketed or not: the int8 pool quantizes whole pages.  An MoE prefill
routes its padded tail with the prompt, so under capacity dropping a pad
token can take a real token's expert slot: the port pads exactly as the
reference does.

On the paged pool a request that does not fit is deferred (``submit``
returns False and ``generate`` retries it after others finish), and when
a decode step finds the pool exhausted the youngest request is preempted:
its pages are released and it is resubmitted later, re-prefilling its
prompt and the tokens it had generated.

Sampling is greedy (``temperature`` 0) or temperature / top-k with one
PRIVATE ``torch.Generator`` per request on the engine's device, seeded
from (``ServeConfig.seed``, the request's submission index) and advanced
only by that request's own draws: a sampled continuation does not depend
on co-scheduled traffic, and a preempted request resumes its stream from
the saved generator state (``Request.key_state``), not from its start.
JAX's PRNG draws cannot be reproduced in torch, so sampled streams differ
from the reference's while keeping its properties.

Observability (``repro_torch.obs``) as in the reference: the engine always
owns a ``MetricsRegistry`` whose counters back ``Engine.stats``, and emits
request and step events through ONE observer (``ServeConfig.obs``): the
shared no-op ``NULL`` by default, or an ``Observer`` recording spans and
histograms.  Every hook is called with host values after the host read
that ends its work (a step's span closes after ``_sample``'s copy of the
tokens to the host, a device sync), so turning the observer on changes no
token, no kernel launch and no host sync.  With the observer on the
engine arms it (``obs.activated``) around ``step`` and ``submit`` and
names their phases: spans on the observer's phase track (``engine::init``,
``engine::submit``, ``engine::wait``: the read of the sampled tokens) and,
while a ``torch.profiler`` records, profiler ranges of the same names and
of the step's phases (``engine::appendable``, ``engine::upload``,
``engine::forward``, ``engine::sample``, ``engine::emit``), the submit's
(``engine::admit``, ``engine::prefill``) and each block's mixer and FFN
(``model::attn``, ``model::ffn``).  Always on, ``stats["n_step_syncs"]``
counts a decode step's blocking host<->device transfers: the tokens'
upload, the paged tables' and lengths', the sampled tokens' read.

Under a device mesh (``mesh=``, a ``torch.distributed`` ``DeviceMesh``
with "data" and "model" axes, one process per rank, every rank running
the same requests) the engine places its params per
``distribution.sharding.param_pspecs`` and its cache per the adapter's
``pspecs`` (both after ``evenly``; the batch over the data axes, heads,
FFN, vocab and the dense cache's sequence over the model axis; the paged
pools' pages over the model axis, replicated over the data axes, their
tables and lengths over the data axes), with rules for a batch of
``n_slots``, and runs every step on the DTensors
(``distribution.placed``).  A merged model's q/k/v are re-anchored to the
head placement.  Each rank samples from the whole logits, so every rank
emits the same tokens.  Where the model axis has size 1 every rank holds
whole params and a whole pool, so the decode step and the whole-prompt
prefill run on local tensors (each rank's batch rows; a paged step
gathers its new K/V rows over the data axes before it writes them, so
the pool replicas stay equal), through the kernels on ``impl="cuda"``.
A larger model axis runs the step and the prefill on the DTensors on
either route, and the attention cores on each rank's local tensors
there (``models.attention``; the kernels on ``impl="cuda"``, their plain
versions or the plain cores on ``impl="torch"``): a prefill, a VLM's
cross decode and the SSD scan on the rank's heads, a decode step over
the rank's slice of the dense cache's sequence or the pages it holds,
whose partial softmax states are combined across the model axis.  No
step gathers a cache or a pool.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distribution import sharding as shd
from repro_torch.distribution.placed import (full, local_tree, on_mesh,
                                             row_gather, shard_box)
from repro_torch.models import (backends, forward_step, prefill_style_key,
                                serving_style_key)
from repro_torch.obs import NULL, MetricsRegistry, Observer, activated
from repro_torch.serving.adapters import KVCacheAdapter, make_adapter

_IMPL_DEVICE = {"cuda": "cuda", "torch": "cpu"}

#: the profiler range a span or range enters while a profiler records: the
#: C++ ``RecordFunction`` costs a tenth of ``torch.profiler.record_function``
_profiler_range = torch._C._profiler._RecordFunctionFast
_UNARMED = contextlib.nullcontext()


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 8
    max_len: int = 512
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0  # > 0 => sample among the k largest logits only
    eos_token: int = -1  # -1 => run to max_new_tokens
    seed: int = 0  # with the submission index, seeds each request's stream
    block_size: int = 16  # paged: tokens per physical page
    n_blocks: int = 0  # paged pool size; 0 => dense-equivalent memory
    bucket_prompts: bool = True  # pad prompts to power-of-two buckets
    # observability (repro_torch.obs): False => the shared NullObserver
    # (every hook a no-op); True => a fresh Observer (metrics + trace
    # ring); an Observer instance is adopted (its registry becomes
    # Engine.metrics)
    obs: Any = False


# eq=False: requests are identities, not values (the generated __eq__
# would compare prompt arrays)
@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    out_tokens: Optional[List[int]] = None
    slot: int = -1  # >=0 active; -1 idle/finished; -2 preempted
    remaining: int = 0
    rid: int = -1  # submission index (preemption takes the youngest)
    # a preempted request's advanced sampling state (Generator.get_state())
    key_state: Optional[torch.Tensor] = None
    # serving telemetry (host wall clock, seconds)
    t_arrival: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None


class RequestResult(list):
    """A finished request's generated token ids — it IS the token list —
    plus per-request stats: prompt_len, new_tokens, ttft_s (arrival to
    first token, queueing + prefill included) and decode_tok_s (steady
    decode rate after the first token; None for single-token requests)."""

    def __init__(self, tokens, *, prompt_len: int, ttft_s: float,
                 decode_tok_s: Optional[float]):
        super().__init__(tokens)
        self.prompt_len = prompt_len
        self.new_tokens = len(tokens)
        self.ttft_s = ttft_s
        self.decode_tok_s = decode_tok_s

    @property
    def stats(self) -> Dict[str, Any]:
        return {"prompt_len": self.prompt_len, "new_tokens": self.new_tokens,
                "ttft_s": self.ttft_s, "decode_tok_s": self.decode_tok_s}


def _axis_size(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return int(mesh.size(names.index(name))) if name in names else 1


def _timings_of(req: Request) -> Tuple[float, Optional[float]]:
    """(ttft_s, decode_tok_s); decode_tok_s is None — not 0.0 — when there
    is no decode phase to rate."""
    ttft = (req.t_first - req.t_arrival
            if req.t_first is not None and req.t_arrival is not None else 0.0)
    n = len(req.out_tokens)
    tok_s = None
    if n > 1 and req.t_last is not None and req.t_first is not None \
            and req.t_last > req.t_first:
        tok_s = (n - 1) / (req.t_last - req.t_first)
    return ttft, tok_s


def _result_of(req: Request) -> RequestResult:
    ttft, tok_s = _timings_of(req)
    return RequestResult(req.out_tokens, prompt_len=len(req.prompt),
                         ttft_s=ttft, decode_tok_s=tok_s)


class Engine:
    def __init__(self, cfg: ModelConfig, params, sc: ServeConfig,
                 impl: str = "cuda",
                 cache: Union[str, KVCacheAdapter] = "dense",
                 device="cuda", mesh=None):
        # the engine ALWAYS owns a MetricsRegistry: the always-on counters
        # below back Engine.stats; timestamps, histograms and spans are the
        # Observer's, off by default
        if isinstance(sc.obs, Observer):
            self.obs = sc.obs
            self.metrics = sc.obs.metrics
        elif sc.obs:
            self.obs = Observer()
            self.metrics = self.obs.metrics
        else:
            self.obs = NULL
            self.metrics = MetricsRegistry()
        with self.obs.span("engine::init"):
            self._init(cfg, params, sc, impl, cache, device, mesh)

    def _init(self, cfg, params, sc, impl, cache, device, mesh) -> None:
        if not cfg.causal:
            raise ValueError("serving requires a decoder")
        cfg.validate_style()  # merged styles need a square Q basis
        dev = torch.device(device)
        if impl in _IMPL_DEVICE and _IMPL_DEVICE[impl] != dev.type:
            raise ValueError(
                f"impl={impl!r} runs on {_IMPL_DEVICE[impl]!r} tensors, not "
                f"on device {str(dev)!r}: use impl='cuda' with a CUDA device "
                "or impl='torch' with device='cpu'")
        self.device = resolve_device(dev)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params lie on {table.device}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.sc, self.params, self.impl = cfg, sc, params, impl
        self.mesh, self.rules = mesh, None
        self.kv: KVCacheAdapter = (make_adapter(cache)
                                   if isinstance(cache, str) else cache)
        # resolve BOTH phases' backends now: an unknown (cache_kind, style,
        # impl) combo must fail at construction, not mid-serve
        self.backend = backends.get_backend(self.kv.kind,
                                            serving_style_key(cfg), impl)
        self.prefill_backend = backends.get_prefill_backend(
            self.kv.kind, prefill_style_key(cfg), impl)

        self.free_slots = list(range(sc.n_slots))
        self.active: Dict[int, Request] = {}
        self.preempted: List[Request] = []
        self._rid = 0
        self._g_peak = self.metrics.gauge(
            "serve_peak_active", "most slots concurrently decoding")
        self._c_steps = self.metrics.counter(
            "serve_decode_steps", "batched decode steps run")
        self._c_step_syncs = self.metrics.counter(
            "serve_step_syncs", "blocking host<->device transfers of the "
            "decode steps")
        self._c_preempted = self.metrics.counter(
            "serve_preempted", "requests evicted mid-decode")
        self._c_deferred = self.metrics.counter(
            "serve_deferred", "admissions deferred (pool exhausted)")
        # bucketing needs paddable positions: causal attention masks a
        # padded tail, but SSM prefill state is not position-masked, and a
        # dense sliding-window cache is a window-sized ring that would drop
        # real positions when a padded tail pushes them out (the paged
        # pool stores absolute positions).  Under MoE capacity dropping
        # the padded tail joins the prefill's routing group, so the
        # streams depend on ``bucket_prompts``, as in the reference
        self._bucketing = (sc.bucket_prompts and cfg.has_attention
                           and not cfg.ssm_state
                           and (self.paged or not cfg.sliding_window))
        self.kv.init(cfg, sc, self.device)
        self._qkv = self._local_params = None
        if mesh is not None:
            self._place_on(mesh)
        self.kv.build_prefill(impl, qkv_sharding=self._qkv)
        self._last_token = np.zeros((sc.n_slots,), np.int32)
        # temperature sampling: each slot's request's private generator
        self._gens: List[Optional[torch.Generator]] = [None] * sc.n_slots
        # lifts the adapter's pool telemetry in as LAZY gauges, and hands
        # over the profiler's range and its check (no-op off)
        self.obs.attach_engine(
            self, new_range=_profiler_range,
            recording=torch._C._autograd._profiler_enabled)

    def _place_on(self, mesh) -> None:
        """Params and cache onto ``mesh`` (the reference's ``device_put``
        with ``param_shardings`` and the cache shardings)."""
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh lies on {mesh.device_type!r}, the "
                             f"engine serves on {self.device.type!r}")
        self.rules = shd.make_rules(mesh, batch=self.sc.n_slots)
        self.params = shd.distribute_tree(
            self.params, shd.param_pspecs(self.params, self.rules), mesh)
        self.kv.place(mesh, self.rules)
        if self.merged_fast_path:
            # K*/V*-only layout: no wq matmul anchors the head placement
            self._qkv = shd.qkv_pspec(self.rules)
        if _axis_size(mesh, "model") == 1:
            # every rank holds whole params and whole cache rows: the decode
            # step runs on local tensors (see ``_decode``)
            self._local_params = local_tree(self.params)

    @property
    def stats(self) -> Dict[str, int]:
        """Scheduler counters, read through ``self.metrics``: peak
        concurrent slots, decode steps run, requests preempted mid-decode,
        admissions deferred and the decode steps' blocking host<->device
        transfers."""
        return {"peak_active": int(self._g_peak.high_water),
                "n_steps": int(self._c_steps.value),
                "n_preempted": int(self._c_preempted.value),
                "n_deferred": int(self._c_deferred.value),
                "n_step_syncs": int(self._c_step_syncs.value)}

    @property
    def paged(self) -> bool:
        """True for a block-pool cache: absolute positions, admission
        control and preemption."""
        return self.kv.kind != "dense"

    @property
    def pm(self):
        """The paged adapter's host-side ``PagedCacheManager``."""
        return self.kv.pm

    def host_mutable_buffers(self) -> Dict[str, np.ndarray]:
        """Named host-side numpy buffers this engine (and its adapter)
        mutates across steps: ``repro_torch.lint.aliasing`` checks every
        device program's CPU tensor inputs for shared memory with
        these."""
        named = {"engine._last_token": self._last_token}
        named.update(self.kv.host_mutable_buffers())
        return named

    def host_to_device(self, x, dtype=None) -> torch.Tensor:
        """The ONE host->device ingestion seam: always copies, so a caller
        that reuses its buffer (a prompt) or engine-mutated host state
        never aliases memory an in-flight step still reads.  From
        pageable memory the copy to a card blocks the host."""
        return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(
            self.device)

    def device_to_host(self, x: torch.Tensor) -> np.ndarray:
        """The ONE device->host read seam: waits for the device (the
        observer's span ``engine::wait``)."""
        with self.obs.span("engine::wait"):
            return x.cpu().numpy()

    def _step_upload(self, x, dtype=None) -> torch.Tensor:
        """``host_to_device`` for a decode step, counted in
        ``stats["n_step_syncs"]``."""
        self._c_step_syncs.inc()
        return self.host_to_device(x, dtype)

    def _armed(self):
        """The observer armed for model code (``get_active``) while obs is
        on; nothing to arm while it is off."""
        return activated(self.obs) if self.obs.enabled else _UNARMED

    @property
    def merged_fast_path(self) -> bool:
        """True when decode routes through the merged (Q/P-removed) fast
        path: per-token attention reads only K*/V* weights."""
        return self.backend.fast_path

    @property
    def merged_prefill_fast_path(self) -> bool:
        """True when prefill routes through the merged (Q/P-removed)
        stream-as-query path in every layer."""
        return self.prefill_backend.fast_path

    def _bucket_pad(self, toks: np.ndarray) -> Tuple[np.ndarray, int]:
        """Right-pad to the next power-of-two bucket (>= 8), then up to a
        multiple of the adapter's ``bucket_align`` (unbucketed prompts
        too); the true length rides along so logits and cache are
        exact."""
        n = b = len(toks)
        if self._bucketing and n < self.sc.max_len:
            b = 8
            while b < n:
                b *= 2
            b = min(b, self.sc.max_len)
        align = self.kv.bucket_align
        b = -(-b // align) * align
        if b == n:
            return toks, n
        return np.concatenate([toks, np.zeros((b - n,), np.int32)]), n

    def _check_vision(self, vision) -> None:
        """A VLM request needs its (n_vision_tokens, d_model) vision
        tokens; any other config takes none."""
        cfg = self.cfg
        if cfg.family != "vlm":
            if vision is not None:
                raise ValueError(f"{cfg.name} has no cross-attention: vision "
                                 "tokens are for a VLM")
            return
        want = (cfg.n_vision_tokens, cfg.d_model)
        if vision is None or tuple(np.shape(vision)) != want:
            raise ValueError(f"a {cfg.name} request needs vision tokens of "
                             f"shape {want}, got "
                             f"{None if vision is None else np.shape(vision)}")

    def submit(self, req: Request, vision=None) -> bool:
        """Prefill a request into a free slot.  Returns False when no slot
        is free or the adapter defers it (paged: pool exhausted); the
        caller retries after other requests finish.  ``vision``: a VLM
        request's (n_vision_tokens, d_model) patch embeddings, a host
        array, required by a VLM and refused otherwise.

        A request with ``out_tokens`` already set is a RESUME (preempted
        earlier): its prompt and generated tokens but the last re-prefill,
        and decoding continues from its last token."""
        with on_mesh(self.mesh), self._armed(), \
                self.obs.span("engine::submit"):
            return self._submit(req, vision)

    def _submit(self, req: Request, vision) -> bool:
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        self._check_vision(vision)
        if not self.free_slots:
            return False
        # fail FAST on a request that cannot finish: decode past max_len
        # would walk off a paged table or wrap a window-free dense cache
        # over live positions (a dense sliding-window ring legitimately
        # outlives max_len)
        if (self.paged or not self.cfg.sliding_window) and \
                len(req.prompt) + req.max_new_tokens > self.sc.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len ({self.sc.max_len})")
        resume = bool(req.out_tokens)
        toks = np.asarray(req.prompt, np.int32)
        if resume and len(req.out_tokens) > 1:
            toks = np.concatenate(
                [toks, np.asarray(req.out_tokens[:-1], np.int32)])
        slot = self.free_slots[0]
        with self.obs.range("engine::admit"):
            n_shared = self.kv.admit(slot, toks)
        if n_shared is None:
            self._c_deferred.inc()
            return False
        self.free_slots.pop(0)
        t_p0 = self.obs.clock()  # slot granted: the queued span ends here
        padded, n = self._bucket_pad(toks)
        vs = None if vision is None else self.host_to_device(
            vision, np.float32)[None]
        with self.obs.range("engine::prefill"):
            logits = self.kv.prefill(
                self._prefill_params, slot,
                self.host_to_device(padded, np.int32)[None], n, n_shared, vs)
        if req.rid < 0:
            req.rid = self._rid
            self._rid += 1
        self._seed_stream(slot, req)
        req.slot = slot
        if resume:
            tok = req.out_tokens[-1]
        else:
            tok = int(self._sample(logits, [slot])[0])
            req.out_tokens = [tok]
            req.remaining = req.max_new_tokens - 1
            req.t_first = req.t_last = time.perf_counter()
        self.active[slot] = req
        self._last_token[slot] = tok
        self._g_peak.set_max(len(self.active))
        self.obs.request_admitted(req, slot, n_shared=n_shared,
                                  resume=resume, bucket_len=len(padded),
                                  t_prefill0=t_p0)
        if not resume and (req.remaining <= 0 or tok == self.sc.eos_token):
            # the prefill token already satisfied the budget (or is EOS):
            # finish now — a decode step would overshoot by one
            self._finish(slot)
        return True

    def _finish(self, slot: int) -> None:
        """Release a finished request's slot; its terminal hook, exactly
        once per request."""
        self.kv.release(slot)
        req = self.active.pop(slot)
        req.slot = -1
        self.free_slots.append(slot)
        self._finished(req)

    def _finished(self, req: Request) -> None:
        if self.obs.enabled:
            ttft, tok_s = _timings_of(req)
            self.obs.request_finished(req, decode_tok_s=tok_s, ttft_s=ttft)

    def step(self) -> Dict[int, int]:
        """One batched decode step for all active slots; returns
        slot -> token."""
        with on_mesh(self.mesh), self._armed():
            return self._step()

    def _step(self) -> Dict[int, int]:
        if not self.active:
            return {}
        obs = self.obs
        t0 = obs.clock()  # the step span includes appendability
        with obs.range("engine::appendable"):
            self._make_appendable()
        with obs.range("engine::upload"):
            tokens = self._step_upload(self._last_token, np.int32)
            cache = self.kv.device_cache(self._step_upload)
        with obs.range("engine::forward"):
            logits, new_cache = self._decode(tokens, cache)
            self.kv.update(new_cache)
        with obs.range("engine::sample"):
            self._c_steps.inc()
            slots = sorted(self.active)
            next_tokens = dict(zip(slots, self._sample(logits, slots,
                                                       rows=slots)))
            self._c_step_syncs.inc()  # _sample's one device_to_host
        with obs.range("engine::emit"):
            now = time.perf_counter()
            emitted: Dict[int, int] = {}
            for slot, req in list(self.active.items()):
                tok = int(next_tokens[slot])
                req.out_tokens.append(tok)
                req.remaining -= 1
                req.t_last = now
                self._last_token[slot] = tok
                emitted[slot] = tok
                self.kv.advance(slot)
                if req.remaining <= 0 or tok == self.sc.eos_token:
                    self._finish(slot)
            # after _sample's host copy: the span closes on a device sync
            obs.step_done(t0, obs.clock(), n_active=len(self.active),
                          n_tokens=len(emitted))
        return emitted

    @property
    def _prefill_params(self):
        """The params a whole-prompt prefill (and a paged chunk) runs on:
        where the mesh's model axis has size 1, each rank's local (whole)
        params, so the batch-1 prompt, the same on every rank, runs on
        plain tensors and only its insert into the placed cache lands per
        owning rank (``kv_cache.insert_request``; the paged pools: every
        rank's whole local pool)."""
        return self.params if self._local_params is None \
            else self._local_params

    def _decode(self, tokens: torch.Tensor, cache):
        """One decode step over the (n_slots,) last tokens, uploaded:
        ``forward_step`` on plain tensors without a mesh, on the DTensors
        under one (the tokens split over the data axes), or, where the
        mesh's model axis has size 1, on each rank's local tensors: its
        batch rows of the tokens and the cache against whole params, what
        every op of the step would compute on the DTensors without a
        collective, minus DTensor's dispatch on the host.  A paged step
        there writes the whole batch's new rows into every rank's pool
        (``row_gather`` over the data axes).  The cache is written in place
        either way; the new lengths and the logits are placed back with
        the cache's batch placement."""
        if self.mesh is None:
            return forward_step(self.params, self.cfg, tokens, cache,
                                impl=self.impl)
        if self._local_params is None:
            tokens = shd.place_host(tokens, shd.P(self.rules.dp), self.mesh)
            return forward_step(self.params, self.cfg, tokens, cache,
                                impl=self.impl, qkv_sharding=self._qkv)
        from torch.distributed.tensor import DTensor

        lo, n = shard_box(cache.length)[0]
        rows = row_gather(cache.length) if self.paged else None
        logits, new = forward_step(self._local_params, self.cfg,
                                   tokens[lo:lo + n], local_tree(cache),
                                   impl=self.impl, rows=rows)
        mesh, batch = cache.length.device_mesh, cache.length.placements
        return (DTensor.from_local(logits, mesh, batch, run_check=False),
                cache._replace(length=DTensor.from_local(
                    new.length, mesh, batch, run_check=False)))

    def _make_appendable(self) -> None:
        """Guarantee every active slot can write its next token (paged:
        map, copy-on-write or recycle the page it falls in), preempting
        the youngest request while the adapter is out of room.  The dense
        cache always has room."""
        while True:
            blocked = [s for s in sorted(self.active)
                       if not self.kv.ensure_appendable(s)]
            if not blocked:
                return
            if len(self.active) == 1:
                raise RuntimeError("paged pool too small for a single "
                                   "request; raise ServeConfig.n_blocks")
            self._preempt(max(self.active, key=lambda s: self.active[s].rid))

    def _preempt(self, slot: int) -> None:
        req = self.active.pop(slot)
        self.kv.release(slot)
        self.free_slots.append(slot)
        req.slot = -2
        if self._gens[slot] is not None:
            # resume the stream where it stopped: replayed draws would make
            # the continuation depend on whether preemption happened
            req.key_state = self._gens[slot].get_state()
        self.preempted.append(req)
        self._c_preempted.inc()
        self.obs.request_preempted(req, slot)

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32,
                 vision: Optional[Sequence[Any]] = None
                 ) -> List[RequestResult]:
        """Keep the slots full until every prompt is done (resumes of
        preempted requests first); one :class:`RequestResult` per prompt,
        in order.  ``vision``: a VLM's patch embeddings, one array per
        prompt."""
        t_gen0 = self.obs.clock()
        t_arrival = time.perf_counter()
        pending = [Request(prompt=np.asarray(p, np.int32),
                           max_new_tokens=max_new_tokens,
                           t_arrival=t_arrival) for p in prompts]
        vis = {id(r): v for r, v in zip(
            pending, [None] * len(pending) if vision is None else vision)}
        queue = list(pending)
        while queue or self.active or self.preempted:
            self.obs.queue_depth(len(queue) + len(self.preempted))
            while self.free_slots:
                waiting = self.preempted or queue
                if not waiting or not self.submit(
                        waiting[0], vision=vis[id(waiting[0])]):
                    break
                waiting.pop(0)
            if not self.active:
                if queue or self.preempted:
                    raise RuntimeError("serving stalled: the cache cannot "
                                       "admit any pending request (raise "
                                       "n_blocks or max_len)")
                break
            self.step()
        results = [_result_of(r) for r in pending]
        self._generate_done(t_gen0, results)
        return results

    def _generate_done(self, t0: float, results) -> None:
        if self.obs.enabled:
            self.obs.generate_done(t0, self.obs.clock(),
                                   n_requests=len(results),
                                   n_tokens=sum(r.new_tokens
                                                for r in results))

    def _seed_stream(self, slot: int, req: Request) -> None:
        """Give ``slot`` its request's private generator: a fresh one
        seeded from (engine seed, submission index), or, for a preempted
        request, its saved state.  Greedy serving draws nothing and keeps
        none."""
        if self.sc.temperature <= 0:
            return
        g = torch.Generator(device=self.device)
        if req.key_state is not None:
            g.set_state(req.key_state)
        else:
            g.manual_seed(int(np.random.SeedSequence(
                [self.sc.seed, req.rid]).generate_state(1, np.uint64)[0]))
        self._gens[slot] = g

    def _sample(self, logits: torch.Tensor, slots,
                rows: Optional[Sequence[int]] = None) -> np.ndarray:
        """One token for each of ``slots`` over the real vocabulary (padded
        ids are never drawn), from row ``rows[i]`` of ``logits`` (default:
        row i).  Greedy is the argmax.  With a temperature the logits are
        scaled by 1/T and cut to the top k, and each row draws from ITS
        slot's generator (Gumbel-max on uniforms drawn on the device): a
        slot's generator advances only when its row samples.  The host
        copy (``device_to_host``) synchronises with the device.  Under a
        mesh the logits are gathered whole first: every rank draws the
        same tokens."""
        logits = full(logits)[:, :self.cfg.vocab_size]
        if self.sc.temperature <= 0:
            toks = self.device_to_host(logits.argmax(dim=-1))
            return toks if rows is None else toks[list(rows)]
        if rows is not None and len(rows) < logits.shape[0]:
            logits = logits[torch.as_tensor(rows, device=logits.device)]
        scaled = logits.float() / self.sc.temperature
        k = min(self.sc.top_k, scaled.shape[-1])
        if k > 0:
            kth = torch.topk(scaled, k, dim=-1).values[:, -1:]
            scaled = scaled.masked_fill(scaled < kth, float("-inf"))
        u = torch.empty_like(scaled)
        for i, slot in enumerate(slots):
            u[i].uniform_(generator=self._gens[slot])
        gumbel = -torch.log(-torch.log(
            u.clamp_(min=torch.finfo(torch.float32).tiny)))
        return self.device_to_host((scaled + gumbel).argmax(dim=-1))
