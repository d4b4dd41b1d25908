"""Serving engine: prefill + batched greedy decode over a fixed set of slots.

Counterpart of ``repro.serving.engine`` for the dense cache.  The engine
drives exactly two seams:

  * a ``KVCacheAdapter`` (``serving.adapters``) owning the cache: device
    state, admission and the prefill-insert path;
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

Prompt lengths are bucketed (padded to the next power of two, exact logits
and cache via ``true_len``) except for sliding-window configs, whose dense
ring cache would drop real positions under a padded tail: those prompts
reach prefill at their own length.  Sampling is greedy; temperature
sampling, paged caches, preemption and observer hooks are later slices
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import (backends, forward_step, prefill_style_key,
                                serving_style_key)
from repro_torch.serving.adapters import KVCacheAdapter, make_adapter

_IMPL_DEVICE = {"cuda": "cuda", "torch": "cpu"}


@dataclasses.dataclass
class ServeConfig:
    n_slots: int = 8
    max_len: int = 512
    temperature: float = 0.0  # 0 => greedy (the only mode ported yet)
    eos_token: int = -1  # -1 => run to max_new_tokens


# eq=False: requests are identities, not values (the generated __eq__
# would compare prompt arrays)
@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 32
    out_tokens: Optional[List[int]] = None
    slot: int = -1  # >=0 active; -1 idle/finished
    remaining: int = 0
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
                 device="cuda"):
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
        if sc.temperature > 0:
            raise NotImplementedError(
                "temperature sampling is not ported yet (ROADMAP.md, "
                "'Temperature sampling'); serve with temperature=0")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params lie on {table.device}, the engine "
                             f"serves on {self.device}")
        self.cfg, self.sc, self.params, self.impl = cfg, sc, params, impl
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
        self._peak_active = 0
        self._n_steps = 0
        # bucketing needs paddable positions: a dense sliding-window cache
        # is a window-sized ring that would drop real positions when a
        # padded tail pushes them out
        self._bucketing = not cfg.sliding_window
        self.kv.init(cfg, sc, self.device)
        self.kv.build_prefill(impl)
        self._last_token = np.zeros((sc.n_slots,), np.int32)

    @property
    def stats(self) -> Dict[str, int]:
        """Scheduler counters: peak concurrent slots and decode steps run."""
        return {"peak_active": self._peak_active, "n_steps": self._n_steps}

    def host_to_device(self, x, dtype=None) -> torch.Tensor:
        """The ONE host->device ingestion seam: always copies, so a caller
        that reuses its buffer (a prompt) or engine-mutated host state
        never aliases memory an in-flight step still reads."""
        return torch.from_numpy(np.array(x, dtype=dtype, copy=True)).to(
            self.device)

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
        """Right-pad to the next power-of-two bucket (>= 8); the true
        length rides along so logits and cache are exact."""
        n = b = len(toks)
        if self._bucketing and n < self.sc.max_len:
            b = 8
            while b < n:
                b *= 2
            b = min(b, self.sc.max_len)
        if b == n:
            return toks, n
        return np.concatenate([toks, np.zeros((b - n,), np.int32)]), n

    def submit(self, req: Request) -> bool:
        """Prefill a request into a free slot.  Returns False when no slot
        is free or the adapter defers it."""
        if req.t_arrival is None:
            req.t_arrival = time.perf_counter()
        if not self.free_slots:
            return False
        # fail FAST on a request that cannot finish: decode past max_len
        # would wrap a window-free cache over live positions (a dense
        # sliding-window ring legitimately outlives max_len)
        if not self.cfg.sliding_window and \
                len(req.prompt) + req.max_new_tokens > self.sc.max_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds max_len ({self.sc.max_len})")
        toks = np.asarray(req.prompt, np.int32)
        slot = self.free_slots[0]
        if not self.kv.admit(slot, toks):
            return False
        self.free_slots.pop(0)
        padded, n = self._bucket_pad(toks)
        logits = self.kv.prefill(self.params, slot,
                                 self.host_to_device(padded, np.int32)[None],
                                 n)
        req.slot = slot
        tok = int(self._sample(logits)[0])
        req.out_tokens = [tok]
        req.remaining = req.max_new_tokens - 1
        req.t_first = req.t_last = time.perf_counter()
        self.active[slot] = req
        self._last_token[slot] = tok
        self._peak_active = max(self._peak_active, len(self.active))
        if req.remaining <= 0 or tok == self.sc.eos_token:
            # the prefill token already satisfied the budget (or is EOS):
            # finish now — a decode step would overshoot by one
            self._finish(slot)
        return True

    def _finish(self, slot: int) -> None:
        self.kv.release(slot)
        self.active.pop(slot).slot = -1
        self.free_slots.append(slot)

    def step(self) -> Dict[int, int]:
        """One batched decode step for all active slots; returns
        slot -> token."""
        if not self.active:
            return {}
        tokens = self.host_to_device(self._last_token, np.int32)
        logits, new_cache = forward_step(self.params, self.cfg, tokens,
                                         self.kv.device_cache(),
                                         impl=self.impl)
        self.kv.update(new_cache)
        self._n_steps += 1
        next_tokens = self._sample(logits)
        now = time.perf_counter()
        emitted: Dict[int, int] = {}
        for slot, req in list(self.active.items()):
            tok = int(next_tokens[slot])
            req.out_tokens.append(tok)
            req.remaining -= 1
            req.t_last = now
            self._last_token[slot] = tok
            emitted[slot] = tok
            if req.remaining <= 0 or tok == self.sc.eos_token:
                self._finish(slot)
        return emitted

    def generate(self, prompts: Sequence[np.ndarray],
                 max_new_tokens: int = 32) -> List[RequestResult]:
        """Keep the slots full until every prompt is done; one
        :class:`RequestResult` per prompt, in order."""
        t_arrival = time.perf_counter()
        pending = [Request(prompt=np.asarray(p, np.int32),
                           max_new_tokens=max_new_tokens,
                           t_arrival=t_arrival) for p in prompts]
        queue = list(pending)
        while queue or self.active:
            while self.free_slots and queue:
                if not self.submit(queue[0]):
                    break
                queue.pop(0)
            if not self.active:
                if queue:
                    raise RuntimeError("serving stalled: the cache cannot "
                                       "admit any pending request")
                break
            self.step()
        return [_result_of(r) for r in pending]

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy: argmax over the real vocabulary (padded ids excluded);
        the host copy synchronises with the device."""
        return logits[:, :self.cfg.vocab_size].argmax(dim=-1).cpu().numpy()
