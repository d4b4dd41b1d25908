"""Host-aliasing race detector: the zero-copy bug class as a check.

Counterpart of ``repro.lint.aliasing``.  ``torch.from_numpy`` always
shares memory with its array, and a CPU tensor made from a numpy buffer
the serving stack keeps mutating (block tables, lengths, the last-token
row) is read by the step AFTER the host may have moved on to the next
step's state — on the card too, where a non-blocking copy reads its
pinned source late.  The reference shipped exactly that race (a step
decoding against the *next* step's block table); its fix was a copy.
This module keeps the class out:

``audit_engine(engine)`` drives a real serve loop and applies three
deterministic sub-checks — no timing, no sleeps:

  1. **program-boundary spy** — wraps the engine's device programs (the
     adapter's prefill program and the decode step's ``forward_step``:
     the port's ``Engine._decode`` ingests its numpy tokens itself, so the
     seam the reference spies at ``_decode`` is the call inside it) and,
     at every call, tests each CPU tensor argument for shared memory with
     every buffer the serving stack declares host-mutable
     (``host_mutable_buffers()`` on ``Engine``, its adapters and
     ``PagedCacheManager``) and with the caller-owned prompt buffers;
  2. **ingestion seam** — the engine funnels every host->device transfer
     through ``Engine.host_to_device``; the audit verifies that seam
     copies (an alias there races the caller's own buffer against the
     prefill that reads it);
  3. **host-held device views** — after exercising preemption, the
     generator state the engine handed back to each request
     (``Request.key_state``) must own its storage, not view another
     buffer.

Each hit is a :class:`repro_torch.lint.rules.Finding`, the same currency
as the graph rules, so ``python -m repro_torch.lint`` reports both.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.lint.rules import Finding

RULE_JIT_INPUT = "NoAliasedJitInput"
RULE_INGEST = "HostToDeviceCopies"
RULE_HOST_VIEW = "NoHostViewOfDeviceBuffer"


def _np_view(x) -> Optional[np.ndarray]:
    """A numpy view of a CPU tensor's memory WITHOUT copying (bfloat16 as
    int16, same bytes), or None for anything that cannot alias host
    memory (a tensor on the card, a non-tensor)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cpu":
        return None
    t = x.detach()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    try:
        return t.numpy()
    except (TypeError, RuntimeError):  # a dtype numpy lacks
        return None


def check_shared(args: Any, named_buffers: Dict[str, np.ndarray],
                 context: str) -> List[Finding]:
    """Flag every CPU tensor leaf of ``args`` sharing memory with any
    named host-mutable buffer."""
    findings: List[Finding] = []
    for path, leaf in pytree.tree_flatten_with_path(args)[0]:
        view = _np_view(leaf)
        if view is None or view.size == 0:
            continue
        for name, buf in named_buffers.items():
            if not isinstance(buf, np.ndarray):
                continue
            if np.shares_memory(view, buf):
                where = pytree.keystr(path)
                findings.append(Finding(
                    rule=RULE_JIT_INPUT, target=context,
                    message=f"program input arg{where} shares memory with "
                            f"host-mutable buffer {name!r} — the step can "
                            f"read state the host has already advanced",
                    detail={"arg": where, "buffer": name}))
    return findings


def check_ingestion(host_to_device: Callable, context: str) -> List[Finding]:
    """Verify the host->device seam copies: its output must not share
    memory with its input.  ``torch.from_numpy`` always shares, so a
    non-copying seam aliases the probe deterministically (no alignment
    needed, unlike JAX's CPU import)."""
    probe = np.arange(64, dtype=np.int32)
    out = _np_view(host_to_device(probe, np.int32))
    if out is not None and np.shares_memory(out, probe):
        return [Finding(
            rule=RULE_INGEST, target=context,
            message="host_to_device zero-copies its input: the prefill/step "
                    "reads the CALLER's buffer after submit returns — "
                    "callers reusing their prompt buffer corrupt an "
                    "in-flight program")]
    return []


def _owns(t: torch.Tensor) -> bool:
    return (t._base is None and t.storage_offset() == 0
            and t.untyped_storage().nbytes() == t.numel() * t.element_size())


def check_host_views(named: Dict[str, Any], context: str) -> List[Finding]:
    """Flag host-side state that does not own its memory: a numpy array
    that is read-only or a view of another buffer, or a tensor (a
    generator state) that views another tensor's storage."""
    findings: List[Finding] = []
    for name, arr in named.items():
        if isinstance(arr, np.ndarray):
            if arr.base is None and arr.flags.writeable:
                continue
            why = ("read-only" if not arr.flags.writeable else
                   f"view of {type(arr.base).__name__}")
        elif isinstance(arr, torch.Tensor):
            if _owns(arr):
                continue
            why = "view of another tensor's storage"
        else:
            continue
        findings.append(Finding(
            rule=RULE_HOST_VIEW, target=context,
            message=f"{name} is a {why} — host state holding a view of "
                    f"(and pinning) another buffer instead of owning a "
                    f"copy",
            detail={"buffer": name, "why": why}))
    return findings


@contextlib.contextmanager
def _spy(obj, attr: str, buffers_fn: Callable[[], Dict[str, np.ndarray]],
         findings: List[Finding], context: str):
    """Temporarily wrap callable ``obj.attr`` with a shared-memory check
    on every call's arguments."""
    orig = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        findings.extend(check_shared((args, kwargs), buffers_fn(), context))
        return orig(*args, **kwargs)

    setattr(obj, attr, wrapped)
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _default_prompts(engine, n: int = 3) -> List[np.ndarray]:
    # bucket-exact int32 prompts: the shape and dtype for which numpy
    # padding is a no-op, so a non-copying seam hands the caller's own
    # buffer to the prefill
    vocab = engine.cfg.vocab_size
    return [(np.arange(8, dtype=np.int32) * (i + 3)) % vocab
            for i in range(n)]


def audit_engine(engine, prompts: Optional[Sequence[np.ndarray]] = None,
                 max_new_tokens: int = 4,
                 exercise_preempt: bool = True) -> List[Finding]:
    """Serve a few requests through ``engine`` with the aliasing spies
    armed; returns every confirmed finding (empty == clean).

    Drives the REAL path — ``submit`` then ``step`` to completion, plus a
    forced preemption — so the buffers checked are the buffers production
    passes, not synthetic ones."""
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.engine import Request

    findings: List[Finding] = []
    if prompts is None:
        prompts = _default_prompts(engine)
    prompt_bufs = {f"prompt[{i}]": np.asarray(p)
                   for i, p in enumerate(prompts)}

    def buffers() -> Dict[str, np.ndarray]:
        named = dict(engine.host_mutable_buffers())
        named.update(prompt_bufs)
        return named

    findings.extend(check_ingestion(engine.host_to_device,
                                    "engine.host_to_device"))

    reqs = [Request(prompt=p, max_new_tokens=max_new_tokens)
            for p in prompts]
    with _spy(engine_mod, "forward_step", buffers, findings,
              "engine._decode"), \
         _spy(engine.kv, "_prefill", buffers, findings,
              "engine.kv._prefill"):
        pending = [r for r in reqs if not engine.submit(r)]
        for _ in range(max_new_tokens + 2):
            if not engine.active:
                break
            engine.step()
            pending = [r for r in pending if not engine.submit(r)]
        if exercise_preempt and engine.active:
            slot = next(iter(engine.active))
            engine._preempt(slot)
        # drain: preempted requests re-prefill through the spied path too
        while engine.active or engine.preempted:
            for r in list(engine.preempted):
                if engine.submit(r):
                    engine.preempted.remove(r)
            if engine.active:
                engine.step()

    key_states = {f"request[{r.rid}].key_state": r.key_state
                  for r in reqs if r.key_state is not None}
    findings.extend(check_host_views(key_states, "engine._preempt"))
    return findings
