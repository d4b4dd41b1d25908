"""NoSyncPrefillInSubmit: the admission-stall class as a check.

Counterpart of ``repro.lint.submitpath``.  The synchronous
``Engine.submit`` runs a whole-prompt, batch-of-1 prefill at admission:
every arrival freezes all in-flight decode streams for a whole prefill
(the stall ``repro_torch.serving.sched`` exists to remove).  This audit
keeps the class out of the scheduled engine:

``audit_submit_path()`` builds reduced-shape ``ScheduledEngine``s (dense
and paged), wraps every device-dispatching callable the engine owns (the
adapter's prefill and chunk programs, the decode step) with a
call-counting spy, drives ``submit`` for fresh prompts, and asserts ZERO
dispatches — the scheduled submit path must only enqueue.  A POSITIVE
CONTROL then runs the same spy over the synchronous ``Engine.submit``,
which MUST fire the prefill program: if it does not, the spy is not
observing the seam and the audit fails itself rather than passing
vacuously.

Each hit is a :class:`repro_torch.lint.rules.Finding` (rule
``NoSyncPrefillInSubmit``), the same currency as the graph rules, so
``python -m repro_torch.lint --submit`` reports it in the one run.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np

from repro_torch.lint.rules import Finding

RULE_SUBMIT = "NoSyncPrefillInSubmit"

# every adapter attribute that, when called, dispatches a device program
_DISPATCH_ATTRS = ("_prefill", "_chunk")

#: the reduced model the audits serve: the reference's (reduced
#: Llama-3.2-1B) at a head dim the kernels take, so that the same audit
#: runs on the card through them
AUDIT_D_HEAD = 64


@contextlib.contextmanager
def _counting_spies(engine, counts: Dict[str, int]):
    """Wrap the engine's device-dispatching callables with counters.
    ``counts`` maps seam name -> calls observed while armed."""
    holders = []  # (obj, attr, original)

    def arm(obj, attr, name):
        if not hasattr(obj, attr):
            return
        orig = getattr(obj, attr)
        counts.setdefault(name, 0)

        def wrapped(*args, __name=name, __orig=orig, **kwargs):
            counts[__name] += 1
            return __orig(*args, **kwargs)

        holders.append((obj, attr, orig))
        setattr(obj, attr, wrapped)

    for attr in _DISPATCH_ATTRS:
        arm(engine.kv, attr, f"kv.{attr}")
    arm(engine, "_decode", "engine._decode")
    try:
        yield
    finally:
        for obj, attr, orig in reversed(holders):
            setattr(obj, attr, orig)


def _prompts(engine, n: int = 3) -> List[np.ndarray]:
    vocab = engine.cfg.vocab_size
    return [(np.arange(8, dtype=np.int32) * (i + 3)) % vocab
            for i in range(n)]


def audit_submit(engine, context: str) -> List[Finding]:
    """Drive ``engine.submit`` with the spies armed; any device dispatch
    on the submit path is a finding.  The engine is expected to be a
    ScheduledEngine (or anything whose submit only enqueues)."""
    from repro_torch.serving.engine import Request

    counts: Dict[str, int] = {}
    with _counting_spies(engine, counts):
        for p in _prompts(engine):
            engine.submit(Request(prompt=p, max_new_tokens=4))
    findings = []
    for name, n in sorted(counts.items()):
        if n:
            findings.append(Finding(
                rule=RULE_SUBMIT, target=context,
                message=f"submit dispatched {name} {n}x — admission must "
                        f"only enqueue; a synchronous prefill at submit "
                        f"freezes every in-flight decode stream for a "
                        f"whole-prompt program (the stall class "
                        f"repro_torch.serving.sched removes)",
                detail={"seam": name, "calls": n}))
    return findings


def positive_control(engine, context: str) -> List[Finding]:
    """The synchronous ``Engine.submit`` MUST fire its prefill program
    under the same spies — otherwise the audit observes nothing and a
    clean report would be vacuous."""
    from repro_torch.serving.engine import Request

    counts: Dict[str, int] = {}
    with _counting_spies(engine, counts):
        engine.submit(Request(prompt=_prompts(engine, 1)[0],
                              max_new_tokens=4))
    if not counts.get("kv._prefill"):
        return [Finding(
            rule=RULE_SUBMIT, target=context,
            message="positive control FAILED: the synchronous engine's "
                    "submit fired no prefill through the spied seam — the "
                    "audit is not observing dispatches and cannot certify "
                    "the scheduled path",
            detail={"counts": dict(counts)})]
    return []


def audit_config():
    """The config the audits serve by default: reduced Llama-3.2-1B (the
    reference's) at head dim ``AUDIT_D_HEAD``."""
    from repro_torch.configs import get_config, reduce_config

    return reduce_config(get_config("llama3.2-1b")).with_(
        d_head=AUDIT_D_HEAD)


def audit_model(device="cpu"):
    """(``audit_config()``, its params from seed 0 on ``device``)."""
    from repro_torch.models import init_params

    cfg = audit_config()
    return cfg, init_params(cfg, seed=0, device=device)


def audit_submit_path(cfg=None, params=None, *, device="cpu"
                      ) -> List[Finding]:
    """Build reduced dense + paged ScheduledEngines and one synchronous
    Engine on ``device`` (the kernels on the card, the plain route on the
    CPU); returns every confirmed finding (empty == clean)."""
    from repro_torch._device import resolve_device
    from repro_torch.serving import Engine, ServeConfig
    from repro_torch.serving.sched import SchedConfig, ScheduledEngine

    dev = resolve_device(device)
    if cfg is None:
        cfg, params = audit_model(dev)
    kw = dict(impl="cuda" if dev.type == "cuda" else "torch", device=dev)
    findings: List[Finding] = []
    scfg = SchedConfig(token_budget=32, chunk_tokens=16)
    for kind in ("dense", "paged"):
        eng = ScheduledEngine(cfg, params,
                              ServeConfig(n_slots=2, max_len=48),
                              scfg=scfg, cache=kind, **kw)
        findings += audit_submit(eng, f"ScheduledEngine[{kind}].submit")
    sync = Engine(cfg, params, ServeConfig(n_slots=2, max_len=48),
                  cache="dense", **kw)
    findings += positive_control(sync, "Engine[dense].submit")
    return findings
