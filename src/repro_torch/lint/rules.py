"""Lint rule framework: targets, findings, and the rule registry.

Counterpart of ``repro.lint.rules`` (a copy: the port imports nothing of
the JAX package).  Rules register under a name (latest wins, so a
downstream repo can swap a tuned rule in without forking), lookups of
unknown rules fail loudly with the registered list, and the sweep
(``repro_torch.lint.sweep``) runs every registered rule against every
registered backend combo: a new rule or a new backend is linted with no
new test code.

A rule checks ONE invariant of a :class:`LintTarget` — a traced serving
program plus what is needed to judge it (its registry key, the cache it
serves, the unmerged source program for merged targets, the cache leaves
the serving adapter hands over to be written in place).
``applies(target)`` scopes the rule (e.g. ``NoOversizedBuffer`` only
judges paged prefill); ``check(target)`` returns :class:`Finding`s, empty
when clean.

Registering a custom rule::

    from repro_torch.lint import LintRule, register_rule, walker

    class NoGiantBuffer(LintRule):
        name = "NoGiantBuffer"
        description = "no value over 1 MiB in a serving program"

        def applies(self, t):
            return True

        def check(self, t):
            big = [v for v in walker.iter_values(t.graph)
                   if v.numel() * v.element_size() > 1 << 20]
            return [self.finding(t, f"{len(big)} oversized values")] \\
                if big else []

    register_rule(NoGiantBuffer())
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: which rule, on which program, what went wrong.

    ``severity`` is "error" (the CLI exits non-zero) or "warning"
    (reported, not gating).  ``detail`` carries structured context for the
    JSON report (offending shapes, counts, op names, …)."""
    rule: str
    target: str
    message: str
    severity: str = "error"
    detail: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "target": self.target,
                "message": self.message, "severity": self.severity,
                "detail": self.detail or {}}

    def __str__(self) -> str:
        return f"[{self.severity}] {self.target}: {self.rule}: {self.message}"


@dataclasses.dataclass
class LintTarget:
    """One serving program under analysis.

    ``phase`` is "decode", "prefill" or "chunk"; (``cache_kind``,
    ``style``, ``impl``) is the backend-registry key the program was built
    from.  ``graph`` is the traced program (``walker.trace``); merged
    targets also carry ``source_graph``, the SAME phase/cache/impl program
    of the unmerged source model, the baseline ``NoForbiddenMatmul`` diffs
    against, and ``n_attn_layers``, the layers whose Q and P the merge
    removed (the graph unrolls the layers).  ``donated`` lists the cache
    leaves the serving adapter hands the program to write in place (where
    the reference donates them): (name, the tensor passed in, the tensor
    returned in its place, or None).  ``max_len`` / ``cache_shapes`` /
    ``cache_dtype`` describe the cache the program serves, for the
    buffer-shape rules.  ``instrumented_graph`` is the SAME program
    re-traced with the ``repro_torch.obs`` observer ACTIVE
    (``obs.activated(...)``): ``NoHostTransferInObsHooks`` diffs it
    against ``graph``.  ``device`` is where the program ran."""
    phase: str
    cache_kind: str
    style: str
    impl: str
    graph: Any
    cfg: Any = None
    source_graph: Any = None
    n_attn_layers: int = 0
    donated: Tuple[Tuple[str, Any, Any], ...] = ()
    max_len: Optional[int] = None
    cache_shapes: Tuple[Tuple[int, ...], ...] = ()
    cache_dtype: Any = None
    instrumented_graph: Any = None
    device: str = "cpu"

    @property
    def key(self) -> str:
        return f"{self.phase}:{self.cache_kind}/{self.style}/{self.impl}"


class LintRule:
    """Base class: subclass, set ``name``/``description``, implement
    ``applies`` and ``check``."""

    name: str = "?"
    description: str = "?"

    def applies(self, target: LintTarget) -> bool:
        raise NotImplementedError

    def check(self, target: LintTarget) -> List[Finding]:
        raise NotImplementedError

    def finding(self, target: LintTarget, message: str, *,
                severity: str = "error",
                detail: Optional[Dict[str, Any]] = None) -> Finding:
        return Finding(rule=self.name, target=target.key, message=message,
                       severity=severity, detail=detail)


_RULES: Dict[str, LintRule] = {}


def register_rule(rule: LintRule) -> None:
    """Register ``rule`` under ``rule.name`` (latest wins, exactly like
    the backend registries — swap, don't fork)."""
    _RULES[rule.name] = rule


def get_rule(name: str) -> LintRule:
    try:
        return _RULES[name]
    except KeyError:
        raise KeyError(
            f"no lint rule registered under {name!r}; registered rules: "
            f"{registered_rules()}") from None


def registered_rules() -> List[str]:
    return sorted(_RULES)


def all_rules() -> List[LintRule]:
    return [_RULES[n] for n in registered_rules()]


def run_rules(target: LintTarget,
              rules: Optional[List[LintRule]] = None
              ) -> Tuple[List[str], List[Finding]]:
    """Run every applicable rule on ``target``.  Returns (names of rules
    that ran, findings)."""
    ran: List[str] = []
    findings: List[Finding] = []
    for rule in (all_rules() if rules is None else rules):
        if not rule.applies(target):
            continue
        ran.append(rule.name)
        findings.extend(rule.check(target))
    return ran, findings
