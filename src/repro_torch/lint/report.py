"""Render lint results: a human report to a stream, a structured dict for
JSON — one format for the sweep, the audits, or all of them combined
(what ``python -m repro_torch.lint`` emits).  Counterpart of
``repro.lint.report``."""
from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

from repro_torch.lint.rules import Finding, all_rules
from repro_torch.lint.sweep import SweepReport


def render_sweep(report: SweepReport, out=None, verbose: bool = False
                 ) -> None:
    out = out or sys.stdout
    n_rules = sum(len(t.rules_run) for t in report.targets)
    devices = sorted({t.device for t in report.targets})
    print(f"repro_torch.lint sweep: {report.n_decode_targets} decode + "
          f"{report.n_prefill_targets} prefill + "
          f"{report.n_chunk_targets} chunk backends "
          f"(registry: {report.n_decode_backends} + "
          f"{report.n_prefill_backends} + {report.n_chunk_backends}), "
          f"{n_rules} rule runs, traced on {'/'.join(devices)}",
          file=out)
    for t in report.targets:
        mark = "FAIL" if any(f.severity == "error" for f in t.findings) \
            else "ok"
        if verbose or mark != "ok":
            print(f"  {mark:>4}  {t.key:<34} {t.device:<4} kernel nodes "
                  f"{t.n_kernel_nodes} launches {t.launches}  "
                  f"rules: {', '.join(t.rules_run) or '-'}", file=out)
        for f in t.findings:
            print(f"        {f}", file=out)
    print(f"sweep: {'CLEAN' if report.ok else 'VIOLATIONS'} "
          f"({len(report.findings)} findings)", file=out)


def render_findings(title: str, findings: List[Finding], out=None) -> None:
    out = out or sys.stdout
    status = "CLEAN" if not findings else f"{len(findings)} findings"
    print(f"{title}: {status}", file=out)
    for f in findings:
        print(f"  {f}", file=out)


def render_rules(out=None) -> None:
    out = out or sys.stdout
    for rule in all_rules():
        print(f"  {rule.name:<26} {rule.description}", file=out)


def to_json_dict(sweep: Optional[SweepReport] = None,
                 aliasing: Optional[List[Finding]] = None,
                 submit: Optional[List[Finding]] = None,
                 retention: Optional[List[Finding]] = None
                 ) -> Dict[str, Any]:
    doc: Dict[str, Any] = {"rules": {r.name: r.description
                                     for r in all_rules()}}
    ok = True
    if sweep is not None:
        doc["sweep"] = sweep.to_dict()
        ok = ok and sweep.ok
    for key, findings in (("aliasing", aliasing), ("submit", submit),
                          ("retention", retention)):
        if findings is not None:
            doc[key] = [f.to_dict() for f in findings]
            ok = ok and not any(f.severity == "error" for f in findings)
    doc["ok"] = ok
    return doc
