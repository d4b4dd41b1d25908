"""The lint CLI: static analysis over the port's serving programs.

    python -m repro_torch.lint --sweep       lint every registered backend
    python -m repro_torch.lint --aliasing    host-aliasing audit of real
                                             engines
    python -m repro_torch.lint --submit      NoSyncPrefillInSubmit audit of
                                             the scheduled engines
                                             (+ positive control)
    python -m repro_torch.lint --retention   NoWriteIntoHeldPage audit of
                                             the paged managers
                                             (+ positive control)
    python -m repro_torch.lint               all four
    python -m repro_torch.lint --list-rules  registered rules
    python -m repro_torch.lint --json out.json  also write the report

``--device cuda`` (the default) runs the ``"cuda"`` combos and the audits'
engines on the card, through the kernels (it raises without one);
``--device cpu`` runs everything on the CPU, where the kernel operators
run their plain versions.  Exit status is non-zero iff any error-severity
finding fired (or a registered combo could not be linted: coverage holes
are errors too).  The counterpart of the reference's ``tools/jaxlint.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def _run_sweep(args):
    from repro_torch.lint import report, sweep
    progress = None
    if args.verbose:
        def progress(key):
            print(f"[repro_torch.lint] trace {key}", flush=True)
    rep = sweep(progress=progress, device=args.device)
    report.render_sweep(rep, verbose=args.verbose)
    return rep


def _run_aliasing(args):
    """Audit one engine per cache kind at reduced shape — the real
    submit/step/preempt path with the aliasing spies armed."""
    from repro_torch.lint import aliasing, report, submitpath
    from repro_torch.serving import Engine, ServeConfig

    cfg, params = submitpath.audit_model(args.device)
    impl = "cuda" if args.device == "cuda" else "torch"
    findings = []
    for kind in ("dense", "paged", "paged_q8"):
        eng = Engine(cfg, params, ServeConfig(n_slots=2, max_len=48),
                     impl=impl, cache=kind, device=args.device)
        findings += aliasing.audit_engine(eng)
    report.render_findings(
        "aliasing audit (dense + paged + paged_q8 engines)", findings)
    return findings


def _run_submit(args):
    from repro_torch.lint import report, submitpath

    findings = submitpath.audit_submit_path(device=args.device)
    report.render_findings(
        "submit-path audit (scheduled dense + paged, sync control)",
        findings)
    return findings


def _run_retention(args):
    from repro_torch.lint import report, retention

    findings = retention.audit_retention(device=args.device)
    report.render_findings(
        "retention audit (paged fp absolute + ring + q8, sabotage "
        "control)", findings)
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.lint",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="lint every registered backend combo")
    ap.add_argument("--aliasing", action="store_true",
                    help="host-aliasing audit of dense+paged+paged_q8 "
                         "engines")
    ap.add_argument("--submit", action="store_true",
                    help="NoSyncPrefillInSubmit audit of scheduled engines")
    ap.add_argument("--retention", action="store_true",
                    help="NoWriteIntoHeldPage audit of the paged managers")
    ap.add_argument("--list-rules", action="store_true",
                    help="print registered rules and exit")
    ap.add_argument("--json", metavar="PATH",
                    help="write the structured report to PATH")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the kernels' combos and the audits run "
                         "(default cuda: raises without a card)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch.lint import report

    if args.list_rules:
        report.render_rules()
        return 0
    resolve_device(args.device)  # no card: raise before any work

    none_picked = not (args.sweep or args.aliasing or args.submit
                       or args.retention)
    sweep_rep = _run_sweep(args) if args.sweep or none_picked else None
    alias = _run_aliasing(args) if args.aliasing or none_picked else None
    submit = _run_submit(args) if args.submit or none_picked else None
    retain = _run_retention(args) if args.retention or none_picked \
        else None

    doc = report.to_json_dict(sweep=sweep_rep, aliasing=alias,
                              submit=submit, retention=retain)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(doc, fh, indent=2)
        print(f"[repro_torch.lint] JSON report: {args.json}")
    if not doc["ok"]:
        print("[repro_torch.lint] FAIL: violations above", file=sys.stderr)
        return 1
    print("[repro_torch.lint] clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
