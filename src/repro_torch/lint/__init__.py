"""repro_torch.lint: static analysis over the port's traced serving
programs and its host serving state.

Counterpart of ``repro.lint``.  The paper's claim is structural — merged
programs must CONTAIN no Q/P matmul — and the serving stack's worst bug
classes (zero-copy aliasing of host buffers, worst-case buffer
regressions, a cache copied where it should be written in place, a host
sync per decoded token) are properties of the program or of the
host/device boundary, checkable before a single token is decoded:

  walker      shared traversal of ``make_fx`` graphs (kernel operators
              are single opaque nodes)
  rules       Finding / LintTarget / LintRule + the rule registry
  builtin     the built-in rules (NoForbiddenMatmul, NoOversizedBuffer,
              DonationEffective, NoDtypePromotionDrift,
              NoHostTransferInStepLoop, NoHostTransferInObsHooks,
              NoDequantizedPoolBuffer)
  sweep       sweep() — lint EVERY registered (cache_kind, style, impl)
              decode/prefill/chunk backend combo, no per-combo code
  aliasing    audit_engine() — the host-aliasing race detector
  submitpath  audit_submit_path() — NoSyncPrefillInSubmit: the scheduled
              engine's submit must enqueue only (with positive control)
  retention   audit_retention() — NoWriteIntoHeldPage: no write path may
              mutate a page a peer or the prefix tree still holds
  report      human/JSON rendering (``python -m repro_torch.lint`` is the
              CLI)
"""
from repro_torch.lint import aliasing, report, retention, submitpath, walker  # noqa: F401,E501
from repro_torch.lint.builtin import (BUILTIN_RULES, DonationEffective,  # noqa: F401
                                      NoDequantizedPoolBuffer,
                                      NoDtypePromotionDrift,
                                      NoForbiddenMatmul,
                                      NoHostTransferInObsHooks,
                                      NoHostTransferInStepLoop,
                                      NoOversizedBuffer)
from repro_torch.lint.rules import (Finding, LintRule, LintTarget,  # noqa: F401
                                    all_rules, get_rule, register_rule,
                                    registered_rules, run_rules)
from repro_torch.lint.sweep import (SweepReport, TargetReport,  # noqa: F401
                                    register_sweep_builders, sweep,
                                    sweep_models)
from repro_torch.lint.aliasing import audit_engine  # noqa: F401
from repro_torch.lint.retention import audit_retention  # noqa: F401
from repro_torch.lint.submitpath import audit_submit_path  # noqa: F401
