"""Continuous-batching scheduler: token-budget iteration plans that
interleave fixed-width chunked prefill with batched decode (``sched.plan``
for the policy, ``sched.engine`` for the execution)."""
from repro_torch.serving.sched.engine import ScheduledEngine
from repro_torch.serving.sched.plan import (ChunkPlan, PrefillJob,
                                            SchedConfig, Schedule,
                                            plan_iteration)

__all__ = [
    "ChunkPlan",
    "PrefillJob",
    "SchedConfig",
    "Schedule",
    "ScheduledEngine",
    "plan_iteration",
]
