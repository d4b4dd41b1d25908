"""One run of one cell: set-up, the measured window, the check of what the
window served, and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``), a traffic mix (``traffic/<traffic>.json``)
and, in ``limits/<cell>.json``, the limit its comparison is held to.  The
configuration's ``reference`` names its block: ``weights/<reference>.py``
makes the seeded weights and checks the port's config against the file,
``reference/<reference>.py`` is the plain model the check runs.
Every metric is read by ``metrics/<metric>.py`` from the :class:`Run`
that this module fills; a reader that finds nothing to read returns None
and the metric is left out of the line.

Set-up runs from process start to the window: the kernels' build (timed
apart: only a checkout's first run builds), the seeded weights, the
engine and its pool, one prompt of every prefill shape the mix can send,
then the first wave (closed loop) or the lead of the arrivals (open
loop).  The window measures for ``--seconds``.  With ``--trace 1`` a
fixed number of steps right after the window run under
``torch.profiler`` (the closed loop refilling, the open loop's arrivals
still coming); the port's observer is on in such a run.  Once the
window has closed (and an open loop's requests due in it have their
first tokens), the peak memory is read, the engine and its pool are
freed, and the sample of finished requests goes through the reference
(``check.py``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench import check
from portbench.traffic import generator

_T_IMPORT = time.perf_counter()  # where /proc gives no process age
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> Optional[float]:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return up - start / os.sysconf("SC_CLK_TCK")


def load(kind: str, name: str) -> Dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def manifest() -> Dict:
    with open(HERE.parent / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(cell: Dict) -> tuple:
    """A workload entry's configuration, traffic mix and limits."""
    return (load("configs", cell["config"]), load("traffic", cell["traffic"]),
            load("limits", cell["name"]))


def block(kind: str, spec: Dict):
    """``<kind>/<spec['reference']>.py`` (``weights`` or ``reference``):
    the configuration's weight maker or plain model, found by name."""
    return importlib.import_module(f"portbench.{kind}.{spec['reference']}")


def reader(name: str) -> Callable:
    """``read(run)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


@dataclass
class Step:
    t0: float
    t1: float
    ctx: List[int]  # the active slots' context lengths (Engine only)
    in_slice: bool


@dataclass
class Submit:
    t0: float
    t1: float
    n: int  # tokens prefilled (a resume's prompt and generated tokens)
    in_slice: bool


@dataclass
class Tracked:
    """A request as the harness sees it: when it was due (open loop) and
    the host time at which each of its tokens became visible."""
    req: object
    due: Optional[float] = None
    times: List[float] = field(default_factory=list)


@dataclass
class Run:
    """Everything a metric reader may read."""
    cell: str
    s: Dict  # widths (``shapes`` of the configuration's weights module)
    mix: Dict
    seconds: float
    pool_pages: Optional[int] = None  # the paged pool's size in pages
    t0: float = 0.0
    t_end: float = 0.0
    setup_s: float = 0.0
    build_s: float = 0.0
    steps: List[Step] = field(default_factory=list)
    submits: List[Submit] = field(default_factory=list)
    tracked: List[Tracked] = field(default_factory=list)
    stats0: Dict = field(default_factory=dict)
    stats1: Dict = field(default_factory=dict)
    trace: Optional[Dict] = None  # trace.analyse's result
    obs_events: Optional[List[Dict]] = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def in_window(self, t: float) -> bool:
        return self.t0 < t <= self.t_end

    def due_in_window(self) -> List[Tracked]:
        return [r for r in self.tracked
                if r.due is not None and self.t0 <= r.due < self.t_end]


def build_engine(cfg, weights, mix: Dict, impl: str, device: str,
                 obs: bool):
    from repro_torch.serving import Engine, ScheduledEngine, ServeConfig
    from repro_torch.serving.sched import SchedConfig

    sc = ServeConfig(**mix["serve"], obs=obs)
    if mix["engine"] == "ScheduledEngine":
        return ScheduledEngine(cfg, weights, sc, SchedConfig(**mix["sched"]),
                               impl=impl, cache=mix["cache"], device=device)
    if mix["engine"] != "Engine":
        raise ValueError(f"unknown engine {mix['engine']!r}")
    return Engine(cfg, weights, sc, impl=impl, cache=mix["cache"],
                  device=device)


def port_config(spec: Dict):
    """The port's config for a configuration file, checked by the
    file's weights module against what the file states."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["port"]["arch"], **spec["port"]["overrides"])
    block("weights", spec).check_port(cfg, spec)
    return cfg


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), (tuple(tree.shape), tree.dtype)


def check_tree(weights, cfg) -> None:
    """The made weights have the port's leaves, shapes and dtypes."""
    from repro_torch.models import param_shapes

    want, have = dict(_leaves(param_shapes(cfg))), dict(_leaves(weights))
    if want != have:
        raise ValueError(f"weights differ from the port's tree: "
                         f"{set(want.items()) ^ set(have.items())}")


class Driver:
    """Feeds an engine and records what it serves, on the host clock."""

    def __init__(self, eng, run: Run, profile_steps: int, closed: bool,
                 cuda: bool):
        self.eng, self.run, self.closed, self.cuda = eng, run, closed, cuda
        self.live: List[Tracked] = []
        self.finished: List[object] = []
        self.profile_steps = profile_steps
        self.prof = self._slice = self._trace = None
        self.n_prof = 0

    # -- recording ------------------------------------------------------
    def _range(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _seen(self, now: float) -> None:
        keep = []
        for t in self.live:
            out = t.req.out_tokens or ()
            t.times.extend([now] * (len(out) - len(t.times)))
            if len(out) >= t.req.max_new_tokens:
                self.finished.append(t.req)
            else:
                keep.append(t)
        self.live = keep

    def track(self, req, due: Optional[float] = None) -> None:
        t = Tracked(req=req, due=due)
        self.live.append(t)
        self.run.tracked.append(t)

    # -- engine calls -----------------------------------------------------
    def submit(self, req) -> bool:
        resume = bool(req.out_tokens)
        n = len(req.prompt) + (len(req.out_tokens) - 1 if resume else 0)
        t0 = time.perf_counter()
        with self._range("portbench::submit"):
            ok = self.eng.submit(req)
        t1 = time.perf_counter()
        if ok and self.closed:
            self.run.submits.append(Submit(t0, t1, n, self.prof is not None))
            self._seen(t1)
        return ok

    def step(self) -> None:
        ctx = [len(r.prompt) + len(r.out_tokens)
               for r in self.eng.active.values()] if self.closed else []
        t0 = time.perf_counter()
        with self._range("portbench::step"):
            self.eng.step()
        t1 = time.perf_counter()
        self.run.steps.append(Step(t0, t1, ctx, self.prof is not None))
        self._seen(t1)
        if self.prof is not None:
            self.n_prof += 1
            if self.n_prof >= self.profile_steps:
                self.stop_profile()

    # -- the traced slice -------------------------------------------------
    @property
    def slicing(self) -> bool:
        """The traced slice is still to run or running."""
        return self.n_prof < self.profile_steps

    def start_profile(self) -> None:
        """Open the traced slice (after the window: the profiler's start
        and its parse at the stop would stall the window's loop)."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from portbench.trace import SLICE

        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._slice = record_function(SLICE)
        self._slice.__enter__()

    def _sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    def stop_profile(self) -> None:
        self._sync()
        self._slice.__exit__(None, None, None)
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self._trace = prof

    # -- loops -------------------------------------------------------------
    def refill(self, backlog: deque) -> None:
        """Closed loop: resumes first, then the backlog, into free slots."""
        eng = self.eng
        while eng.free_slots:
            waiting = eng.preempted if eng.preempted else backlog
            if not waiting:
                return
            req = waiting[0]
            if not self.submit(req):
                return
            if waiting is backlog:
                backlog.popleft()
                self.track(req)
            else:
                waiting.pop(0)

    def closed_window(self, backlog: deque) -> None:
        run = self.run
        run.t0 = time.perf_counter()
        run.t_end = run.t0 + run.seconds
        run.stats0 = dict(self.eng.stats)
        while time.perf_counter() < run.t_end:
            self.refill(backlog)
            self.step()
        run.t_end = run.steps[-1].t1
        run.stats1 = dict(self.eng.stats)
        if self.slicing:
            self.start_profile()
            while self.prof is not None:
                self.refill(backlog)
                self.step()
        # the check needs finished requests: a slow host may have
        # finished too few in the window (never so at the cells' sizes)
        want = int(run.mix["check"].get("min_requests", 1))
        for _ in range(int(run.mix["serve"]["max_len"])):
            if len(self.finished) >= want or not self.eng.active:
                break
            self.step()

    def open_loop(self, arrivals: deque, t_open: float, lead_s: float,
                  drain_s: float) -> int:
        """Arrivals from ``t_open``; the window starts ``lead_s`` later.
        After it, the traced slice (arrivals still coming), then the
        requests due in the window are served until each has its first
        token or ``drain_s`` passes; returns how many never got one."""
        run, eng = self.run, self.eng
        run.t0 = t_open + lead_s
        run.t_end = run.t0 + run.seconds
        opened = False
        drain_until = None
        while True:
            now = time.perf_counter()
            if not opened and now >= run.t0:
                opened = True
                run.stats0 = dict(eng.stats)
            if drain_until is None and now >= run.t_end:
                run.stats1 = dict(eng.stats)
                drain_until = now + drain_s
                if self.slicing:
                    self.start_profile()
            if drain_until is not None and self.prof is None:
                waiting = [t for t in run.due_in_window() if not t.times]
                if not waiting or now >= drain_until:
                    return len(waiting)
            while arrivals and arrivals[0][0] <= now and (
                    drain_until is None or self.prof is not None):
                due, req = arrivals.popleft()
                req.t_arrival = due
                with self._range("portbench::submit"):
                    eng.submit(req)
                self.track(req, due)
            if eng.waiting or eng.prefilling or eng.active or eng.preempted:
                self.step()
            elif arrivals:
                time.sleep(min(max(arrivals[0][0] - now, 0.0), 0.002))
            elif self.prof is not None:  # nothing left to serve
                self.stop_profile()


def warm_up(eng, mix: Dict, vocab: int, seed: int) -> None:
    """One prompt of every prefill shape the mix can send, then the decode
    step, through the engine's own entry points."""
    from repro_torch.serving import Request

    rng = generator.rng_for(seed, 99)
    reqs = [Request(prompt=rng.integers(0, vocab, n, dtype=np.int32),
                    max_new_tokens=2)
            for n in generator.warm_lengths(mix)]
    pending = deque(reqs)
    for _ in range(10 * len(reqs) + 100):
        while pending and eng.free_slots and eng.submit(pending[0]):
            pending.popleft()
        if not pending and all(len(r.out_tokens or ()) >= 2 for r in reqs):
            return
        eng.step()
    raise RuntimeError("warm-up did not finish")


def run_cell(cell: str, spec: Dict, mix: Dict, limit: Dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda",
             impl: str = "cuda", fault: Optional[Callable] = None,
             control: bool = False) -> Dict:
    """One run; returns the result's parts (before the metric readers).
    ``fault(engine)``, for the tests, breaks the timed path underneath;
    ``control`` also reads the float8 control on the same sample."""
    import torch
    from repro_torch.serving import Request

    cuda = device == "cuda"
    wmod, ref = block("weights", spec), block("reference", spec)
    run = Run(cell=cell, s=wmod.shapes(spec), mix=mix, seconds=seconds)
    cfg = port_config(spec)
    if cuda:
        from repro_torch.kernels import _build
        t = time.perf_counter()
        _build.build_all()
        run.build_s = time.perf_counter() - t
    weights = wmod.make(spec, seed, device)
    check_tree(weights, cfg)
    eng = build_engine(cfg, weights, mix, impl, device, obs=trace)
    if eng.paged:
        run.pool_pages = eng.pm.allocator.n_blocks
    warm_up(eng, mix, run.s["V"], seed)
    if fault is not None:
        fault(eng)
    items = generator.generate(mix, seed, run.s["V"])
    closed = mix["loop"] == "closed"
    drv = Driver(eng, run, int(mix["trace_steps"]) if trace else 0, closed,
                 cuda)
    unserved = 0
    if closed:
        backlog = deque(Request(prompt=it.prompt, max_new_tokens=it.max_new)
                        for it in items)
        drv.refill(backlog)  # the first wave, in set-up
        if cuda:
            torch.cuda.synchronize()
        _freeze_setup()
        run.setup_s = _age()
        drv.closed_window(backlog)
    else:
        _freeze_setup()
        t_open = time.perf_counter()
        arrivals = deque((t_open + it.due,
                          Request(prompt=it.prompt, max_new_tokens=it.max_new))
                         for it in items)
        run.setup_s = _age() + float(mix["lead_s"])
        unserved = drv.open_loop(arrivals, t_open, float(mix["lead_s"]),
                                 float(mix["drain_s"]))
    if drv.prof is not None:
        drv.stop_profile()
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        from portbench.trace import analyse
        run.trace = analyse(drv._trace) if drv._trace is not None else None
        if eng.obs.enabled:
            run.obs_events = eng.obs.trace.events()
    attempted = len(run.due_in_window()) if not closed else \
        sum(1 for t in run.tracked if t.times and t.times[0] <= run.t_end)
    finished = list(drv.finished)
    del eng, drv
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    sample = check.pick_sample(finished, generator.rng_for(seed, 7),
                               int(mix["check"]["served_tokens"]),
                               int(mix["check"]["max_requests"]))
    got = check.served_gaps(ref, weights, run.s, sample) if sample else \
        {k: math.inf for k in limit}
    checks = {k: {"value": got[k], "limit": v} for k, v in limit.items()}
    checks["unserved"] = {"value": unserved, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    res = {"run": run, "correct": correct, "attempted": attempted,
           "failed": unserved, "peak": peak, "checks": checks,
           "compared": {"requests": len(sample), **got}}
    if control and sample:
        res["control"] = check.control_gaps(ref, weights, run.s, sample)
    return res


def _freeze_setup() -> None:
    """Collect once, then keep what set-up made (weights, engine, pool,
    backlog) out of the cyclic collector's passes in the window, as a
    server does after its warm-up; ``gc.unfreeze`` once it has closed."""
    gc.collect()
    gc.freeze()


def _age() -> float:
    age = process_age_s()
    return age if age is not None else time.perf_counter() - _T_IMPORT


def metrics_of(man: Dict, cell: str, trace: bool, run: Run) -> Dict:
    section = "per_layer" if trace else "end_to_end"
    out = {}
    for m in man[section]:
        if "workloads" in m and cell not in m["workloads"]:
            continue
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if a.workload not in cells:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    w = cells[a.workload]
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"{a.workload} needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)  # the host work is one thread's launches
    res = run_cell(a.workload, *cell_files(w), a.seed, a.seconds,
                   bool(a.trace))
    run = res["run"]
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"],
            "metrics": metrics_of(man, a.workload, bool(a.trace), run),
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": int(w["chips"]),
                       "memory_peak_bytes": int(res["peak"])}}
    if a.trace and run.trace is not None:
        line["device"]["busy_s"] = run.trace["busy_s"]
        line["device"]["window_s"] = run.trace["window_s"]
        line["breakdown"] = {"device_ops": run.trace["device_ops"],
                             "idle_gaps": run.trace["idle_gaps"]}
    line["checks"] = res["checks"]
    print(f"build_s {run.build_s} setup_s {run.setup_s} window_s "
          f"{run.window_s} steps {len(run.steps)} compared "
          f"{res['compared']}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
