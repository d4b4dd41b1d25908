"""The readers of the port's own spans and step-sync counter: on a
made-up run, on a run whose program has neither (nothing to read), and
on a tiny traced run on the CPU."""
import pytest

import portbench_tiny as tiny
from portbench import harness

ENGINE, PHASE = ("engine", 0), ("phase", 0)
SPAN_READERS = ("step_wait_ms.tput", "step_host_ms.tput", "setup_engine_s")


def _x(track, name, t0, t1):
    return {"ph": "X", "name": name, "track": track, "t0": t0,
            "dur": t1 - t0, "args": {}}


def _run(events, stats0=None, stats1=None):
    run = harness.Run(cell="c", s={}, mix={}, seconds=1.0, t0=10.0,
                      t_end=11.0)
    run.obs_events = events
    run.stats0, run.stats1 = stats0 or {}, stats1 or {}
    return run


EVENTS = [
    _x(PHASE, "engine::init", 1.0, 3.0),
    _x(PHASE, "engine::wait", 4.0, 4.5),  # a submit's, before the window
    _x(PHASE, "engine::submit", 3.5, 5.0),
    _x(PHASE, "engine::submit", 9.0, 10.5),  # ends in the window
    _x(ENGINE, "step", 9.8, 9.95),  # ends before the window
    _x(PHASE, "engine::wait", 9.9, 9.94),
    _x(ENGINE, "step", 10.6, 10.7),
    _x(PHASE, "engine::wait", 10.68, 10.69),
    _x(ENGINE, "step", 10.8, 11.0),
    _x(PHASE, "engine::wait", 10.9, 10.93),
    _x(ENGINE, "step", 11.0, 11.05),  # ends after the window
    _x(PHASE, "engine::wait", 11.01, 11.02),
    {"ph": "C", "name": "pool_blocks_used", "track": ENGINE, "t0": 10.7,
     "args": {"value": 3}},
]


def test_span_readers_on_a_made_up_run():
    run = _run(EVENTS)
    # the two window steps: 100 ms waiting 10, 200 ms waiting 30
    assert harness.reader("step_wait_ms.tput")(run) == pytest.approx(20.0)
    assert harness.reader("step_host_ms.tput")(run) == pytest.approx(130.0)
    # init 2 s and the submit that ended before the window, 1.5 s
    assert harness.reader("setup_engine_s")(run) == pytest.approx(3.5)


@pytest.mark.parametrize("events", [None, [], [
    e for e in EVENTS if e["track"] == ENGINE]])
def test_span_readers_find_nothing_without_the_phase_track(events):
    """A run without the observer, or a program whose ring has no phase
    track (the engine track alone): nothing to read, nothing raised."""
    run = _run(events)
    assert [harness.reader(n)(run) for n in SPAN_READERS] == [None] * 3


@pytest.mark.parametrize("stats0,stats1,want", [
    ({"n_steps": 10, "n_step_syncs": 40},
     {"n_steps": 30, "n_step_syncs": 120}, 4.0),
    ({"n_steps": 10, "n_step_syncs": 40},
     {"n_steps": 10, "n_step_syncs": 40}, None),  # no step in the window
    ({"n_steps": 10}, {"n_steps": 30}, None),  # a program without it
    ({}, {}, None)])
def test_host_syncs_per_step(stats0, stats1, want):
    got = harness.reader("host_syncs_per_step.tput")(
        _run(None, stats0, stats1))
    assert got == (want if want is None else pytest.approx(want))


def test_tiny_traced_run_reads_the_program():
    """The batch mix through the paged ``Engine`` on the CPU, traced (the
    observer on): four counted transfers a step, wait and host time that
    add up to the engine's own step spans, and the engine's share of the
    set-up."""
    res = tiny.run("mistral7b-qpfree", "batch", trace=True)
    run = res["run"]
    assert res["correct"], res["checks"]
    assert harness.reader("host_syncs_per_step.tput")(run) == 4.0
    wait = harness.reader("step_wait_ms.tput")(run)
    host = harness.reader("step_host_ms.tput")(run)
    steps = [e["dur"] for e in run.obs_events if e["track"] == ENGINE
             and e["name"] == "step" and run.in_window(e["t0"] + e["dur"])]
    assert 0 < wait and 0 < host
    assert wait + host == pytest.approx(sum(steps) / len(steps) * 1e3)
    assert 0 < harness.reader("setup_engine_s")(run) < run.setup_s
