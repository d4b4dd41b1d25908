"""The traced slice's busy time, gaps and their host labels, on a made-up
timeline."""
import portbench_tiny  # noqa: F401  (paths)
from portbench import trace


def test_union_and_gaps():
    busy, gaps = trace._union([(10, 20), (15, 30), (40, 50), (60, 200)],
                              0, 100)
    assert busy == [[10, 30], [40, 50], [60, 100]]
    assert gaps == [(0, 10), (30, 40), (50, 60)]


def test_labels_innermost_under_harness_range():
    cpu = [(0, 100, "portbench::slice"), (0, 50, "portbench::step"),
           (5, 20, "aten::mm"), (60, 90, "portbench::submit"),
           (70, 80, "aten::item")]
    got = trace._labels(cpu, [2, 10, 30, 55, 75, 95])
    assert got == ["portbench::step", "portbench::step/aten::mm",
                   "portbench::step", "portbench::slice",
                   "portbench::submit/aten::item", "portbench::slice"]
    assert trace._labels(cpu, [150]) == ["(outside every event)"]
