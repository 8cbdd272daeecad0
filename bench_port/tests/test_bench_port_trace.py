"""The trace reading: the device's busy time is the union of its
intervals, and idle gaps are named by the innermost host event."""

from bench_port.harness import trace


def test_union_of_overlapping_intervals():
    busy, gaps = trace._union([(10, 20), (15, 30), (40, 50), (5, 8)], 0, 60)
    assert busy == 3 + 20 + 10
    assert gaps == [(0, 5), (8, 10), (30, 40), (50, 60)]


def test_intervals_outside_the_window_are_clipped():
    busy, gaps = trace._union([(-5, 5), (55, 70)], 0, 60)
    assert busy == 10 and gaps == [(5, 55)]


def test_gaps_named_by_the_innermost_host_event():
    host = [(0, 100, "bench.fit"), (30, 60, "aten::copy_"), (35, 45, "cudaMemcpyAsync")]
    named = trace._name_gaps([(38, 42), (70, 80), (200, 210)], host, ["bench.fit"])
    assert named["cudaMemcpyAsync"] == 4e-9
    assert named["bench.fit"] == 10e-9
    assert named["outside the benchmark's spans"] == 10e-9
