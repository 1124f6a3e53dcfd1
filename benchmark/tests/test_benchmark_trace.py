"""The trace arithmetic on a synthetic event list."""

import pytest

from benchmark import trace


def ev(name, start, end, device=True):
    return {"name": name, "device": device, "start": float(start), "end": float(end)}


def test_union_merges_overlaps():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert trace.union_length([(0, 2), (1, 3), (5, 8)]) == 6


@pytest.fixture
def events():
    return [
        ev("slice", 0, 100, device=False),
        ev("cudaGraphLaunch", 0, 12, device=False),
        ev("cudaGraphLaunch", 50, 60, device=False),
        ev("gemm", 10, 30), ev("conv", 20, 40), ev("Memcpy HtoD", 40, 45),
        ev("gemm", 60, 90),
        ev("outside", 150, 160),
    ]


def test_summary_counts_busy_and_idle(events):
    s = trace.summarize(events, steps=2, window=(0, 100), window_s=100e-6)
    assert s["busy_s"] == pytest.approx(65e-6)  # [10, 45] and [60, 90]
    assert s["idle_share"] == pytest.approx(0.35)
    assert s["kernels_per_step"] == 1.5 and s["copies_per_step"] == 0.5
    assert s["device_ops"][0] == ["gemm", pytest.approx(50e-6)]


def test_idle_gaps_by_innermost_host_event(events):
    s = trace.summarize(events, steps=2, window=(0, 100), window_s=100e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(25e-6)  # [0, 10] and [45, 60]
    assert gaps["slice"] == pytest.approx(10e-6)  # [90, 100]


def test_no_device_events_reads_nothing():
    assert trace.summarize([ev("host", 0, 10, device=False)], 1, (0, 10), 1e-5) is None
