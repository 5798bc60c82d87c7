"""The per-layer readers and the trace arithmetic on a synthetic trace."""

import pytest

from bench_port import harness, peaks, trace, window


def synthetic(wall_s=0.010):
    ops = [trace.Op("void step_ab_kernel<float>(AbArgs<float>)", 100.0, 400.0),
           trace.Op("void fused_momentum_kernel<float>(MomArgs<float>)", 500.0, 1100.0),
           trace.Op("elementwise", 1050.0, 1200.0),          # overlaps the one before
           trace.Op("void step_ab_kernel<float>(AbArgs<float>)", 3000.0, 3500.0),
           trace.Op("void elvira_kernel<float>()", 6000.0, 6200.0)]
    ranges = [trace.Op("twophase.pressure", 50.0, 3600.0), trace.Op("twophase.vof", 5900.0, 7000.0)]
    host = [trace.Op("ProfilerStep#1", 0.0, 9000.0), trace.Op("twophase.pressure", 40.0, 3700.0),
            trace.Op("aten::item", 1300.0, 2900.0), trace.Op("twophase.vof", 3800.0, 7000.0)]
    return trace.Trace(ops=ops, ranges=ranges, host=host, wall_s=wall_s, steps=2)


def run_of(tr, grid=None):
    return harness.Run(window=window.Window([]), trace=tr,
                       grid=grid or {"nx": 1022, "ny": 1022}, dtype="float32")


def test_busy_is_the_union_of_device_intervals():
    # 300 + (500..1200 = 700) + 500 + 200
    assert synthetic().busy_s() == pytest.approx(1700e-6)


def test_range_assignment_by_start_inside_the_span():
    tr = synthetic()
    # the two step_ab launches, the momentum and the elementwise op start in
    # the pressure span (50..3600); elvira in the VOF span
    assert tr.range_us("twophase.pressure") == pytest.approx(300 + 600 + 150 + 500)
    assert harness.load_reader("pressure_ms_per_step")(run_of(tr)) == pytest.approx(1.55 / 2)
    assert harness.load_reader("vof_ms_per_step")(run_of(tr)) == pytest.approx(0.2 / 2)


def test_idle_share_and_gaps():
    tr = synthetic()
    assert harness.load_reader("idle_share")(run_of(tr)) == pytest.approx(100 * (1 - 1.7e-3 / 0.010))
    gaps = tr.idle_gaps()
    # the longest gap (3500..6000) falls in the VOF range on the host, the
    # next (1200..3000) inside a host read in the pressure range
    assert gaps[0] == ["twophase.vof", pytest.approx(2500e-6)]
    assert gaps[1] == ["aten::item", pytest.approx(1800e-6)]


def test_roofline_share_from_known_bytes_and_time():
    tr = synthetic()
    read = harness.load_reader("roofline.step_ab")
    grid = {"nx": 1022, "ny": 1022}
    points = 1024 * 1024
    bound = 10 * points * 4 / peaks.HBM_BYTES_PER_S      # bytes bound the kernel
    assert bound > 18 * points / peaks.FLOPS_PER_S["float32"]
    assert read(run_of(tr, grid)) == pytest.approx(100 * bound / 400e-6)   # mean of 300, 500 us
    mom = harness.load_reader("roofline.fused_momentum")
    assert mom(run_of(tr, grid)) == pytest.approx(100 * 16 * points * 4 / peaks.HBM_BYTES_PER_S / 600e-6)


def test_readers_return_nothing_where_there_is_nothing_to_read():
    empty = trace.Trace(ops=[], ranges=[], host=[], wall_s=1.0, steps=1)
    for name in ("pressure_ms_per_step", "vof_ms_per_step", "idle_share", "roofline.step_ab",
                 "roofline.fused_momentum"):
        assert harness.load_reader(name)(run_of(empty)) is None
        assert harness.load_reader(name)(run_of(None)) is None
