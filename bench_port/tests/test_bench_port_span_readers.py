"""The readers of the program's stage, pressure and host-read spans on
hand-made traces: their values on a small timeline, nothing where their
span is absent, the innermost smoothing span naming a launch's level, the
idle split at host reads, and the sweep's time on a channel-sized trace."""

import random
import time

import pytest

from bench_port import harness, peaks, trace, window

STAGE_READERS = {"momentum_ms_per_step": "twophase.momentum", "rhs_ms_per_step": "twophase.rhs",
                 "hierarchy_ms_per_step": "pcg.hierarchy", "solve_ms_per_step": "pcg.solve",
                 "guards_ms_per_step": "pcg.guards"}
NEW = sorted(STAGE_READERS) + ["roofline.fused_smooth", "idle_at_sync_share"]
SMOOTH = "void fs::(anonymous namespace)::fused_smooth_kernel<double, 9, 2>(fs::SmoothArgs<double>)"


def run_of(tr, grid=None, dtype="float64"):
    return harness.Run(window=window.Window([]), trace=tr, grid=grid or {"nx": 60, "ny": 12},
                       dtype=dtype)


def timeline():
    """One step (us): momentum 0-100, rhs 100-150, then pressure 150-1000
    holding a hierarchy build (160-300) and a solve (300-990) with a
    smoothing launch (400-500) and one iteration's guards (800-880); the
    host waits in a read from 895 to 960, inside the solve."""
    ops = [trace.Op("mid_time", 0, 40), trace.Op("fused_momentum_kernel", 40, 100),
           trace.Op("divergence", 100, 130), trace.Op("jump", 130, 150),
           trace.Op("assemble", 150, 160), trace.Op("fused_rap_kernel", 160, 300),
           trace.Op("step_init_kernel", 300, 380), trace.Op(SMOOTH, 400, 500),
           trace.Op("step_ab_kernel", 500, 700), trace.Op("where", 800, 880),
           trace.Op("Memcpy DtoH", 900, 902), trace.Op("shift", 990, 1000)]
    ranges = [trace.Op("twophase.momentum", 0, 100), trace.Op("twophase.rhs", 100, 150),
              trace.Op("twophase.pressure", 150, 1000), trace.Op("pcg.hierarchy", 160, 300),
              trace.Op("pcg.solve", 300, 990), trace.Op("pcg.smooth.restrict.31x7", 400, 500),
              trace.Op("pcg.guards", 800, 880), trace.Op("twophase.sync", 900, 902)]
    host = [trace.Op("twophase.pressure", 140, 995), trace.Op("aten::where", 700, 790),
            trace.Op("twophase.sync", 895, 960)]
    return trace.Trace(ops=ops, ranges=ranges, host=host, wall_s=1e-3, steps=1)


@pytest.mark.parametrize("metric", sorted(STAGE_READERS))
def test_a_stage_reader_sums_the_operations_starting_in_its_spans(metric):
    tr = timeline()
    want = {"momentum_ms_per_step": 0.1, "rhs_ms_per_step": 0.05, "hierarchy_ms_per_step": 0.14,
            "solve_ms_per_step": (80 + 100 + 200 + 80 + 2) / 1e3, "guards_ms_per_step": 0.08}
    got = harness.load_reader(metric)(run_of(tr))
    assert got == pytest.approx(want[metric])
    # the harness's own arithmetic, test by test
    assert got == pytest.approx(tr.range_us(STAGE_READERS[metric]) / 1e3)


def test_stage_readers_divide_by_the_steps_and_count_each_operation_once():
    tr = timeline()
    # a second step: every span and operation again, 1000 us later
    tr = trace.Trace(ops=tr.ops + [trace.Op(o.name, o.start + 1000, o.end + 1000) for o in tr.ops],
                     ranges=tr.ranges + [trace.Op(r.name, r.start + 1000, r.end + 1000) for r in tr.ranges],
                     host=tr.host, wall_s=2e-3, steps=2)
    assert harness.load_reader("solve_ms_per_step")(run_of(tr)) == pytest.approx(0.462)
    assert harness.load_reader("pressure_ms_per_step")(run_of(tr)) == pytest.approx(0.622)


def test_the_roofline_takes_form_and_shape_from_the_innermost_smoothing_span():
    tr = timeline()
    read = harness.load_reader("roofline.fused_smooth")
    # 31 x 7 below the finest level, the 62 x 14 pressure box of nx = 60,
    # ny = 12: 9-point, restriction; 16 x 4 coarse
    bound = (11 * 31 * 7 + 9 * 16 * 4) * 8 / peaks.HBM_BYTES_PER_S
    assert read(run_of(tr)) == pytest.approx(100 * bound / 100e-6)
    # a pcg.smooth span that holds another: the inner one names the launch
    outer = trace.Op("pcg.smooth.correct.62x14", 390, 600)
    tr.ranges.append(outer)
    assert read(run_of(tr)) == pytest.approx(100 * bound / 100e-6)
    # a launch in the outer span only is read as the finest correction
    tr.ops.append(trace.Op(SMOOTH, 550, 650))
    fine = ((5 + 3) * 62 * 14 + 9 * 31 * 7) * 8 / peaks.HBM_BYTES_PER_S
    assert read(run_of(tr)) == pytest.approx(100 * (bound + fine) / 200e-6)
    # a launch outside every smoothing span is left out
    tr.ops.append(trace.Op(SMOOTH, 2000, 2100))
    assert read(run_of(tr)) == pytest.approx(100 * (bound + fine) / 200e-6)


def test_the_roofline_of_each_form_at_the_bench_restriction():
    """The finest restriction at 1026^2 in float32 is PERF.md's 0.0116 ms."""
    read = harness.load_reader("roofline.fused_smooth")
    tr = trace.Trace(ops=[trace.Op(SMOOTH, 0, 29)], ranges=[trace.Op("pcg.smooth.restrict.1026x1026", 0, 29)],
                     host=[], wall_s=1e-3, steps=1)
    share = read(run_of(tr, {"nx": 1024, "ny": 1024}, "float32"))
    assert share == pytest.approx(100 * 0.011627 / 0.029, rel=1e-3)
    for form, planes in (("correct", (8 * 1026 ** 2 + 9 * 513 ** 2)), ("coarse", 7 * 1026 ** 2)):
        tr.ranges[0] = trace.Op(f"pcg.smooth.{form}.1026x1026", 0, 29)
        assert read(run_of(tr, {"nx": 1024, "ny": 1024}, "float32")) == pytest.approx(
            100 * planes * 4 / peaks.HBM_BYTES_PER_S / 29e-6)


def test_idle_splits_at_the_host_reads():
    tr = timeline()
    # gaps: 380-400 (20), 700-800 (100, the host in aten::where), 880-900
    # (20), 902-990 (88, opening inside the host's twophase.sync)
    assert harness.load_reader("idle_at_sync_share")(run_of(tr)) == pytest.approx(100 * 88 / 228)
    # the read ends before the device runs dry: no gap opens inside it
    tr.host[-1] = trace.Op("twophase.sync", 895, 901)
    assert harness.load_reader("idle_at_sync_share")(run_of(tr)) == 0.0


def test_readers_return_nothing_where_their_span_is_absent():
    tr = timeline()
    bare = trace.Trace(ops=tr.ops, ranges=[r for r in tr.ranges if r.name == "twophase.pressure"],
                       host=[h for h in tr.host if h.name != "twophase.sync"], wall_s=1e-3, steps=1)
    empty = trace.Trace(ops=[], ranges=[], host=[], wall_s=1.0, steps=1)
    for name in NEW:
        for t in (bare, empty, None):
            assert harness.load_reader(name)(run_of(t)) is None, name


def test_the_sweeps_read_a_channel_sized_trace_in_under_a_second():
    """10^4 smoothing spans, 10^4 guard spans and 10^5 device operations,
    like a channel block's: the roofline, the idle split and a stage
    reader each in under a second."""
    rng = random.Random(5)
    ops, ranges, host, t = [], [], [], 0.0
    for k in range(100_000):
        t += rng.uniform(1.0, 3.0)
        smooth = k % 10 == 0
        ops.append(trace.Op(SMOOTH if smooth else "where", t, t + 1.0))
        if smooth:
            ranges.append(trace.Op(f"pcg.smooth.restrict.{rng.choice(('62x14', '31x7'))}", t, t + 1.0))
        elif k % 10 == 5:
            ranges.append(trace.Op("pcg.guards", t, t + 1.0))
        if k % 200 == 0:
            host.append(trace.Op("twophase.sync", t + 1.0, t + 1.5))
    tr = trace.Trace(ops=ops, ranges=ranges, host=host, wall_s=t / 1e6, steps=20)
    assert len(ranges) == 20_000
    for name in ("roofline.fused_smooth", "idle_at_sync_share", "guards_ms_per_step"):
        read = harness.load_reader(name)
        t0 = time.perf_counter()
        value = read(run_of(tr))
        assert time.perf_counter() - t0 < 1.0, name
        assert 0.0 < value < 100.0, name
    assert read(run_of(tr)) == pytest.approx(10_000 * 1e-3 / 20)
