"""``roofline.fused_rhs`` on synthetic traces: the share from known bytes
and time, and nothing where the trace holds no such launch (the cavity's
single-phase step)."""

import pytest

from bench_port import harness, peaks, trace, window


def run_of(tr, grid, dtype):
    return harness.Run(window=window.Window([]), trace=tr, grid=grid, dtype=dtype)


def test_roofline_share_from_known_bytes_and_time():
    ops = [trace.Op("void fs::(anonymous namespace)::fused_rhs_kernel<double>"
                    "(fs::(anonymous namespace)::RhsArgs<double>)", 100.0, 900.0),
           trace.Op("void fused_momentum_kernel<double>(MomArgs<double>)", 1000.0, 2000.0),
           trace.Op("void fs::(anonymous namespace)::fused_rhs_kernel<double>"
                    "(fs::(anonymous namespace)::RhsArgs<double>)", 3000.0, 3600.0)]
    tr = trace.Trace(ops=ops, ranges=[], host=[], wall_s=0.01, steps=1)
    read = harness.load_reader("roofline.fused_rhs")
    points = 10242 * 2050
    bound = 12 * points * 8 / peaks.HBM_BYTES_PER_S      # bytes bound the kernel
    assert bound > 60 * points / peaks.FLOPS_PER_S["float64"]
    got = read(run_of(tr, {"nx": 10240, "ny": 2048}, "float64"))
    assert got == pytest.approx(100 * bound / 700e-6)     # mean of 800, 600 us
    assert 0 < got <= 100


def test_nothing_to_read_without_a_launch():
    ops = [trace.Op("void fused_momentum_kernel<float>(MomArgs<float>)", 0.0, 500.0)]
    read = harness.load_reader("roofline.fused_rhs")
    grid = {"nx": 4095, "ny": 4095}
    assert read(run_of(trace.Trace(ops=ops, ranges=[], host=[], wall_s=1.0, steps=1), grid, "float32")) is None
    assert read(run_of(None, grid, "float32")) is None
