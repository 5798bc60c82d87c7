"""The port's two-phase step with the other curvature estimators and the
staggered backtrace, against the JAX package, in f64 on the CPU, as in
``test_torch_twophase_variants.py`` (two_phase_channel, 3 steps, 1e-12
relative at a pressure tolerance of 1e-11).

The convolved curvature runs at ny=32: at ny=16 the drop's radius is 1.8
cells, the bilinear sample at its interface reaches the drop's centre,
where the smoothed gradient vanishes and |grad|^3 crosses the estimator's
1e-8 cut, so one rounding decides the sample (the JAX package's jitted and
op-by-op runs differ there by 12% of the largest curvature; by 9e-16 at
ny=32). The staggered backtrace is held to the JAX step run op by op: it
samples U and V at their own nodes, where the sampler's upper index
floor(q + 1) skips a cell when q lands half an ulp below the integer; the
jitted JAX step divides by the mesh width as a multiplication by its
reciprocal and lands there (vf 1.3e-3 apart after two steps), the op-by-op
run and the port divide (vf 4.4e-14 apart).
"""

import pytest

from tests.test_torch_twophase_variants import run_against_jax


@pytest.mark.parametrize("change,ny,eager", [
    (dict(curvature_method="regression"), 16, False),
    (dict(curvature_method="convolved"), 32, False),
    (dict(vof_staggered_backtrace=True), 16, True),
], ids=["regression", "convolved", "staggered"])
def test_two_phase_channel_vof_options_against_jax(change, ny, eager):
    state = run_against_jax("two_phase_channel", dict(ny=ny), change, eager=eager)
    assert float(state.vf.min()) >= -1e-12 and float(state.vf.max()) <= 1.0 + 1e-12
