"""``fused_smooth`` (``csrc/fused_smooth.cu``, one red-black smoothing phase
of a BoxMG level) against its bound, in %: 100 times the launches' bounds
summed over their device times summed. Each launch takes its form and its
level's shape N x M from the innermost ``pcg.smooth.<form>.<N>x<M>`` range
holding its start (``poisson/boxmg.py`` ``v_cycle``); launches outside such
a range are left out, and nothing is read where there is none.

The bytes the algorithm reads and writes once, in planes of the level's
N x M points and of the coarse level's Nc x Mc = ceil(N / 2) x ceil(M / 2):

- restrict (pre-smoothing from zero, then P^T (b - A x)): reads the NC
  operator planes and b, writes x: (NC + 2) N M; reads the 8 transfer
  weights, writes the coarse residual: 9 Nc Mc;
- correct (x0 + P ec, then post-smoothing): reads the NC planes, b and
  x0, writes x: (NC + 3) N M; reads the 8 weights and ec: 9 Nc Mc;
- coarse (a sweep pair on the coarsest level without a transfer): the NC
  planes and b read, x written: (NC + 2) N M (the x0 that every pair but
  the first reads is not counted: a lower bound).

NC is 5 on the finest level, the (nx + 2) x (ny + 2) pressure box
(the assembled 5-point operator), and 9 on every coarser one (Galerkin
products). Operations per point: a half-step updates half the points at
2 NC each (NC - 1 products and sums, the division), so NC a point per
half-step, four half-steps a phase (the cells' V(2, 2)); the residual 2 NC
and the restriction 17 a coarse point (restrict), the prolongation and
correction 5 a point (correct). At 8 bytes a value that is 34 operations
against 74 bytes a point for the finest restriction, so the bytes bound
every form.
"""

import re

from bench_port.metrics.momentum_ms_per_step import innermost
from bench_port.peaks import DTYPE_BYTES, bound_seconds

KERNEL = "fused_smooth_kernel"
SPAN = re.compile(r"pcg\.smooth\.(restrict|correct|coarse)\.(\d+)x(\d+)$")
HALF_STEPS = 4


def bytes_ops(form: str, n: int, m: int, nc: int, dtype: str) -> tuple:
    points, coarse = n * m, ((n + 1) // 2) * ((m + 1) // 2)
    smooth = HALF_STEPS * nc * points
    if form == "restrict":
        planes, ops = (nc + 2) * points + 9 * coarse, smooth + 2 * nc * points + 17 * coarse
    elif form == "correct":
        planes, ops = (nc + 3) * points + 9 * coarse, smooth + 5 * points
    else:
        planes, ops = (nc + 2) * points, smooth
    return planes * DTYPE_BYTES[dtype], ops


def read(run):
    tr = run.trace
    if tr is None:
        return None
    launches = tr.kernel(KERNEL)
    spans = [r for r in tr.ranges if SPAN.match(r.name)]
    if not launches or not spans:
        return None
    finest = (run.grid["nx"] + 2, run.grid["ny"] + 2)
    bound_s = time_s = 0.0
    for op, span in zip(launches, innermost(spans, [op.start for op in launches])):
        if span is None:
            continue
        form, n, m = SPAN.match(span.name).groups()
        n, m = int(n), int(m)
        b, f = bytes_ops(form, n, m, 5 if (n, m) == finest else 9, run.dtype)
        bound_s += bound_seconds(b, f, run.dtype)
        time_s += op.us / 1e6
    return 100.0 * bound_s / time_s if time_s else None
