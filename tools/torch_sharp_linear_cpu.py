"""The sharp IB channel with the linear and the quadratic weights, in both
packages on the CPU (f64): the step at which U first holds a NaN, or its
largest |U| after the last step.

    JAX_PLATFORMS=cpu python tools/torch_sharp_linear_cpu.py [--ny 32] [--steps 12]

The linear weights 1/(1 - beta) grow without bound as the wall nears the
fluid neighbour (beta -> 1), which a coarse grid meets (tests/test_ib.py
runs the quadratic ones for that reason); this prints where each package
stands on the same small case.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(make_state, make_step, steps, as_numpy):
    state, step = make_state(), make_step()
    for k in range(steps):
        state = step(state, 1e9)
        U = as_numpy(state.U)
        if not (U == U).all():
            return f"NaN in U at step {k + 1}"
    return f"finite after {steps} steps, max|U| {abs(U).max():.4e}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    jax.config.update("jax_enable_x64", True)
    from fluidsolver_tpu.cases import get_case as jget_case
    from fluidsolver_tpu_torch.cases import get_case

    for scheme in ("linear", "quadratic"):
        jcase = jget_case("sharp_ib_channel", ny=args.ny, scheme=scheme)
        tcase = get_case("sharp_ib_channel", ny=args.ny, scheme=scheme)
        j = run(lambda: jcase.make_state(np.float64), jcase.make_step, args.steps, np.asarray)
        t = run(lambda: tcase.make_state(torch.float64, "cpu"),
                lambda: tcase.make_step(torch.float64, "cpu"), args.steps, lambda x: x.numpy())
        print(f"sharp_ib_channel(ny={args.ny}, scheme={scheme!r}), f64 CPU: JAX package {j}; port {t}")


if __name__ == "__main__":
    main()
