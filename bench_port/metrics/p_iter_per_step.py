"""Pressure iterations per driver step: the step's ``p_iter`` (summed over
its solves), as the driver's observed values carry it, averaged over the
window's steps (layer: pressure)."""


def read(run):
    return run.window.mean("p_iter")
