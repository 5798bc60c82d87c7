"""Device-draining host reads per driver step: the change in the port's
``core.sync.count`` from one step's end to the next, over the window's
steps (layer: driver and step)."""


def read(run):
    return run.window.per_step("syncs")
