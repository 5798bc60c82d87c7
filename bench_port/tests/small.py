"""A cell's configuration cut to a size the CPU runs in seconds."""

import copy


def small_config(config: dict, n: int = 16) -> dict:
    c = copy.deepcopy(config)
    if c["case"] == "two_phase_channel":
        c["case_params"] = {"ny": n}
        c["grid"].update(nx=5 * n, ny=n)
    else:
        c["case_params"] = {"n": n}
        c["grid"].update(nx=n, ny=n)
    return c
