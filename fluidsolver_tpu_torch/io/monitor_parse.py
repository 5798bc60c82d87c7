"""Parse monitor tables back into numpy arrays (python/Utility.py:4-7):
port of ``fluidsolver_tpu.io.monitor_parse``."""

from __future__ import annotations

import numpy as np


def read_monitor_file(path: str) -> dict:
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    header = [c.strip() for c in lines[0].strip("|").split("|")]
    header = [h for h in header if h]
    rows = []
    for ln in lines[2:]:
        cells = [c.strip() for c in ln.strip("|").split("|")]
        cells = [c for c in cells if c != ""]
        if len(cells) == len(header):
            rows.append([float(c) for c in cells])
    data = np.asarray(rows)
    return {name: data[:, k] for k, name in enumerate(header)}
