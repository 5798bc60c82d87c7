"""The numbers that decide ``correct``: the largest gap between the
program's field and the reference's over the interior, as a share of the
reference field's largest magnitude there."""

from __future__ import annotations

import dataclasses

import torch

STEP_FIELDS = ("vf", "U", "V", "p")


def _field(fields: dict, name: str):
    if name in fields:
        return fields[name]
    return fields["flow"][name] if "flow" in fields else None


def rel_gap(a: torch.Tensor, b: torch.Tensor, up_to_constant: bool = False) -> float:
    """max |a - b| / max |b| over the interior, in float64; ``up_to_constant``
    compares both less their interior means. NaN or inf anywhere reads inf."""
    a = a[1:-1, 1:-1].to(torch.float64)
    b = b[1:-1, 1:-1].to(torch.float64)
    if up_to_constant:
        a, b = a - a.mean(), b - b.mean()
    gap = float((a - b).abs().max())
    scale = float(b.abs().max())
    if gap != gap or scale != scale:
        return float("inf")
    return gap / scale if scale > 0.0 else gap


def cast(fields: dict, dtype) -> dict:
    """{name: tensor} with every floating-point tensor in ``dtype``."""
    return {k: cast(v, dtype) if isinstance(v, dict) else v.to(dtype) if v.is_floating_point() else v
            for k, v in fields.items()}


def as_fields(state) -> dict:
    out = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    if "flow" in out:
        out["flow"] = as_fields(out["flow"])
    return out


def step_gaps(program: dict, reference, pressure_up_to_constant: bool) -> dict:
    """{field: gap} for the step's outputs present in both."""
    ref = as_fields(reference)
    out = {}
    for name in STEP_FIELDS:
        a, b = _field(program, name), _field(ref, name)
        if a is not None and b is not None:
            out[name] = rel_gap(a, b, up_to_constant=(name == "p" and pressure_up_to_constant))
    return out


def start_gap(program: dict, reference) -> float:
    """The largest gap over every field of the initial states."""
    ref = as_fields(reference)
    flat_p = dict(program.get("flow", {}), **{k: v for k, v in program.items() if k != "flow"})
    flat_r = dict(ref.get("flow", {}), **{k: v for k, v in ref.items() if k != "flow"})
    gaps = [rel_gap(flat_p[k], v) for k, v in flat_r.items() if v.dim() == 2]
    return max(gaps)
