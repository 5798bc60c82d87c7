"""Analytic solid shapes for immersed boundaries: a torch-free copy of
``fluidsolver_tpu.ib.geometry`` (numpy, at set-up).

The reference's geometry kit (src/Geometry.hpp:11-175): ``contains`` is
vectorized; ``intersect_line`` finds the wall intersection on a finite
segment (used only while the IB fields are built, so plain Python).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Circle:
    x: float
    y: float
    r: float

    def contains(self, px, py):
        return (px - self.x) ** 2 + (py - self.y) ** 2 <= self.r**2

    def normal(self, px, py):
        """Outward (solid -> fluid) normal at/near the boundary."""
        dx, dy = px - self.x, py - self.y
        n = np.hypot(dx, dy)
        n = n if n > 0 else 1.0
        return dx / n, dy / n

    def intersect_line(self, p1, p2):
        """Intersection of segment p1-p2 with the circle boundary
        (src/Geometry.hpp:55-133; Wolfram circle-line formula)."""
        (x1, y1), (x2, y2) = p1, p2
        x1 -= self.x; y1 -= self.y; x2 -= self.x; y2 -= self.y
        dx, dy = x2 - x1, y2 - y1
        dr2 = dx * dx + dy * dy
        det = x1 * y2 - x2 * y1
        inside = self.r**2 * dr2 - det * det
        if inside < 0:
            raise ValueError("segment does not intersect circle")
        sgn = -1.0 if dy < 0 else 1.0
        s = np.sqrt(inside)
        cands = [
            ((det * dy + sgn * dx * s) / dr2, (-det * dx + abs(dy) * s) / dr2),
            ((det * dy - sgn * dx * s) / dr2, (-det * dx - abs(dy) * s) / dr2),
        ]
        eps = 1e-8
        lo_x, hi_x = min(x1, x2) - eps, max(x1, x2) + eps
        lo_y, hi_y = min(y1, y2) - eps, max(y1, y2) + eps
        on = [lo_x <= cx <= hi_x and lo_y <= cy <= hi_y for cx, cy in cands]
        if not any(on):
            raise ValueError("no intersection on the finite segment")
        k = 0 if on[0] else 1
        return (cands[k][0] + self.x, cands[k][1] + self.y)


@dataclasses.dataclass(frozen=True)
class Rect:
    x: float
    y: float
    w: float
    h: float

    def contains(self, px, py):
        return (
            (self.x <= px) & (px <= self.x + self.w)
            & (self.y <= py) & (py <= self.y + self.h)
        )

    def intersect_line(self, p1, p2):
        """Single intersection of segment p1-p2 with the rectangle outline
        (src/Geometry.hpp:145-174)."""
        corners = [
            ((self.x, self.y), (self.x + self.w, self.y)),
            ((self.x, self.y + self.h), (self.x + self.w, self.y + self.h)),
            ((self.x, self.y), (self.x, self.y + self.h)),
            ((self.x + self.w, self.y), (self.x + self.w, self.y + self.h)),
        ]
        hits = []
        for b0, b1 in corners:
            p = _intersect_line_line(p1, p2, b0, b1)
            if p is not None:
                hits.append(p)
        if len(hits) != 1:
            raise ValueError(f"expected exactly one intersection, found {len(hits)}")
        return hits[0]


def _intersect_line_line(a0, a1, b0, b1, eps=1e-8):
    """Segment-segment intersection (src/Geometry.hpp:26-44)."""
    det = (a1[0] - a0[0]) * (b0[1] - b1[1]) - (a1[1] - a0[1]) * (b0[0] - b1[0])
    if abs(det) < eps:
        return None
    r = ((b0[1] - b1[1]) * (b0[0] - a0[0]) + (b1[0] - b0[0]) * (b0[1] - a0[1])) / det
    s = ((a0[1] - a1[1]) * (b0[0] - a0[0]) + (a1[0] - a0[0]) * (b0[1] - a0[1])) / det
    if not (-eps <= r <= 1 + eps) or not (-eps <= s <= 1 + eps):
        return None
    return (a0[0] + r * (a1[0] - a0[0]), a0[1] + r * (a1[1] - a0[1]))
