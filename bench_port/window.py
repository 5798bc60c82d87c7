"""The measured window: one fixed block of driver steps, replayed.

Set-up keeps the state S at the block's start. The window restores a
fresh copy of S, runs ``block_steps`` driver steps, and repeats until
``seconds`` have passed, so every side of a comparison times the same steps
of the same flow. A step counts when it completed before the deadline; the
block in progress is cut there. Each driver step ends in the driver's one
host copy of its observed values, so the host clock after a step is the
end of a completed step.

The window's time runs from its start to the end of its last counted
step, the restores between blocks (a collection of the program's cyclic
garbage and a copy of S) included: ``step_ms`` is that time over the
counted steps. A step's own time, which the quantiles read, runs from the
end of the step before it in its block, or from the end of the block's
restore.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


class Deadline(Exception):
    """Raised from a step's callback once the window has closed."""


@dataclasses.dataclass
class Step:
    block: int
    index: int        # the step's place in its block
    seconds: float    # host clock from the previous step's end (or the restore)
    end: float        # host clock at the step's end
    counters: dict    # what ``observe`` read after the step


@dataclasses.dataclass
class Window:
    steps: list
    start: float = 0.0                                 # host clock at the window's start
    restores: list = dataclasses.field(default_factory=list)   # each restore's seconds

    @property
    def seconds(self) -> float:
        """From the window's start to the end of its last counted step,
        the restores included."""
        return self.steps[-1].end - self.start if self.steps else 0.0

    def step_ms(self) -> float:
        """The window's seconds over its counted steps, in ms."""
        return 1e3 * self.seconds / len(self.steps)

    def restore_ms(self) -> Optional[float]:
        """The mean time of a restore, in ms."""
        return 1e3 * sum(self.restores) / len(self.restores) if self.restores else None

    def block_step_ms(self) -> list:
        """The mean of the steps' own times in each block that ran to its
        end, in ms: how far the pace drifts within one run."""
        blocks: dict = {}
        for s in self.steps:
            blocks.setdefault(s.block, []).append(s.seconds)
        full = max((len(v) for v in blocks.values()), default=0)
        return [1e3 * sum(v) / len(v) for v in blocks.values() if len(v) == full]

    def step_quantile_ms(self, q: float) -> float:
        """The ``q`` quantile (0 < q < 1, in hundredths) of every step's time, in ms."""
        cut = statistics.quantiles([s.seconds for s in self.steps], n=100, method="inclusive")
        return 1e3 * cut[round(100 * q) - 1]

    def per_step(self, key: str) -> Optional[float]:
        """Mean change of a cumulative counter over the steps that follow
        another step of their block (the first step of a block follows a
        restore, whose reads are the harness's)."""
        diffs = [b.counters[key] - a.counters[key] for a, b in zip(self.steps, self.steps[1:])
                 if a.block == b.block]
        return sum(diffs) / len(diffs) if diffs else None

    def mean(self, key: str) -> Optional[float]:
        vals = [s.counters[key] for s in self.steps]
        return sum(vals) / len(vals) if vals else None


def run_window(restore: Callable[[], None], run_block: Callable[[Callable[[int], None]], None],
               seconds: float, observe: Callable[[int, int], dict],
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Replay the block until ``seconds`` have passed.

    ``restore()`` puts a fresh copy of the block's start in place;
    ``run_block(after_step)`` runs the block's steps and calls
    ``after_step(k)`` after the k-th has completed; ``observe(block, k)``
    returns the counters to keep for that step and may keep more itself."""
    start = clock()
    deadline = start + seconds
    steps: list = []
    restores: list = []
    block = 0
    try:
        while True:
            t0 = clock()
            restore()
            last = clock()
            restores.append(last - t0)

            def after_step(k: int) -> None:
                nonlocal last
                now = clock()
                if now > deadline:
                    raise Deadline
                steps.append(Step(block, k, now - last, now, observe(block, k)))
                last = now

            run_block(after_step)
            block += 1
    except Deadline:
        pass
    return Window(steps, start, restores)
