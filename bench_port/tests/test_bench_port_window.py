"""The replayed window's step accounting and quantiles, on a toy clock."""

import statistics

from bench_port import window


class Toy:
    """A fake driver: each step advances the clock by the next duration."""

    def __init__(self, durations):
        self.t = 0.0
        self.durations = list(durations)
        self.n = 0
        self.restores = 0

    def clock(self):
        return self.t

    def restore(self):
        self.restores += 1
        self.t += 0.5   # the restore costs window time but no step's

    def run_block(self, after_step, steps=4):
        for k in range(steps):
            self.t += self.durations[self.n % len(self.durations)]
            self.n += 1
            after_step(k)


def test_window_counts_completed_steps_and_cuts_the_block_at_the_deadline():
    toy = Toy([1.0, 2.0, 3.0])
    win = window.run_window(toy.restore, toy.run_block, 20.0,
                            lambda b, k: {"syncs": 10 * b + k}, clock=toy.clock)
    # block 0: restore 0.5, steps end at 1.5, 3.5, 6.5, 7.5; block 1: restore
    # to 8.0, steps end at 10, 13, 14, 16; block 2: restore to 16.5, a step
    # ends at 19.5, the next at 20.5 is past the deadline
    assert [s.end for s in win.steps] == [1.5, 3.5, 6.5, 7.5, 10.0, 13.0, 14.0, 16.0, 19.5]
    assert [(s.block, s.index) for s in win.steps][-2:] == [(1, 3), (2, 0)]
    assert toy.restores == 3
    # the window's time runs to the last counted step, the three restores
    # (0.5 s each) included; each is recorded
    assert win.seconds == 19.5
    assert win.step_ms() == 1e3 * 19.5 / 9
    assert win.restores == [0.5, 0.5, 0.5] and win.restore_ms() == 500.0
    # a step's own time: the first of a block's from the end of the restore
    assert [s.seconds for s in win.steps][:5] == [1.0, 2.0, 3.0, 1.0, 2.0]
    # the blocks that ran to their end: (1 + 2 + 3 + 1) / 4, (2 + 3 + 1 + 2) / 4
    assert win.block_step_ms() == [1750.0, 2000.0]


def test_quantile_is_the_inclusive_percentile_of_every_step():
    toy = Toy([1.0] * 9 + [5.0])
    win = window.run_window(lambda: None, toy.run_block, 100.0, lambda b, k: {},
                            clock=toy.clock)
    times = [s.seconds for s in win.steps]
    want = statistics.quantiles(times, n=100, method="inclusive")[89]
    assert win.step_quantile_ms(0.9) == 1e3 * want
    # 7 cycles of ten steps (98 s), then two 1 s steps; the step ending at
    # 100 s exactly counts
    assert len(win.steps) == 72 and win.steps[-1].end == 100.0


def test_per_step_counters_skip_the_restore_between_blocks():
    toy = Toy([1.0])
    counts = iter(range(1000))

    def observe(block, k):
        # 3 reads a step, 50 more at each restore
        return {"syncs": 3 * next(counts) + 50 * block, "p_iter": k}

    win = window.run_window(lambda: None, toy.run_block, 12.0, observe, clock=toy.clock)
    assert win.per_step("syncs") == 3.0
    assert win.mean("p_iter") == statistics.mean(s.index for s in win.steps)
