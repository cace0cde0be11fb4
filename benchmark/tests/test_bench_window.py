"""The window's rate: all the rows of the window's jobs over its whole
length; a stalled step lowers it."""
import pytest

from benchmark.window import run_window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _jobs(clock, step_s, steps=10, rows=1000):
    def job(i):
        for s in range(steps):
            clock.t += step_s(i, s)
        return steps * rows
    return job


def test_rate_is_rows_over_the_whole_window():
    c = Clock()
    win = run_window(_jobs(c, lambda i, s: 0.1), 2.5, clock=c)
    # jobs of 1 s: the third ends at 3 s, past 2.5 s
    assert len(win.jobs) == 3 and win.seconds == pytest.approx(3.0)
    assert win.rows == 30_000 and win.rate == pytest.approx(10_000)


def test_a_stalled_step_lowers_the_rate():
    c = Clock()
    base = run_window(_jobs(c, lambda i, s: 0.1), 10, clock=c).rate
    c = Clock()
    stall = run_window(_jobs(c, lambda i, s: 2.0 if (i, s) == (3, 4)
                             else 0.1), 10, clock=c).rate
    assert stall < base * 0.9


def test_a_slow_ramp_counts():
    c = Clock()
    ramp = run_window(_jobs(c, lambda i, s: 0.3 if s < 2 else 0.1), 10,
                      clock=c)
    assert ramp.rate == pytest.approx(10_000 / 1.4)


def test_the_window_needs_a_length():
    with pytest.raises(ValueError):
        run_window(lambda i: 1, 0)
