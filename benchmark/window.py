"""The measured window: whole jobs back to back, and the rate over them.

A job is what a user runs: a fresh state, the job's batches, the result
taken to the host. The window opens as the first job starts and closes as
the first job that ends at or after `seconds` ends, so it holds whole jobs
only: every ramp, flush and finalize a job pays is inside it, and where the
window closes in a job's cycle does not move the rate (a cut-off job whose
rows are counted by its finished steps moves it by up to one job's rows, a
tenth of the window's in the dtable cells). The end-to-end rate is all the
rows the window's jobs finished over the window's whole length.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class Window:
    start: float                       # clock at the first job's start
    end: float                         # clock at the last job's end
    jobs: list = field(default_factory=list)   # (start, end, rows)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def rows(self) -> int:
        return sum(r for _, _, r in self.jobs)

    @property
    def rate(self) -> float:
        """Rows of the window's jobs over the window's whole length."""
        return self.rows / self.seconds


def run_window(job: Callable[[int], int], seconds: float,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Run job(0), job(1), ... back to back (each returns the rows it
    finished, its result taken) until one ends at or after `seconds` from
    the start."""
    if seconds <= 0:
        raise ValueError(f"seconds ({seconds}) must be positive")
    t0 = clock()
    win = Window(start=t0, end=t0)
    while True:
        s = clock()
        rows = int(job(len(win.jobs)))
        e = clock()
        win.jobs.append((s, e, rows))
        win.end = e
        if e - t0 >= seconds:
            return win
