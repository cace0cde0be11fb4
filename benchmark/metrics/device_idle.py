"""The share of the traced job in which no operation ran on the device, %,
from the profiler's timeline (benchmark/trace.py)."""


def read(record):
    tr = record.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
