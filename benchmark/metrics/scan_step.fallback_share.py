"""Fallback steps over all steps of the window's jobs, %, from the
program's own step counters (ops.scanstep: narrow, wide, fallback)."""


def read(record):
    c = record["counters"]
    steps = sum(c.get(k, 0) for k in ("narrow", "wide", "fallback"))
    return 100.0 * c.get("fallback", 0) / steps if steps else None
