"""Median over the window's jobs of associate's winner fetch, its own
host-clock span `ScanResult.timings["fetch"]` (pipeline.scan)."""
import statistics


def read(record):
    v = record["spans"].get("associate.fetch")
    return statistics.median(v) if v else None
