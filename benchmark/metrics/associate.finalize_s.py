"""Median over the window's jobs of associate's finalize (the states to the
host and their merge), its own host-clock span
`ScanResult.timings["finalize"]` (pipeline.scan)."""
import statistics


def read(record):
    v = record["spans"].get("associate.finalize")
    return statistics.median(v) if v else None
