"""Median host time of one scan step over the window's jobs, ms: the
benchmark's clock around `scan_step_compact` in the fresh cells
(benchmark/drivers/fresh_scan.py), the program's own span of each batch,
`ScanResult.steps["step_s"]` (pipeline.scan), in the table cells."""
import statistics


def read(record):
    v = record["spans"].get("scan_step")
    return 1e3 * statistics.median(v) if v else None
