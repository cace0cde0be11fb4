"""The scan feed's rows/s alone (benchmark/probes/scan_feed.py)."""


def read(record):
    return record["probes"].get("scan_feed")
