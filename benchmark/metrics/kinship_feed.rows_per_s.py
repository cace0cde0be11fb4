"""The kinship feed's rows/s alone (benchmark/probes/kinship_feed.py)."""


def read(record):
    return record["probes"].get("kinship_feed")
