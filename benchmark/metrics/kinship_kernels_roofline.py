"""The Gram work's share of its roofline in the traced job, %: the least
time the card needs for the job's Gram work (benchmark/roofline.py
gram_bound_ms: 2 rows N (N + 1) / 2 int8 operations against the rows'
planes read once) over the summed device time of everything the job
launched but the benchmark's generator (`benchgen::`)."""
from benchmark import roofline


def read(record):
    tr, pk, w = record.get("trace"), record.get("peaks"), record["work"]
    if tr is None or pk is None:
        return None
    dev_s = tr.device_total_s(exclude="benchgen::")
    if dev_s <= 0:
        return None
    least_ms, _ = roofline.gram_bound_ms(pk, w["rows_per_job"], w["n_used"],
                                         w["w32"])
    return 100.0 * least_ms * 1e-3 / dev_s
