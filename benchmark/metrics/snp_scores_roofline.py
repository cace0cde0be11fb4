"""The SNP arm's score work's share of its roofline in the traced job, %:
the least time the card needs for the job's score work
(benchmark/metrics/snp_scores_bound.py) over the summed device time of
everything the traced job launched (the bed's decode and the sort
included)."""
from benchmark.metrics import snp_scores_bound


def read(record):
    tr, pk, w = record.get("trace"), record.get("peaks"), record["work"]
    if tr is None or pk is None:
        return None
    dev_s = tr.device_total_s()
    if dev_s <= 0:
        return None
    least_ms, _ = snp_scores_bound.bound_ms(pk, w["rows"], w["n_used"],
                                            w["p"], w["w32"])
    return 100.0 * least_ms * 1e-3 / dev_s
