"""The SNP kinship's share of its roofline in the traced job, %: the least
time the card needs for the job's work (benchmark/metrics/
snp_kinship_bound.py) over the summed device time of everything the
traced job launched (the upload and the decode included)."""
from benchmark.metrics import snp_kinship_bound


def read(record):
    tr, pk, w = record.get("trace"), record.get("peaks"), record["work"]
    if tr is None or pk is None:
        return None
    dev_s = tr.device_total_s()
    if dev_s <= 0:
        return None
    least_ms, _ = snp_kinship_bound.bound_ms(pk, w["rows"], w["n"])
    return 100.0 * least_ms * 1e-3 / dev_s
