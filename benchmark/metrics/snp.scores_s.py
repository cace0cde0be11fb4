"""The SNP arm's scores in the traced job, s: the program's span
`kgt::snp_scores` (snps.assoc.snp_scores, every column's GRAMMAR-Gamma
score of every SNP) as the profiler recorded it."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::snp_scores")
