"""The SNP arm's selection in the traced job, s: the program's span
`kgt::snp_topn` (snps.assoc.most_associated_snps: each column's sort and
its top-N indices to the host) as the profiler recorded it."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::snp_topn")
