"""The SNP arm's planes in the traced job, s: the program's span
`kgt::snp_load_planes` (snps.bed.load_bed_planes: every chunk of the bed
read, uploaded, decoded, reordered, counted and packed) as the profiler
recorded it."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::snp_load_planes")
