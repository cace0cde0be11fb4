"""The SNP kinship in the traced job, s: the program's span
`kgt::snp_kinship` (snps.kinship.emma_kinship_from_bed: every chunk of the
bed read, decoded and multiplied, and the matrix to the host) as the
profiler recorded it. None on a program without it."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::snp_kinship")
