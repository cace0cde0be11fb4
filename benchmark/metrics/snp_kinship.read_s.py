"""The host's reads of the bed in the SNP kinship's traced job, s: the
program's spans `kgt::bed_read` (snps.kinship.emma_kinship_from_bed, one
a chunk), summed, as the profiler recorded them. None on a program
without them."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::bed_read")
