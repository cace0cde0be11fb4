"""The host's reads of the bed in the traced job, s: the program's spans
`kgt::bed_read` (snps.bed.load_bed_planes, one a chunk), summed, as the
profiler recorded them."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::bed_read")
