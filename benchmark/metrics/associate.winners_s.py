"""associate's union of the winners' rows (the concatenation and its
np.unique) in the traced job, s: the program's span
`kgt::associate_winners` (pipeline.scan) as the profiler recorded it."""


def read(record):
    tr = record.get("trace")
    return None if tr is None else tr.host_s.get("kgt::associate_winners")
