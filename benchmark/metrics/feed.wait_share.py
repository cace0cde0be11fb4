"""The share of the traced job the consumer waited on the feed, %: the
program's span `kgt::feed_wait` (pipeline.feed `_prefetch`, the main
thread's wait for a staged batch) over the job's length."""


def read(record):
    tr = record.get("trace")
    if tr is None or tr.window_s <= 0 or "kgt::feed_wait" not in tr.host_s:
        return None
    return 100.0 * tr.host_s["kgt::feed_wait"] / tr.window_s
