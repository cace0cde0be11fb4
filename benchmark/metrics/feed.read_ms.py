"""Median over the traced job's batches of the feed's read of one batch,
ms: the program's span `feed_read` (pipeline.feed `_prefetch`, the feed
generator's next on the prefetch thread), from the program's recorder,
which the traced job filled. The read past the last batch is left out."""
import statistics


def read(record):
    try:
        from kmersgwas_tpu_torch import utils
    except ImportError:
        return None
    if not hasattr(utils, "last_trace") or record.get("trace") is None:
        return None
    tr = utils.last_trace()
    reads = sorted(tr.named("feed_read"), key=lambda s: s.start_ns)
    reads = reads[:tr.counters.get("feed.batches", 0)]
    return 1e3 * statistics.median(s.seconds for s in reads) if reads \
        else None
