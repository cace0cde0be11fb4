"""Median over the traced job's batches of staging one batch into the
pinned ring, ms: the program's spans `ring_wait` (the slot's previous copy
to the card) plus `ring_copy` (the pinned copy) of each batch
(pipeline.feed `PinnedRing.stage`, on the prefetch thread), from the
program's recorder, which the traced job filled."""
import statistics


def read(record):
    try:
        from kmersgwas_tpu_torch import utils
    except ImportError:
        return None
    if not hasattr(utils, "last_trace") or record.get("trace") is None:
        return None
    tr = utils.last_trace()
    waits, copies = (sorted(tr.named(n), key=lambda s: s.start_ns)
                     for n in ("ring_wait", "ring_copy"))
    per = [w.seconds + c.seconds for w, c in zip(waits, copies)]
    return 1e3 * statistics.median(per) if per else None
