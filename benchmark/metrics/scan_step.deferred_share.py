"""The share of the traced job's scan-step applies that ran one batch
late, behind the next batch's candidate kernel already queued, %: the
program's counters `step.deferred` and `step.settled` (ops.scanstep), from
its recorder, which the traced job filled. None on a program without
them."""


def read(record):
    try:
        from kmersgwas_tpu_torch import utils
    except ImportError:
        return None
    if not hasattr(utils, "last_trace") or record.get("trace") is None:
        return None
    c = utils.last_trace().counters
    deferred = c.get("step.deferred", 0)
    n = deferred + c.get("step.settled", 0)
    return 100.0 * deferred / n if n else None
