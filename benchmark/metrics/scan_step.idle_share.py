"""The share of the traced job in which the device idled inside the scan
step, %: the idle time (benchmark/trace.py) under the program's range
`kgt::scan_step_compact` and every range that opens only inside it (the
step's halves, its flags copy, the kernels' wrappers, a fallback's merge),
over the job's length."""

STEP = ("scan_step_compact", "compact_candidates", "step_flags",
        "compact_apply", "score_batch_t_topw", "score_batch_t_tilemax",
        "score_batch_t_bmax", "_flush_merge", "top_k_from_bmax")


def read(record):
    tr = record.get("trace")
    if tr is None or tr.window_s <= 0 \
            or "kgt::scan_step_compact" not in tr.host_s:
        return None
    return 100.0 * sum(tr.idle_s.get("kgt::" + n, 0.0)
                       for n in STEP) / tr.window_s
