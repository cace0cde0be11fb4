"""The scan's per-batch step (port of kmersgwas_tpu/ops/scanstep.py's
`scan_step_compact`).

`scan_step_compact` carries a buffered top-k state (the carried top-k, a
side buffer of candidates and the threshold `thresh`, the k-th score at
the last merge) in two candidate modes:
  cand_w — the score_topw kernel returns each column's top-W (score, lane)
           candidates and a guard (the single-process scan's step);
  cand_c — the score_tilemax kernel returns per-tile top-3 planes; the step
           keeps the c hottest tiles' candidates (the multi-process scan's
           step).

When every lane that could still enter the top-k (score > thresh) is
provably among the candidates, the step only appends them to the buffer
(the top q of them when the (q+1)-th is already <= thresh); otherwise it
recomputes the full scores with the score_bmax kernel and runs the exact
wide merge (`_flush_merge`). Exact by construction, with the reference
heap's tie rules: only a strictly greater score displaces, and the
earliest row wins among equals (the concatenation order state < buffer <
batch, then a stable sort).

Each `lax.cond` of the reference is a host branch here, decided from
device flags that one small device-to-host copy per step brings back; a
fallback step makes one more, for the exact merge's guards, which depend
on the fallback's scores. The state is a mutable object and is updated IN
PLACE (the buffer writes and the flushes replace or overwrite its
tensors); callers that need an old state copy it first.

`scan_step_compact` runs one batch deep: it queues batch i's candidate
kernel and its flags' copy to the host, and only then applies batch i-1
(waits for that batch's flags alone, then appends or falls back), so the
card scores batch i while the host decides batch i-1. Batch i stays
pending in the state (`BufferedTopKState.pending`) until the next step or
`settle`, which every reader of a state calls first (`flush_buffered`
does). Batch i's guards read the threshold as it stood when its kernel was
queued, before batch i-1's apply. That is still exact: the threshold only
rises (at a flush or a fallback), so a stale one is lower or equal, and
every lane above the true threshold is among the lanes the stale guard
covered; the narrow test `v[q] <= thresh` that holds for the stale one
holds for the true one. A stale threshold can only cost a wider append or
a fallback, never drop a row, and the final top-k is the one an apply
right after every kernel gives. A step's `counts` are added when its apply
runs.

The step's pieces are spans (utils.span): torch.profiler ranges
kgt::<name> while a profiler records, and the recorder's spans while
tracing is on. `scan_step_compact` holds `compact_candidates` (with K1's
`score_batch_t_topw` or K3's `score_batch_t_tilemax`, and the flags'
copy queued), then the previous batch's `step_flags` (the wait for its
flags on the host, the step's one wait) and `compact_apply`; a fallback
adds `score_batch_t_bmax`, then `_flush_merge` with its `top_k_from_bmax`
calls, inside `compact_apply` (chip_smoke.py's phase 4 splits a fallback
step's device time by the last three). `settle` runs the last two for a
pending batch wherever it is called. With tracing off a span enters no
profiler range.

Counters (utils.count): `step.deferred`, applies run by a later step,
with that step's candidate kernel already queued; `step.settled`, applies
run by `settle`; `step.stale`, deferred applies that flushed the buffer or
fell back, so rewrote the threshold that the queued kernel had already
read.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..utils import count, span, step_event
from . import score as score_ops
from . import topk as topk_ops


@dataclass
class PendingBatch:
    """A batch whose candidate kernel is queued and whose append or
    fallback has not run yet."""
    cands: tuple            # compact_candidates' (v, g, q, flags)
    flags: torch.Tensor     # (2, P) bool on the host (pinned on the card)
    event: object           # CUDA event behind the flags' copy; None on CPU
    batch: tuple            # packed, popcnt, row_lo, row_hi, y_padded, y_sum
    kw: dict                # compact_apply's keywords, counts included


@dataclass
class BufferedTopKState:
    scores: torch.Tensor    # (P, K) f32 descending (as of last flush)
    row_lo: torch.Tensor    # (P, K) int32
    row_hi: torch.Tensor    # (P, K) int32
    buf_v: torch.Tensor     # (P, C) f32 pending candidates
    buf_lo: torch.Tensor    # (P, C) int32
    buf_hi: torch.Tensor    # (P, C) int32
    buf_n: int              # filled buffer slots (host integer)
    thresh: torch.Tensor    # (P,) f32 k-th score at last flush
    # the batch scan_step_compact queued last, not yet applied (settle)
    pending: PendingBatch | None = field(default=None, repr=False)


# the fields the JAX package's BufferedTopKState has (checkpoints, convert)
STATE_FIELDS = ("scores", "row_lo", "row_hi", "buf_v", "buf_lo", "buf_hi",
                "buf_n", "thresh")


def init_buffered_state(n_phenotypes: int, k: int, buf_cap: int,
                        device) -> BufferedTopKState:
    def full(cols, value, dtype):
        return torch.full((n_phenotypes, cols), value, dtype=dtype,
                          device=device)
    return BufferedTopKState(
        scores=full(k, float("-inf"), torch.float32),
        row_lo=full(k, 0, torch.int32), row_hi=full(k, 0, torch.int32),
        buf_v=full(buf_cap, float("-inf"), torch.float32),
        buf_lo=full(buf_cap, 0, torch.int32),
        buf_hi=full(buf_cap, 0, torch.int32),
        buf_n=0,
        thresh=torch.full((n_phenotypes,), float("-inf"),
                          dtype=torch.float32, device=device))


def _top_merge(vs, los, his, k: int):
    """Stable top-k of the concatenated (value, lo, hi) parts: earlier
    parts win ties."""
    cat_v = torch.cat(vs, dim=1)
    nv, j = topk_ops.top_k(cat_v, k)
    return (nv, torch.cat(los, dim=1).gather(1, j),
            torch.cat(his, dim=1).gather(1, j))


def _clear_buffer(st: BufferedTopKState, rows=slice(None)) -> None:
    st.buf_v[rows] = float("-inf")
    st.buf_lo[rows] = 0
    st.buf_hi[rows] = 0


@span("_flush_merge")
def _flush_merge(scores, s_lo, s_hi, buf_v, buf_lo, buf_hi, sc, bmax,
                 row_lo, row_hi, cand_k: int, block: int = 16):
    """Exact wide merge of (state + buffer + this batch's scores) -> new
    (scores, row_lo, row_hi) (port of the reference's `_flush_merge`).

    Three extraction tiers: cand_k wide, max(4*cand_k, 8192) wide, and a
    full exact blocked top-k. A tier is exact for a column when the
    post-merge k-th strictly beats everything its extraction left behind.
    Both bmax tiers run and each column takes the narrower exact one; the
    columns neither covers, known from ONE device-to-host copy of the
    guards, take the full top-k."""
    k = scores.shape[1]
    r = sc.shape[1]
    last = row_lo.shape[0] - 1

    def merge_with(wv, wi, c=slice(None)):
        wi = wi.clamp(max=last)       # -inf pad lanes past R never survive
        return _top_merge([scores[c], buf_v[c], wv],
                          [s_lo[c], buf_lo[c], row_lo[wi]],
                          [s_hi[c], buf_hi[c], row_hi[wi]], k)

    out = done = None
    for width in sorted({min(cand_k, r), min(max(4 * cand_k, 8192), r)}):
        wv, wi, w_exact = topk_ops.top_k_from_bmax(sc, bmax, width)
        m = merge_with(wv, wi)
        ok = w_exact & (m[0][:, -1] > wv[:, -1]) if width < r else w_exact
        if out is None:
            out, done = m, ok
        else:                  # columns the narrower tier missed take this
            take = (ok & ~done)[:, None]
            out = tuple(torch.where(take, b, a) for a, b in zip(out, m))
            done = done | ok
    rest = torch.nonzero(~done.cpu()).flatten()       # the merge's one sync
    if len(rest):
        c = rest.to(sc.device)
        fv, fi = topk_ops.blocked_top_k(sc[c], k, block=block)
        for a, b in zip(out, merge_with(fv, fi, c)):
            a[c] = b
    return out


def _flush_state_only(st: BufferedTopKState) -> None:
    """Merge the candidate buffer into the carried top-k (no batch) and
    raise thresh to the new k-th score."""
    k = st.scores.shape[1]
    st.scores, st.row_lo, st.row_hi = _top_merge(
        [st.scores, st.buf_v], [st.row_lo, st.buf_lo],
        [st.row_hi, st.buf_hi], k)
    _clear_buffer(st)
    st.buf_n = 0
    st.thresh = st.scores[:, -1].clone()


def flush_buffered(st: BufferedTopKState) -> topk_ops.TopKState:
    """Settle `st`, then drain the candidate buffer -> plain TopKState (for
    finalize and checkpoints); `st` is otherwise left as it was."""
    settle(st)
    k = st.scores.shape[1]
    return topk_ops.TopKState(*_top_merge(
        [st.scores, st.buf_v], [st.row_lo, st.buf_lo],
        [st.row_hi, st.buf_hi], k))


def _tilemax_candidates(state: BufferedTopKState, packed, popcnt,
                        y_padded, y_sum, *, n_used: int, min_count: int,
                        tile_rows: int, cand_c: int, cand_c2: int | None,
                        precision: str):
    """`cand_c` mode: per column the top-3 of the c hottest tiles (only the
    top-1 of tiles ranked past c2) sorted by (value desc, lane asc), and
    the guard of kmersgwas_tpu/ops/scanstep.py:514-519. -> (v, g, okc)."""
    tmax, targ, tmax2, targ2, tmax3, targ3, n2, n3, cnt = \
        score_ops.score_batch_t_tilemax(
            packed, popcnt, y_padded, y_sum, state.thresh, n_used=n_used,
            min_count=min_count, tile_rows=tile_rows, precision=precision)
    p, n_tiles = tmax.shape
    c = min(cand_c, n_tiles)
    c2 = min(cand_c2, c) if cand_c2 else c
    th = state.thresh
    if c < n_tiles:
        v_all, ti = topk_ops.top_k(tmax, c + 1)
        v1, ti_c = v_all[:, :c], ti[:, :c]
        okc = v_all[:, c] <= th            # the excluded tiles are cold
    else:                                  # every tile kept
        v1, ti_c = topk_ops.top_k(tmax, c)
        okc = torch.ones(p, dtype=torch.bool, device=th.device)
    ti2 = ti_c[:, :c2]
    v2_full = tmax2.gather(1, ti_c)
    # the lanes are exact (no sum encoding), so every g is a real lane
    g = torch.cat([ti_c * tile_rows + targ.gather(1, ti_c),
                   ti2 * tile_rows + targ2.gather(1, ti2),
                   ti2 * tile_rows + targ3.gather(1, ti2)], dim=1)
    v, g = topk_ops.sort_desc_index_asc(
        torch.cat([v1, v2_full[:, :c2], tmax3.gather(1, ti2)], dim=1), g)
    th2 = th[:, None]
    okc = (okc & (cnt <= 3).all(dim=1)
           & ((tmax2 <= th2) | (n2 == 1)).all(dim=1)
           & ((tmax3 <= th2) | (n3 == 1)).all(dim=1))
    if c2 < c:              # kept tiles past rank c2 hold no hot 2nd lane
        okc = okc & (v2_full[:, c2:] <= th2).all(dim=1)
    return v, g, okc


@span("compact_candidates")
def compact_candidates(state: BufferedTopKState, packed, popcnt,
                       y_padded, y_sum, *, n_used: int, min_count: int,
                       tile_rows: int, cand_w: int | None = None,
                       cand_c: int | None = None,
                       cand_c2: int | None = None, cand_q: int | None = None,
                       precision: str = "default"):
    """Launch the candidate kernel and the guards -> (v, g, q, flags), all
    on the batch's device; flags (2, P) bool stacks okc (every hot lane is
    among the candidates) and the narrow test (the (q+1)-th candidate is
    cold; okc where there is no q). Every guard reads state.thresh as it
    stands now. Nothing here waits for the device."""
    rows = packed.shape[0]
    assert rows % tile_rows == 0
    if cand_w is not None:
        v, g, okc = score_ops.score_batch_t_topw(
            packed, popcnt, y_padded, y_sum, state.thresh, n_used=n_used,
            min_count=min_count, tile_rows=tile_rows, cand_w=cand_w,
            precision=precision)
        # candidates past the W-th are <= v[:, -1]: dropping them is exact
        # only when they are cold
        okc = okc & (v[:, -1] <= state.thresh)
    else:
        v, g, okc = _tilemax_candidates(
            state, packed, popcnt, y_padded, y_sum, n_used=n_used,
            min_count=min_count, tile_rows=tile_rows, cand_c=cand_c,
            cand_c2=cand_c2, precision=precision)
    width = v.shape[1]
    cap = state.buf_v.shape[1]
    assert cap % width == 0
    q = cand_q if cand_q and cand_q < width and cap % cand_q == 0 else None
    nar_c = v[:, q] <= state.thresh if q else okc
    return v, g, q, torch.stack([okc, nar_c])


@span("step_flags")
def step_flags(pend: PendingBatch) -> torch.Tensor:
    """A pending batch's flags on the host: waits for their copy alone
    (its event), not for the work queued behind it. The step's one wait."""
    if pend.event is not None:
        pend.event.synchronize()
    return pend.flags


@span("compact_apply")
def compact_apply(state: BufferedTopKState, cands, flags_host, packed,
                  popcnt, row_lo, row_hi, y_padded, y_sum, *, n_used: int,
                  min_count: int, cand_k: int, precision: str = "default",
                  col_group: int = 128, block: int = 16,
                  counts: dict | None = None) -> BufferedTopKState:
    """Given compact_candidates' (v, g, q, flags) and the flags on the
    host, append or fall back; updates `state` in place and returns it.
    The guards may have read an older, lower threshold than the state's
    (module docstring): the decision stays exact."""
    v, g, q, _ = cands
    cap = state.buf_v.shape[1]
    p = state.scores.shape[0]
    width = v.shape[1]
    okc_h, nar_h = flags_host[0].tolist(), flags_host[1].tolist()

    groups = [(g0, min(g0 + col_group, p)) for g0 in range(0, p, col_group)]
    qual = [all(okc_h[g0:g1]) for g0, g1 in groups]
    # the narrow decision is shared (appends advance buf_n in lockstep);
    # only qualifying groups constrain it
    narrow = bool(q) and all(all(nar_h[g0:g1])
                             for qg, (g0, g1) in zip(qual, groups) if qg)
    single = len(groups) == 1
    if single:                  # one group: the reference's r4 decision
        narrow = narrow and qual[0]
    incoming = q if narrow else width
    if state.buf_n + incoming > cap:
        _flush_state_only(state)
        _count(counts, "flush")

    fall = [gr for qg, gr in zip(qual, groups) if not qg]
    if fall:
        # hot groups: recompute their columns' full scores (one launch for
        # all of them; columns are independent) and run the exact wide
        # merge of state + buffer + batch; their pending candidates are
        # consumed, so their buffer rows are cleared
        cols = torch.cat([torch.arange(g0, g1) for g0, g1 in fall]).to(
            packed.device)
        sc, bmax = score_ops.score_batch_t_bmax(
            packed, popcnt, y_padded[:, cols], y_sum[cols], n_used=n_used,
            min_count=min_count, block=block, precision=precision)
        m_v, m_lo, m_hi = _flush_merge(
            state.scores[cols], state.row_lo[cols], state.row_hi[cols],
            state.buf_v[cols], state.buf_lo[cols], state.buf_hi[cols],
            sc, bmax, row_lo, row_hi, min(cand_k, sc.shape[1]), block)
        del sc, bmax
        state.scores[cols] = m_v
        state.row_lo[cols] = m_lo
        state.row_hi[cols] = m_hi
        _clear_buffer(state, cols)
        state.thresh[cols] = m_v[:, -1]
        if single:              # the merge consumed the whole buffer
            state.buf_n = 0
            _count(counts, "fallback")
            return state

    n0 = state.buf_n
    for qg, (g0, g1) in zip(qual, groups):
        if qg:
            gi = g[g0:g1, :incoming].long()
            state.buf_v[g0:g1, n0:n0 + incoming] = v[g0:g1, :incoming]
            state.buf_lo[g0:g1, n0:n0 + incoming] = row_lo[gi]
            state.buf_hi[g0:g1, n0:n0 + incoming] = row_hi[gi]
    state.buf_n = n0 + incoming
    _count(counts, "narrow" if all(qual) and narrow
           else "wide" if all(qual) else "fallback")
    return state


def compact_enqueue(state: BufferedTopKState, packed, popcnt, row_lo,
                    row_hi, y_padded, y_sum, *, n_used: int, min_count: int,
                    cand_k: int, tile_rows: int, cand_w: int | None = None,
                    cand_c: int | None = None, cand_c2: int | None = None,
                    cand_q: int | None = None, precision: str = "default",
                    col_group: int = 128, block: int = 16,
                    counts: dict | None = None) -> PendingBatch | None:
    """The first half of scan_step_compact: queue this batch's candidate
    kernel, its guards and its flags' copy to the host, make it the state's
    pending batch, and return the batch that was pending before it (None
    if none), whose apply is the caller's (apply_pending). Nothing here
    waits for the device, so a mesh can queue every shard's kernel before
    it applies any shard's previous batch."""
    cands = compact_candidates(
        state, packed, popcnt, y_padded, y_sum, n_used=n_used,
        min_count=min_count, tile_rows=tile_rows, cand_w=cand_w,
        cand_c=cand_c, cand_c2=cand_c2, cand_q=cand_q, precision=precision)
    flags = cands[3]
    host = flags.to("cpu", non_blocking=True)   # pinned, from the card
    prev, state.pending = state.pending, PendingBatch(
        cands, host, step_event(flags.device),
        (packed, popcnt, row_lo, row_hi, y_padded, y_sum),
        dict(n_used=n_used, min_count=min_count, cand_k=cand_k,
             precision=precision, col_group=col_group, block=block,
             counts=counts))
    return prev


def apply_pending(state: BufferedTopKState, pend: PendingBatch, *,
                  deferred: bool = True) -> BufferedTopKState:
    """Append or fall back for the pending batch `pend` (taken off the
    state by compact_enqueue or settle): wait for its flags, then
    compact_apply. deferred: a later batch's kernel is queued (counted
    `step.deferred`; `step.stale` too where this apply rewrote the
    threshold that kernel read), else a settle (`step.settled`)."""
    count("step.deferred" if deferred else "step.settled")
    step = {}
    compact_apply(state, pend.cands, step_flags(pend), *pend.batch,
                  **dict(pend.kw, counts=step))
    if deferred and ("flush" in step or "fallback" in step):
        count("step.stale")
    for key, n in step.items():
        _count(pend.kw["counts"], key, n)
    return state


def settle(state: BufferedTopKState) -> BufferedTopKState:
    """Apply the state's pending batch, if any: after this the state holds
    every batch stepped so far. Every reader of a BufferedTopKState calls
    it first (flush_buffered does)."""
    pend, state.pending = state.pending, None
    if pend is not None:
        apply_pending(state, pend, deferred=False)
    return state


@span("scan_step_compact")
def scan_step_compact(state: BufferedTopKState, packed, popcnt, row_lo,
                      row_hi, y_padded, y_sum, *, n_used: int,
                      min_count: int, cand_k: int, tile_rows: int,
                      cand_w: int | None = None, cand_c: int | None = None,
                      cand_c2: int | None = None, cand_q: int | None = None,
                      precision: str = "default", col_group: int = 128,
                      block: int = 16, counts: dict | None = None
                      ) -> BufferedTopKState:
    """One streamed batch -> the buffered top-k state, updated in place
    one batch late: this batch is queued and left pending, and the batch
    pending before it is applied (module docstring); `settle` applies the
    last.

    packed (R, W32) int32 planes, popcnt (R,) f32 (0 marks padding rows),
    row_lo/row_hi (R,) int32 encoded row ids, y_padded (N_pad, P) f32,
    y_sum (P,) f32, all on one device; the state keeps them until the
    batch is applied. R % tile_rows == 0; the buffer capacity must be a
    multiple of the candidate width.

    cand_w: `cand_w` mode with W = cand_w candidates per column. None
    selects `cand_c` mode: the top-3 of the min(cand_c, R/tile_rows)
    hottest tiles, of which only the cand_c2 hottest contribute their 2nd
    and 3rd lanes (default: all), so c + 2*c2 candidates per column.
    cand_q: narrow append width (used when it is < the width and divides
    the capacity): when the (q+1)-th candidate is already <= thresh only
    the top q are kept — the rest can never strictly beat the final k-th.
    col_group: the guards and the append/fallback decision run per group of
    <= col_group columns, so one hot column group falls back alone (the
    groups share buf_n; a fallen-back group's slot is left at -inf).
    counts: optional dict; the batch's apply adds 1 to "narrow", "wide" or
    "fallback" (any group fell back), and to "flush" when the buffer was
    merged before the append. The step is compact_enqueue, then
    apply_pending for the batch queued before."""
    prev = compact_enqueue(
        state, packed, popcnt, row_lo, row_hi, y_padded, y_sum,
        n_used=n_used, min_count=min_count, cand_k=cand_k,
        tile_rows=tile_rows, cand_w=cand_w, cand_c=cand_c, cand_c2=cand_c2,
        cand_q=cand_q, precision=precision, col_group=col_group, block=block,
        counts=counts)
    if prev is not None:
        apply_pending(state, prev)
    return state


def _count(counts: dict | None, key: str, n: int = 1) -> None:
    if counts is not None:
        counts[key] = counts.get(key, 0) + n
