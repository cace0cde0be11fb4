"""The scan's per-batch step, `cand_w` mode (port of kmersgwas_tpu/ops/
scanstep.py `scan_step_compact` with `cand_w`, :379-476, and the buffered
state it carries).

Per batch, the score_topw kernel returns each column's top-W (score, lane)
candidates and a guard. When every lane that could still enter the top-k
(score > thresh, the k-th score at the last merge) is provably among them,
the step only appends the candidates to a side buffer (the top q of them
when the (q+1)-th is already <= thresh); otherwise it recomputes the full
scores with the score_bmax kernel and runs the exact wide merge. Exact by
construction, with the reference heap's tie rules: only a strictly greater
score displaces, and the earliest row wins among equals (the concatenation
order state < buffer < batch, then a stable sort).

Each `lax.cond` of the reference is a host branch here, decided from
device flags that one small device-to-host copy per step brings back; a
fallback step makes one more, for the exact merge's guards, which depend
on the fallback's scores. The state is a mutable object and is updated IN
PLACE (the buffer writes and the flushes replace or overwrite its
tensors); callers that need an old state copy it first.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import score as score_ops
from . import topk as topk_ops


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
    """Drain the candidate buffer -> plain TopKState (for finalize and
    checkpoints); `st` is left as it was."""
    k = st.scores.shape[1]
    return topk_ops.TopKState(*_top_merge(
        [st.scores, st.buf_v], [st.row_lo, st.buf_lo],
        [st.row_hi, st.buf_hi], k))


def scan_step_compact(state: BufferedTopKState, packed, popcnt, row_lo,
                      row_hi, y_padded, y_sum, *, n_used: int,
                      min_count: int, cand_k: int, tile_rows: int,
                      cand_w: int, cand_q: int | None = None,
                      precision: str = "default", col_group: int = 128,
                      block: int = 16, counts: dict | None = None
                      ) -> BufferedTopKState:
    """One streamed batch -> the buffered top-k state, updated in place.

    packed (R, W32) int32 planes, popcnt (R,) f32 (0 marks padding rows),
    row_lo/row_hi (R,) int32 encoded row ids, y_padded (N_pad, P) f32,
    y_sum (P,) f32, all on one device. R % tile_rows == 0; the buffer
    capacity must be a multiple of cand_w.

    cand_q: narrow append width (used when it is < cand_w and divides the
    capacity): when the (q+1)-th candidate is already <= thresh only the
    top q are kept — the rest can never strictly beat the final k-th.
    col_group: the guards and the append/fallback decision run per group of
    <= col_group columns, so one hot column group falls back alone (the
    groups share buf_n; a fallen-back group's slot is left at -inf).
    counts: optional dict; the step adds 1 to "narrow", "wide" or
    "fallback" (any group fell back), and to "flush" when the buffer was
    merged before the append."""
    cap = state.buf_v.shape[1]
    rows = packed.shape[0]
    p = state.scores.shape[0]
    width = cand_w
    assert rows % tile_rows == 0 and cap % width == 0
    q = cand_q if cand_q and cand_q < width and cap % cand_q == 0 else None

    v, g, okc = score_ops.score_batch_t_topw(
        packed, popcnt, y_padded, y_sum, state.thresh, n_used=n_used,
        min_count=min_count, tile_rows=tile_rows, cand_w=cand_w,
        precision=precision)
    # candidates past the W-th are <= v[:, -1]: dropping them is exact
    # only when they are cold
    okc = okc & (v[:, -1] <= state.thresh)
    nar_c = v[:, q] <= state.thresh if q else okc
    flags = torch.stack([okc, nar_c]).cpu()           # the step's one sync
    okc_h, nar_h = flags[0].tolist(), flags[1].tolist()

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


def _count(counts: dict | None, key: str) -> None:
    if counts is not None:
        counts[key] = counts.get(key, 0) + 1
