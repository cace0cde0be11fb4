"""Association scan driver: stream the k-mers table through the device
(port of kmersgwas_tpu/pipeline/scan.py, single process).

End-to-end equivalent of the `associate_kmers` binary
(src/associate_kmers.cpp): batches of MAC-filtered k-mers stream from the
table (or its .dtable cache) to the card, where one scan step per batch
(ops/scanstep.scan_step_compact, `cand_w` mode) scores every phenotype
column and keeps the per-column top-k; the winners' rows are then fetched
by random access into the table, with no second pass.

Winner naming matches the reference bim convention: `<kmer>_<rank>` where
rank 1 = best score, and bed rows are written in table-row order.

The numpy helpers below the driver are copies of the JAX package's
(kmersgwas_tpu/pipeline/scan.py imports jax at its top); each names its
original.
"""
from __future__ import annotations

import math
import os
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from kmersgwas_tpu.core import codec, formats
from kmersgwas_tpu.core.table import KmersTableReader

from ..ops import _cuda
from ..ops import scanstep as ss
from ..ops import score as score_ops
from ..ops import topk as topk_ops
from ..utils import StageTimer, drain, require_device, step_event
from . import checkpoint as ckpt
from . import feed as feed_mod

# scan-step parameters. The tile is the score_topw kernel's 128-row tile,
# on the card and on the CPU alike (one code path; the reference's
# 4096/2048 split, kmersgwas_tpu/pipeline/scan.py:257-266, is TPU tuning).
# cand_w, the buffer capacity, cand_q and the cand_k formula are the
# reference's (:279-285).
TILE_ROWS = _cuda.TILE_ROWS
CAND_W = 256
BUF_CAP = 12288              # lcm(256, 64) * 48
CAND_Q = 64
# bounded dispatch: wait for the step from _INFLIGHT batches ago before
# starting another, so queued batches' inputs cannot pile up (a 400M-row
# scan of the JAX package was OOM-killed without this bound)
_INFLIGHT = 4
_PREFETCH = 2


# copy of kmersgwas_tpu.pipeline.scan.ScanResult, plus `steps`
@dataclass
class ScanResult:
    names: list                     # phenotype column names
    scores: list                    # per phenotype: (K,) float64 descending
    rows: list                      # per phenotype: (K,) int64 table rows
    kmers: list                     # per phenotype: (K,) uint64 codes
    n_tested: int                   # MAC-passing k-mers scored
    n_patterns: int | None = None   # unique presence/absence patterns
    pa_rows: object = field(default_factory=dict)  # RowLookup: row -> packed
                                    # uint64 PA words over the used columns
    timings: dict = field(default_factory=dict)  # sub-stage seconds: stream
                                    # (feed+dispatch loop), finalize (state
                                    # fetch + merge), fetch (winner rows)
    certified: list | None = None   # certify_topk: per-column bool — True
                                    # = the selected set is PROVEN equal to
                                    # the exact-score top-k (certify_column)
    steps: dict = field(default_factory=dict)    # scan-step branch counts
                                    # (narrow/wide/fallback/flush) and
                                    # per-batch host seconds (step_s)


# copy of kmersgwas_tpu.pipeline.scan.CERTIFY_BAND / CERTIFY_EPS
CERTIFY_BAND = 1024      # extra top-k slots carried for certify_topk
CERTIFY_EPS = 4e-3       # relative score-error bound assumed of the default
                         # (bf16-product) precision


# copy of kmersgwas_tpu.pipeline.scan.certify_column
def certify_column(def_scores, rows, exact_scores, cap: int,
                   eps: float = CERTIFY_EPS):
    """Exact-selection certificate for one phenotype column.

    The scan selected `rows` (top-(cap+B) by DEFAULT-precision scores,
    descending `def_scores`); `exact_scores` are their f64 re-scores.
    Returns (order, certified): `order` selects the exact top-`cap` among
    the carried candidates, ranked by (exact score desc, row asc);
    `certified` is True iff that set is PROVEN equal to the global
    exact-score top-cap (any row not carried has default score <= t =
    def_scores[-1], hence exact score <= t*(1+eps))."""
    m = len(rows)
    order = np.lexsort((np.asarray(rows), -np.asarray(exact_scores)))
    if m <= cap:
        return order, True
    t = float(def_scores[-1])
    s_star = float(exact_scores[order[cap - 1]])
    return order[:cap], s_star > t * (1.0 + eps)


# copy of kmersgwas_tpu.pipeline.scan.effective_min_count
def effective_min_count(n_accessions: int, maf: float, mac: int) -> int:
    """max(mac, ceil(maf * n)) — associate_kmers.cpp:98-102."""
    return max(int(mac), math.ceil(n_accessions * maf))


# copy of kmersgwas_tpu.pipeline.scan._prefetch
def _prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread, buffering `depth` items, so
    host-side batch prep overlaps device compute."""
    import queue
    import threading
    q = queue.Queue(maxsize=depth)
    _END = object()
    err = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:   # propagate into the consumer
            err.append(e)
        finally:
            q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]


# copy of kmersgwas_tpu.pipeline.scan._PatternCounter
class _PatternCounter:
    """Streaming distinct-pattern counter (pattern hash per row, merged
    sets), equivalent of update_presence_absence_pattern_counter
    (kmers_multiple_databases.cpp:377-380); merges are deferred so the
    total merge work is O(U log U)."""

    def __init__(self):
        self._sorted = np.empty(0, dtype=np.uint64)
        self._pending: list = []
        self._pending_n = 0

    def add(self, packed_u32: np.ndarray) -> None:
        w64 = np.ascontiguousarray(packed_u32).view("<u8")
        h = np.unique(codec.pattern_hash(w64))
        self._pending.append(h)
        self._pending_n += len(h)
        if self._pending_n >= max(1 << 20, len(self._sorted) >> 2):
            self._compact()

    def _compact(self) -> None:
        if self._pending:
            self._sorted = np.unique(
                np.concatenate([self._sorted, *self._pending]))
            self._pending = []
            self._pending_n = 0

    @property
    def count(self) -> int:
        self._compact()
        return len(self._sorted)


def associate(table_base: str, pheno_accessions, pheno_values: np.ndarray,
              pheno_names, *, kmer_len: int, device, n_top: int = 10001,
              maf: float = 0.05, mac: int = 5, batch_size: int = 2_000_000,
              first_phenotype_top: int | None = None,
              count_patterns: bool = False,
              checkpoint_path: str | None = None, checkpoint_every: int = 20,
              dtable_cache: str | None = None, mesh=None,
              score_precision: str = "default",
              certify_topk: bool = False, progress=None) -> ScanResult:
    """Scan the full table; returns per-phenotype top-k with k-mer codes.

    Arguments as kmersgwas_tpu.pipeline.scan.associate, plus `device`
    ("cuda" or "cpu", required: "cuda" without a card raises). On the card
    every batch goes through the score_topw kernel and every exact fallback
    through score_bmax; on the CPU the same step runs their plain versions.

    pheno_values: (n_accessions, P) TRANSFORMED phenotype columns.
    first_phenotype_top: a larger k for column 0 (--first_phenotype_best).
    dtable_cache: path of a device-native pre-packed table
    (core/dtable.py), built on first use; batches then stream as raw
    memmap slices, and checkpoints hold exact dtable row positions.
    score_precision: "default" (y rounded to bf16, exact 0/1 bits, f32
    sums) or "highest" (f32).
    certify_topk: carry CERTIFY_BAND extra slots, re-score every carried
    candidate exactly in f64 at finalize, re-rank by (exact score desc,
    row asc) and prove per column that the set is the exact-score top-k.
    mesh: multi-device scans are not ported; passing one raises."""
    if mesh is not None:
        raise NotImplementedError(
            "kmersgwas_tpu_torch runs single-device scans only")
    dev = require_device(device)
    reader = KmersTableReader(table_base, names_to_use=pheno_accessions)
    n_used = reader.n_used
    min_count = effective_min_count(n_used, maf, mac)
    n_pad = reader.w32 * 32
    p = pheno_values.shape[1]
    k_eff = max(n_top, first_phenotype_top or 0) \
        + (CERTIFY_BAND if certify_topk else 0)
    if min_count < 1:
        raise ValueError("min_count must be >= 1 (zero-popcount marks padding)")
    yp, ysum = score_ops.prepare_phenotypes(pheno_values, n_pad, dev)
    patterns = _PatternCounter() if count_patterns else None

    stream_tag = "dtable" if dtable_cache else "table"
    ckpt_meta = {"table_rows": reader.n_rows_total, "n_used": n_used,
                 "min_count": min_count, "k_eff": k_eff, "n_pheno": p}
    n_tested = 0
    start_row = 0
    state = ss.init_buffered_state(p, k_eff, BUF_CAP, dev)
    if checkpoint_path:
        resumed = ckpt.load_scan_state(checkpoint_path, meta=ckpt_meta)
        if resumed is not None and resumed[3] == stream_tag:
            plain, start_row, n_tested = resumed[:3]
            state.scores = torch.from_numpy(
                np.asarray(plain.scores, np.float32)).to(dev)
            state.row_lo = torch.from_numpy(
                np.asarray(plain.row_lo, np.int32)).to(dev)
            state.row_hi = torch.from_numpy(
                np.asarray(plain.row_hi, np.int32)).to(dev)
            state.thresh = state.scores[:, -1].clone()
    # every batch is padded to one shape; padding rows carry popcnt == 0
    # and score -inf inside the step
    pad_to = -(-batch_size // TILE_ROWS) * TILE_ROWS
    cand_k = min(max(256, k_eff // 8), k_eff, pad_to)

    dt = None
    if dtable_cache:
        from ..core import dtable as dt_mod
        nhash = dt_mod.names_hash_of(reader.names)
        dt = dt_mod.open_cache(dtable_cache, min_count=min_count,
                               n_used=n_used, names_hash=nhash)
        if dt is None:   # absent, legacy, or a different filter/subset
            dt_mod.build_dtable(table_base, dtable_cache,
                                names_to_use=pheno_accessions,
                                min_count=min_count)
            dt = dt_mod.DTableReader(dtable_cache)
        # checkpoint positions are EXACT dtable row indices, so a resume
        # re-tests nothing (a re-appended row would take two slots)
        prepared = feed_mod.dtable_feed(dt, pad_to, start_row=start_row,
                                        want_patterns=patterns is not None)
    else:
        batches = ((b.packed, b.popcnt, b.row_index) for b
                   in reader.iter_batches(batch_size, min_count,
                                          start_row=start_row))

        def prepare(args):
            """Host-side batch prep (runs on the prefetch thread): pad to
            the fixed batch shape and pre-encode row ids."""
            b_packed, b_popcnt, b_rows = args
            r = len(b_rows)
            packed = np.zeros((pad_to, reader.w32), np.uint32)
            packed[:r] = b_packed
            popcnt = np.zeros(pad_to, np.float32)
            popcnt[:r] = b_popcnt
            rows = np.zeros(pad_to, np.int64)
            rows[:r] = b_rows
            lo, hi = topk_ops.encode_rows(rows)
            pats = np.asarray(b_packed) if patterns is not None else None
            pos_after = int(b_rows[-1]) + 1 if r else -1   # -1: keep prior
            return r, packed, popcnt, lo, hi, pos_after, pats

        prepared = map(prepare, batches)

    ring = (feed_mod.PinnedRing(_PREFETCH + 2, pad_to, reader.w32)
            if dev.type == "cuda" else None)

    def stage(item):
        """Prefetch thread: the batch into a pinned staging buffer (card)
        or into CPU tensors."""
        r, packed, popcnt, lo, hi, pos_after, pats = item
        arrays = (packed, popcnt, lo, hi)
        staged = ring.stage(*arrays) if ring else feed_mod.host_tensors(
            *arrays)
        return r, staged, pos_after, pats

    timings = {}
    steps = {"narrow": 0, "wide": 0, "fallback": 0, "flush": 0,
             "step_s": []}
    timer = StageTimer("scan", "kmers", quiet=progress is not None)
    t_stream = time.perf_counter()
    next_pos = start_row
    batch_i = 0
    inflight: deque = deque()
    for r, staged, pos_after, pats in _prefetch(map(stage, prepared),
                                                depth=_PREFETCH):
        t_step = time.perf_counter()
        n_tested += r
        if pats is not None:
            patterns.add(pats)
        packed, popcnt, lo, hi = (ring.upload(staged, dev) if ring
                                  else staged)
        ss.scan_step_compact(
            state, packed, popcnt, lo, hi, yp, ysum, n_used=n_used,
            min_count=min_count, cand_k=cand_k, tile_rows=TILE_ROWS,
            cand_w=CAND_W, cand_q=CAND_Q, precision=score_precision,
            counts=steps)
        inflight.append(step_event(dev))
        if len(inflight) > _INFLIGHT:
            drain(inflight.popleft())
        steps["step_s"].append(time.perf_counter() - t_step)
        batch_i += 1
        if pos_after >= 0:
            next_pos = pos_after
        if checkpoint_path and batch_i % checkpoint_every == 0:
            ckpt.save_scan_state(checkpoint_path, ss.flush_buffered(state),
                                 next_pos, n_tested, stream=stream_tag,
                                 meta=ckpt_meta)
        timer.add(r)
        if progress is not None:
            progress(r)
    while inflight:
        drain(inflight.popleft())
    timer.done()
    timings["stream"] = time.perf_counter() - t_stream

    t_fin = time.perf_counter()
    per_pheno = topk_ops.finalize(ss.flush_buffered(state))
    timings["finalize"] = time.perf_counter() - t_fin

    # resolve winner rows -> k-mer codes + packed PA: chunked-run reads from
    # the dtable (pre-squeezed) when present, else the raw table (pass 2)
    t_fetch = time.perf_counter()
    all_rows = np.unique(np.concatenate([rw for _, rw in per_pheno])
                         ) if per_pheno and any(len(rw) for _, rw in per_pheno) else np.empty(0, np.int64)
    kmer_of_row, pa_of_row = fetch_rows(reader, all_rows.astype(np.int64),
                                        dt=dt)
    timings["fetch"] = time.perf_counter() - t_fetch

    names = list(pheno_names)
    scores_out, rows_out, kmers_out = [], [], []
    certified = [] if certify_topk else None
    if certify_topk:
        t_cert = time.perf_counter()
        # the oracle scores what the scan scored: the f32-cast phenotypes,
        # re-accumulated in f64
        yv = np.asarray(pheno_values, np.float32).astype(np.float64)
        ysums = yv.sum(axis=0)
    for j, (sc, rw) in enumerate(per_pheno):
        cap = first_phenotype_top if (j == 0 and first_phenotype_top) else n_top
        if certify_topk:
            pa = np.asarray(pa_of_row.take(rw))
            bits = np.unpackbits(np.ascontiguousarray(pa).view(np.uint8),
                                 axis=1, bitorder="little"
                                 )[:, :n_used].astype(np.float64)
            n_f = float(n_used)
            n1 = bits.sum(axis=1)
            r_ = n_f * (bits @ yv[:, j]) - n1 * ysums[j]
            denom = n_f * n1 - n1 * n1
            with np.errstate(divide="ignore", invalid="ignore"):
                s_ex = np.where(denom > 0, r_ * r_ / denom, 0.0)
            order, cert = certify_column(sc, rw, s_ex, cap)
            certified.append(bool(cert))
            sc, rw = s_ex[order], np.asarray(rw)[order]
        else:
            sc, rw = sc[:cap], rw[:cap]
        scores_out.append(sc)
        rows_out.append(rw)
        kmers_out.append(np.asarray(kmer_of_row.take(rw), dtype=np.uint64))
    if certify_topk:
        timings["certify"] = time.perf_counter() - t_cert

    return ScanResult(names=names, scores=scores_out, rows=rows_out,
                      kmers=kmers_out, n_tested=n_tested,
                      n_patterns=(patterns.count if patterns else None),
                      pa_rows=pa_of_row, timings=timings,
                      certified=certified, steps=steps)


# copy of kmersgwas_tpu.pipeline.scan.RowLookup
class RowLookup:
    """Vectorized row -> value map over SORTED row keys.

    Replaces the per-row Python dict build (and per-item lookups) of the
    winner-fetch stage: construction is O(1) (the arrays are stored as-is),
    bulk access is one searchsorted + gather (`take`), and scalar
    `lookup[row]` stays dict-compatible for stragglers."""

    __slots__ = ("rows", "values")

    def __init__(self, rows: np.ndarray, values: np.ndarray):
        self.rows = np.asarray(rows, np.int64)      # sorted ascending
        self.values = values

    def take(self, rows) -> np.ndarray:
        """Values for an array of row ids (each must be present)."""
        rows = np.asarray(rows, np.int64)
        if len(rows) == 0:
            return self.values[:0]
        i = np.searchsorted(self.rows, rows)
        if (i >= len(self.rows)).any() or (self.rows[np.minimum(
                i, len(self.rows) - 1)] != rows).any():
            missing = rows[(i >= len(self.rows))
                           | (self.rows[np.minimum(i, len(self.rows) - 1)]
                              != rows)]
            raise KeyError(int(missing[0]))
        return self.values[i]

    def __getitem__(self, row):
        return self.take(np.asarray([row]))[0]

    def __len__(self):
        return len(self.rows)

    def __contains__(self, row):
        i = np.searchsorted(self.rows, int(row))
        return i < len(self.rows) and int(self.rows[i]) == int(row)


# copy of kmersgwas_tpu.pipeline.scan._pread_gather
def _pread_gather(path: str, base_offset: int, row_bytes: int,
                  rows: np.ndarray, workers: int = 32) -> np.ndarray:
    """Gather `rows` (sorted unique) of a fixed-record file as a
    (len(rows), row_bytes) uint8 array.

    Two regimes, chosen by disk economics (a memmap fancy-index
    page-faults inside numpy's copy loop WITH the GIL held — queue depth
    1; the measurements behind the choice are the JAX package's, see its
    copy of this function):
      * DENSE (covering span < ~5 KB/requested row): bounded-chunk
        sequential streaming of the span + in-memory gather — the
        reference's pass-2 pattern (src/associate_kmers.cpp:178-191);
      * SPARSE: one positioned read per row across `workers` threads
        (os.preadv releases the GIL)."""
    rows = np.asarray(rows, np.int64)
    out = np.empty((len(rows), row_bytes), np.uint8)
    if len(rows) == 0:
        return out
    fd = os.open(str(path), os.O_RDONLY)

    def pread_into(mv, off: int) -> None:
        got = 0
        while got < len(mv):                  # pread may return short
            r = os.preadv(fd, [mv[got:]], off + got)
            if r <= 0:
                raise EOFError(f"short read at offset {off}")
            got += r

    try:
        span_bytes = (int(rows[-1]) + 1 - int(rows[0])) * row_bytes
        # regime choice by disk economics: one random row costs one
        # ~4K IO, sequential
        # streaming runs at full bandwidth — so bulk-read the covering span
        # whenever it is smaller than ~5 KB per requested row, else issue
        # per-row parallel reads
        if span_bytes <= len(rows) * 5000:
            # DENSE: stream the covering span in bounded chunks (the
            # reference's sequential pass-2 pattern,
            # src/associate_kmers.cpp:178-191) and gather in memory
            chunk_rows = max(1, (64 << 20) // row_bytes)
            pos = 0
            scratch = np.empty((chunk_rows, row_bytes), np.uint8)
            while pos < len(rows):
                c_lo = int(rows[pos])
                c_hi = min(c_lo + chunk_rows, int(rows[-1]) + 1)
                pos2 = int(np.searchsorted(rows, c_hi))
                take = pos2 - pos
                blk = scratch[: c_hi - c_lo]
                pread_into(memoryview(blk).cast("B"),
                           base_offset + c_lo * row_bytes)
                out[pos:pos2] = blk[rows[pos:pos2] - c_lo]
                pos = pos2
        else:
            # SPARSE: one positioned read per row, straight into the output
            # row, fanned across threads (os.preadv releases the GIL, so
            # `workers` IOs stay in flight; a memmap fancy-index faults at
            # queue depth 1)
            off0 = base_offset
            rb = row_bytes

            def work(t: int) -> None:
                for i in range(t, len(rows), workers):
                    pread_into(memoryview(out[i]).cast("B"),
                               off0 + int(rows[i]) * rb)

            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(workers) as ex:
                list(ex.map(work, range(workers)))
    finally:
        os.close(fd)
    return out


# copy of kmersgwas_tpu.pipeline.scan.fetch_rows
def fetch_rows(reader: KmersTableReader, rows: np.ndarray, dt=None):
    """Fetch winner table rows -> (RowLookup kmers, RowLookup packed-PA).

    PA values are squeezed used-column uint64 words (ceil(n_used/64)),
    ready for PLINK export. `rows` must be sorted unique absolute .table
    row indices.

    dt: optional core.dtable.DTableReader already holding the same
    accession subset — winners are then resolved from the dtable's
    pre-squeezed planes (no raw-table reads, no squeeze work), keyed back
    through its src_rows section."""
    rows = np.asarray(rows, np.int64)
    n64 = (reader.n_used + 63) // 64
    if len(rows) == 0:
        empty = RowLookup(rows, np.empty((0, n64), "<u8"))
        return RowLookup(rows, np.empty(0, np.uint64)), empty
    from kmersgwas_tpu.core import table as table_mod
    if dt is not None and table_mod._native_squeeze_available():
        # raw route wins with the native squeeze: 1 IO/row + a C pass vs
        # the dtable's 2 sections (planes + kmers) at 2 IOs/row
        dt = None
    if dt is not None:
        src = dt.src_rows
        idx = np.searchsorted(src, rows)
        if (idx < len(src)).all() and \
                (np.asarray(src[np.minimum(idx, len(src) - 1)]) == rows).all():
            kmers = _pread_gather(dt.path, dt.kmers.offset, 8,
                                  idx).view("<u8")[:, 0]
            w32 = dt.hdr.w32
            planes = _pread_gather(dt.path, dt.planes.offset, w32 * 4, idx)
            pa = planes.view("<u8")[:, :n64]
            return (RowLookup(rows, kmers.astype(np.uint64)),
                    RowLookup(rows, np.ascontiguousarray(pa)))
        # else: dtable doesn't cover these rows (stale) — fall through
    wf = reader.header.row_words()
    raw = _pread_gather(reader.base + ".table",
                        formats.TableHeader.HEADER_BYTES, (1 + wf) * 8,
                        rows).view("<u8")
    from kmersgwas_tpu.core import table as table_mod
    if table_mod._native_squeeze_available():
        from kmersgwas_tpu import native
        _, packed_all, _, _ = native.squeeze_pack(
            raw, reader.file_col, reader.n_used, reader.w32, 0)
        pa = np.ascontiguousarray(packed_all).view("<u8")[:, :n64].copy()
    else:
        # chunked squeeze: the one-shot bit-extract materializes an
        # (n, n_used) uint64 intermediate (~8 GB per 1M winners at 1008
        # accessions) — bound it
        pa = np.empty((len(rows), n64), "<u8")
        step = 1 << 15
        for s in range(0, len(rows), step):
            bits = reader.squeeze_bits(raw[s:s + step])
            padded = np.zeros((len(bits), n64 * 64), dtype=np.uint8)
            padded[:, : reader.n_used] = bits
            pa[s:s + step] = np.packbits(padded, axis=1,
                                         bitorder="little").view("<u8")
    return (RowLookup(rows, raw[:, 0].astype(np.uint64)),
            RowLookup(rows, pa))


# copy of kmersgwas_tpu.pipeline.scan.export_plink
def export_plink(result: ScanResult, reader_n_used: int, kmer_len: int,
                 base_names: list) -> None:
    """Write per-phenotype bed/bim winner exports, reference-compatible:
    rows in table order, names `<kmer>_<rank>` with rank 1 = best.
    Vectorized per column: one decode + one stacked bed write."""
    for j, base in enumerate(base_names):
        rows = result.rows[j]
        scores = result.scores[j]
        # rank by descending score (stable), 1-based
        rank = np.empty(len(rows), dtype=np.int64)
        rank[np.argsort(-scores, kind="stable")] = np.arange(1, len(rows) + 1)
        order = np.argsort(rows, kind="stable")       # table-row output order
        with formats.BedBimWriter(base) as w:
            if len(order) == 0:
                continue
            kstrs = codec.decode_kmers(
                np.asarray(result.kmers[j], np.uint64)[order], kmer_len)
            names = [f"{ks}_{rank[idx]}" for ks, idx in zip(kstrs, order)]
            pa = np.asarray(result.pa_rows.take(
                np.asarray(rows)[order]))
            w.write_variants(names, pa, reader_n_used)
