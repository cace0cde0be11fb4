"""Multi-process association scan and kinship (port of kmersgwas_tpu/
parallel/multihost.py: `run_distributed_scan`, `run_distributed_kinship`
and the helpers they run).

Topology: one process per device. Process `pid` of `n_proc` owns
`torch.device("cuda", pid % torch.cuda.device_count())` (or the CPU) and
streams only its contiguous k-mer range of the sorted `.table`
(`host_row_span`), so table rows never cross processes. Each process runs
the `cand_c` scan step (ops/scanstep.scan_step_compact, score_tilemax
kernel) on its own batches and keeps its own buffered top-k state; states
meet once, at finalize (parallel/sharding.finalize_distributed).

The kinship driver streams each span into its own accumulator with no
collective until the end, where the (N, N) int64 totals and the row counts
are summed.

Every collective carries host data, so the transport is torch.distributed
with the gloo backend on CPU tensors: a had-data flag per step (the
dynamic lockstep), the final state gather, the pattern-hash union, the
tested-count sum and the kinship totals. Two processes may share one card.
"""
from __future__ import annotations

import atexit
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import formats
from ..core.table import KmersTableReader
from ..ops import _cuda
from ..ops import kinship as kin_ops
from ..ops import scanstep as ss
from ..ops import score as score_ops
from ..pipeline import checkpoint as ckpt
from ..pipeline import feed as feed_mod
from ..pipeline import kinship as kin_mod
from ..pipeline.scan import _PatternCounter
from ..utils import drain, require_device, step_event
from . import sharding as shard_mod

# the score_tilemax kernel's tile, on the card and on the CPU (the
# reference's 2048, multihost.py:282, is TPU tuning; its CPU path uses 128)
TILE_ROWS = _cuda.TILE_ROWS
_PREFETCH = 2


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the gloo process group at tcp://<coordinator_address> (host:port
    of process 0); a no-op for a single process. The group is left at
    exit, before the interpreter's teardown: a rank that exited with it
    still up was sometimes aborted there by its gloo threads
    (std::terminate, exit code -6) after its work had ended."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    atexit.register(_leave_process_group)


def _leave_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# copy of kmersgwas_tpu.parallel.multihost._bisect_col0_right
def _bisect_col0_right(mm: np.ndarray, stride: int, n_rows: int,
                       value: int) -> int:
    """searchsorted(..., side="right") on the k-mer column of a memmapped
    row-major table WITHOUT materializing the column: element-wise
    bisection touches only O(log n) pages."""
    value = np.uint64(value)
    lo, hi = 0, n_rows
    while lo < hi:
        mid = (lo + hi) // 2
        if mm[mid * stride] <= value:
            lo = mid + 1
        else:
            hi = mid
    return lo


# copy of kmersgwas_tpu.parallel.multihost.host_row_span
def host_row_span(table_base: str, host_id: int, n_hosts: int):
    """-> (start_row, end_row) of this host's contiguous k-mer range: the
    reference's range-partition boundaries (core/codec.step_bounds) as row
    spans of the sorted table, found by bisection over the memory-mapped
    k-mer column."""
    reader = KmersTableReader(table_base)
    if n_hosts <= 1:
        return 0, reader.n_rows_total
    lo_k, hi_k = shard_mod.host_range_of_kmer_space(host_id, n_hosts,
                                                    reader.header.kmer_len)
    mm = np.memmap(reader.base + ".table", dtype="<u8", mode="r",
                   offset=formats.TableHeader.HEADER_BYTES)
    stride = 1 + reader.header.row_words()
    n_rows = reader.n_rows_total
    start = _bisect_col0_right(mm, stride, n_rows, lo_k) if host_id else 0
    end = _bisect_col0_right(mm, stride, n_rows, hi_k)
    return start, end


# port of kmersgwas_tpu.parallel.multihost._span_dtable
def _span_dtable(table_base: str, cache_base: str, names_to_use,
                 min_count: int, n_used: int, pid: int, n_proc: int,
                 span_lo: int, span_hi: int, rebuild_stale: bool = True):
    """This process's .dtable cache of its span, built on first use. With
    several processes the file name carries the filter and the topology
    (`<base>.mc<min_count>.n<n_used>.p<pid>of<nproc>`), so a resized
    cluster builds fresh span caches instead of reading mis-spanned ones.
    rebuild_stale=False: an existing cache built for another filter or
    subset is left alone and None returned (the plain-named
    single-process cache may belong to another stage)."""
    from ..core import dtable as dt_mod
    my_cache = (f"{cache_base}.mc{min_count}.n{n_used}.p{pid}of{n_proc}"
                if n_proc > 1 else str(cache_base))
    used_names = (list(names_to_use) if names_to_use is not None
                  else formats.read_names(table_base))
    dt = dt_mod.open_cache(my_cache, min_count=min_count, n_used=n_used,
                           names_hash=dt_mod.names_hash_of(used_names))
    if dt is not None:
        return dt
    if os.path.exists(my_cache) and not rebuild_stale:
        return None
    dt_mod.build_dtable(table_base, my_cache, names_to_use=names_to_use,
                        min_count=min_count, start_row=span_lo,
                        end_row=span_hi)
    return dt_mod.DTableReader(my_cache)


def _union_patterns_across_processes(patterns, chunk: int = 1 << 22) -> int:
    """Global distinct count of the per-process pattern-hash sets (a set
    union: one pattern can occur in several spans). Bounded rounds, as in
    the reference: each round gathers one `chunk`-hash slice of every
    process's sorted array and merges it into a running union, so the extra
    host memory is O(n_proc * chunk * 8 B) plus the union. Hashes travel as
    int64 views of their uint64 bits."""
    local = patterns.sorted_hashes()
    lens = shard_mod.all_gather_np(np.array([len(local)], np.int64))[:, 0]
    mx = int(lens.max())
    merged = np.empty(0, np.uint64)
    for s in range(0, mx, chunk):
        width = min(chunk, mx - s)
        padded = np.zeros(width, np.uint64)
        take = local[s:s + width]
        padded[:len(take)] = take
        gathered = shard_mod.all_gather_np(padded.view(np.int64)).view(
            np.uint64)
        pieces = [gathered[i, :max(0, min(int(n) - s, width))]
                  for i, n in enumerate(lens)]
        merged = np.union1d(merged, np.concatenate(pieces))
    return len(merged)


def _any_has_data(flag: bool, n_proc: int) -> bool:
    if n_proc == 1:
        return flag
    return bool(shard_mod.all_gather_np(np.array([flag], np.int64)).any())


def run_distributed_scan(table_base: str, pheno_accessions, pheno_values,
                         pheno_names, *, kmer_len: int, device,
                         n_top: int = 10001, maf: float = 0.05, mac: int = 5,
                         batch_size: int = 2_000_000,
                         first_phenotype_top: int | None = None,
                         count_patterns: bool = False,
                         dtable_cache: str | None = None,
                         score_precision: str = "default",
                         checkpoint_path: str | None = None,
                         checkpoint_every: int = 20, progress=None):
    """The multi-process scan: every process calls this in lockstep after
    init_distributed(). Returns (per_pheno, n_tested, n_patterns): per
    phenotype the exact merged (scores f64 desc, rows int64), the same on
    every process; the global MAC-passing count; the global distinct-pattern
    count (None unless count_patterns).

    Arguments as kmersgwas_tpu.parallel.multihost.run_distributed_scan, with
    `device` ("cuda" or "cpu"; "cuda" without a card raises) in place of
    use_pallas. On the card every batch goes through the score_tilemax
    kernel and every exact fallback through score_bmax; on the CPU the same
    step runs their plain versions.

    The step count is dynamic: before each step the processes gather a
    had-data flag and stop once every stream is exhausted; a process whose
    span ran out steps on empty padded batches until then, so step counts
    and checkpoint cadence stay equal everywhere.

    checkpoint_path: per-process checkpoints `<path>.p<pid>.npz` of the
    buffered state (leading device axis 1) and the span position, stamped
    with a topology fingerprint; a resume under another topology, or of a
    checkpoint holding several devices' states, is refused."""
    n_proc, pid = shard_mod.world()
    dev = require_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", pid % torch.cuda.device_count())

    reader = KmersTableReader(table_base, names_to_use=pheno_accessions)
    n_used = reader.n_used
    min_count = max(int(mac), math.ceil(n_used * maf))
    if min_count < 1:
        raise ValueError("min_count must be >= 1 (zero-popcount marks padding)")
    n_pad = reader.w32 * 32
    pheno_values = np.asarray(pheno_values)
    p = pheno_values.shape[1]
    k_eff = max(n_top, first_phenotype_top or 0)
    patterns = _PatternCounter() if count_patterns else None

    # the reference's step parameters (multihost.py:285-295) with one
    # device per process: a device shard is the whole local batch
    local_rows = -(-max(batch_size // n_proc, 1) // TILE_ROWS) * TILE_ROWS
    cand_c = min(256, k_eff, max(1, local_rows // TILE_ROWS))
    cand_k = min(max(cand_c, k_eff // 8), k_eff, local_rows)
    cand_q = 64
    cand_c2 = 64 if cand_c >= 64 else None
    buf_cap = (cand_c + 2 * (cand_c2 or cand_c)) * 16

    my_lo, my_hi = host_row_span(table_base, pid, n_proc)
    stream_tag = "dtable" if dtable_cache else "table"
    meta = {"n_proc": n_proc, "span_lo": my_lo, "span_hi": my_hi,
            "table_rows": reader.n_rows_total, "k_eff": k_eff,
            "n_pheno": p, "n_used": n_used}
    dt = None
    if dtable_cache:
        dt = _span_dtable(table_base, dtable_cache, pheno_accessions,
                          min_count, n_used, pid, n_proc, my_lo, my_hi)

    state = ss.init_buffered_state(p, k_eff, buf_cap, dev)
    span_start = 0 if dt is not None else my_lo
    start_row, n_tested_local = span_start, 0
    my_ckpt = f"{checkpoint_path}.p{pid}.npz" if checkpoint_path else None
    if my_ckpt:
        resumed = ckpt.load_distributed_state(my_ckpt, stream_tag, meta, dev)
        if resumed is not None:
            # the buffer is merged into the carried top-k: exact, whatever
            # buffer width the writer used
            st, start_row, n_tested_local = resumed
            state.scores, state.row_lo, state.row_hi = ss.flush_buffered(st)
            state.thresh = state.scores[:, -1].clone()
            start_row = max(start_row, span_start)
    yp, ysum = score_ops.prepare_phenotypes(pheno_values, n_pad, dev)

    want = patterns is not None
    if dt is not None:
        feed = feed_mod.dtable_feed(dt, local_rows, start_row=start_row,
                                    want_patterns=want)
    else:
        feed = feed_mod.table_feed(reader, local_rows, local_rows, min_count,
                                   start_row=start_row, end_row=my_hi,
                                   want_patterns=want)
    batches = feed_mod.device_batches(feed, dev, local_rows, reader.w32,
                                      depth=_PREFETCH)
    empty = None
    next_pos = start_row
    step_i = 0
    while True:
        item = next(batches, None)
        r = item[0] if item is not None else 0
        if not _any_has_data(r > 0, n_proc):
            break
        if item is None:            # this span is done; others are not
            if empty is None:
                empty = (torch.zeros((local_rows, reader.w32),
                                     dtype=torch.int32, device=dev),
                         torch.zeros(local_rows, device=dev),
                         torch.zeros(local_rows, dtype=torch.int32,
                                     device=dev),
                         torch.zeros(local_rows, dtype=torch.int32,
                                     device=dev))
            batch = empty
        else:
            _, batch, next_pos, pats = item
            n_tested_local += r
            if pats is not None:
                patterns.add(pats)
        ss.scan_step_compact(
            state, *batch, yp, ysum, n_used=n_used, min_count=min_count,
            cand_k=cand_k, tile_rows=TILE_ROWS, cand_c=cand_c,
            cand_c2=cand_c2, cand_q=cand_q, precision=score_precision)
        step_i += 1
        if my_ckpt and step_i % checkpoint_every == 0:
            ckpt.save_distributed_state(my_ckpt, state, next_pos,
                                        n_tested_local, stream_tag, meta)
        if progress is not None:
            progress(r)
    # the step bounds the dispatch: it waits on the flags of the batch
    # before it, so the host is never more than one batch ahead of the
    # card; the last batch's kernel ends before the gather
    drain([step_event(dev)])

    per_pheno = shard_mod.finalize_distributed(state)
    caps = [first_phenotype_top if (j == 0 and first_phenotype_top)
            else n_top for j in range(p)]
    per_pheno = [(sc[:cap], rw[:cap]) for (sc, rw), cap in zip(per_pheno,
                                                               caps)]
    n_patterns = None
    if patterns is not None:
        n_patterns = (_union_patterns_across_processes(patterns)
                      if n_proc > 1 else patterns.count)
    n_tested = (int(shard_mod.all_gather_np(
        np.array([n_tested_local], np.int64)).sum())
        if n_proc > 1 else n_tested_local)
    return per_pheno, n_tested, n_patterns


def run_distributed_kinship(table_base: str, *, device, maf: float = 0.05,
                            batch_size: int = 1 << 20, names_to_use=None,
                            dtable_cache: str | None = None,
                            checkpoint_path: str | None = None,
                            checkpoint_every: int = 50, progress=None):
    """Multi-process kinship: every process calls this after
    init_distributed(). Each process streams only its contiguous k-mer
    range (host_row_span), over its span dtable when `dtable_cache` is
    given, into its own accumulator on its own device (`device` "cuda" or
    "cpu"; "cuda" without a card raises); the (N, N) int64 totals and the
    row counts are summed across processes at the end (integer sums: the
    reference's f64 sum is exact below 2^53, so the matrix is the same).
    Returns the normalized kinship, identical on every process.

    checkpoint_path: per-process checkpoints `<path>.p<pid>` of the total
    and the span position, stamped with the topology (n_proc, span_lo,
    span_hi, table_rows, n_used); a crashed process resumes from its last
    save while the others rerun, and a resume under another topology is
    refused.

    Reference: kmersgwas_tpu/parallel/multihost.py:438-549,
    src/emma_kinship_kmers.cpp:77-111."""
    n_proc, pid = shard_mod.world()
    dev = require_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", pid % torch.cuda.device_count())
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    n_used = reader.n_used
    min_count = math.ceil(n_used * maf)
    my_lo, my_hi = host_row_span(table_base, pid, n_proc)
    acc = kin_ops.KinshipAccumulator(n_used=n_used, n_pad=reader.w32 * 32,
                                     device=dev)
    dt = None
    if dtable_cache:
        dt = _span_dtable(table_base, dtable_cache, names_to_use, min_count,
                          n_used, pid, n_proc, my_lo, my_hi,
                          rebuild_stale=n_proc > 1)
    stream = "dtable" if dt is not None else "table"
    my_ckpt = f"{checkpoint_path}.p{pid}" if checkpoint_path else None
    meta = {"n_proc": n_proc, "span_lo": my_lo, "span_hi": my_hi,
            "table_rows": reader.n_rows_total, "n_used": n_used}
    span_start = 0 if dt is not None else my_lo
    start_row = span_start
    if my_ckpt:
        resumed = ckpt.load_kinship_state(my_ckpt, stream=stream, meta=meta)
        if resumed is not None:
            acc.total, acc.n_rows, start_row = resumed
            start_row = max(start_row, span_start)
    items = (kin_mod.dtable_planes(dt, batch_size, start_row=start_row)
             if dt is not None else
             kin_mod.table_planes(reader, batch_size, min_count,
                                  start_row=start_row, end_row=my_hi))
    kin_mod.accumulate_stream(acc, items, dev, batch_size=batch_size,
                              w32=reader.w32, checkpoint_path=my_ckpt,
                              checkpoint_every=checkpoint_every,
                              stream=stream, meta=meta, progress=progress)
    acc.flush()
    total, n_rows = acc.total, acc.n_rows
    if n_proc > 1:
        total = shard_mod.all_gather_np(total).sum(axis=0)
        n_rows = int(shard_mod.all_gather_np(
            np.array([n_rows], np.int64)).sum())
    return kin_ops.normalize(total, n_rows)
