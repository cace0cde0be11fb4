"""The port's multi-process scan (kmersgwas_tpu_torch.parallel.multihost and
the `associate-mp` CLI) against the JAX package on the CPU.

One process: `run_distributed_scan(device="cpu")` must give the rows,
scores, tested count and pattern count of the reference's
`run_distributed_scan` (on conftest's 8-device mesh: the final top-k is
exact whatever the topology) and of its `associate`, on both routes, and
must resume a mid-stream checkpoint to the uninterrupted result. Several
processes: `associate-mp --device cpu` over gloo on 127.0.0.1 must write
the bytes the one-process run writes. Checkpoints cross between the
packages, and a mesh's checkpoint is refused. Phenotypes are dyadic, so
scores are exact in any summation order."""
import filecmp
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from kmersgwas_tpu.core import formats
from kmersgwas_tpu.parallel import multihost as jmh
from kmersgwas_tpu.pipeline import scan as jscan
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.parallel import multihost, sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(kmer_len=15, n_top=15, maf=0.05, mac=2, batch_size=64)


def dyadic(rng, shape):
    return np.round(rng.uniform(-8, 8, size=shape) * 8) / 8


def write_table(path, seed, rows, n, kmer_len=15, kmers=None):
    """Sorted random k-mers (or `kmers`) with random presence bits (the
    fixtures of tests/test_multiprocess.py) -> (base, names, rng)."""
    rng = np.random.default_rng(seed)
    names = [f"a{i}" for i in range(n)]
    if kmers is None:
        kmers = np.sort(rng.choice(1 << (2 * kmer_len), size=rows,
                                   replace=False)).astype(np.uint64)
    bits = rng.integers(0, 2, size=(len(kmers), n)).astype(np.uint8)
    padded = np.zeros((len(kmers), 64), dtype=np.uint8)
    padded[:, :n] = bits
    pa = np.packbits(padded, axis=1, bitorder="little").view("<u8")
    base = str(path / "pop")
    formats.write_names(base, names)
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        formats.write_table_rows(f, kmers, pa)
    return base, names, rng


def assert_same_top(got, want):
    assert len(got) == len(want)
    for (gs, gr), (ws, wr) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("route,extra", [
    ("table", dict(first_phenotype_top=20, count_patterns=True)),
    ("dtable", dict(count_patterns=True)),
])
def test_single_process_matches_jax(tmp_path, route, extra):
    base, names, rng = write_table(tmp_path, 81, 3000, 20)
    y = dyadic(rng, (20, 2))
    kw = dict(KW, **extra)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "c.dtable")
    got, n_got, pat_got = multihost.run_distributed_scan(
        base, names, y, ["a", "b"], device="cpu", **kw)
    want, n_want, pat_want = jmh.run_distributed_scan(
        base, names, y, ["a", "b"], **kw)
    assert (n_got, pat_got) == (n_want, pat_want)
    assert_same_top(got, want)
    kw.pop("dtable_cache", None)
    ref = jscan.associate(base, names, y, ["a", "b"], **kw)
    assert (n_got, pat_got) == (ref.n_tested, ref.n_patterns)
    assert_same_top(got, list(zip(ref.scores, ref.rows)))


class _Interrupt(Exception):
    pass


def _bomb_at(n):
    calls = []

    def progress(_r):
        calls.append(_r)
        if len(calls) == n:
            raise _Interrupt
    return progress


def test_checkpoint_resume_and_refusals(tmp_path, monkeypatch):
    """A run interrupted mid-stream resumes to the uninterrupted result
    (exact n_tested: nothing re-tested); another config's checkpoint, a
    mesh's checkpoint and `device="cuda"` without a card are refused."""
    base, names, rng = write_table(tmp_path, 91, 3000, 20)
    y = dyadic(rng, (20, 2))
    full = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                          device="cpu", **KW)
    ck = str(tmp_path / "ck")
    kw = dict(KW, checkpoint_path=ck, checkpoint_every=1)
    with pytest.raises(_Interrupt):
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       device="cpu", progress=_bomb_at(3),
                                       **kw)
    mid = np.load(ck + ".p0.npz")
    assert mid["scores"].shape[0] == 1 and 0 < int(mid["n_tested"])
    assert int(mid["next_row"]) < 3000
    per, nt, _ = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                                device="cpu", **kw)
    assert nt == full[1]
    assert_same_top(per, full[0])
    with pytest.raises(ValueError, match="refusing to resume"):
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       device="cpu", **dict(kw, n_top=12))
    # the JAX package on conftest's 8-device mesh: 8 states in one file
    ck8 = str(tmp_path / "ck8")
    jmh.run_distributed_scan(base, names, y, ["a", "b"], checkpoint_path=ck8,
                             checkpoint_every=1, **KW)
    assert np.load(ck8 + ".p0.npz")["scores"].shape[0] == 8
    with pytest.raises(ValueError, match="refusing to resume"):
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       device="cpu", checkpoint_path=ck8,
                                       **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                       device="cuda", **KW)


# a JAX process with one device (the port's topology): run the reference
# driver with a checkpoint, optionally interrupted after `stop` steps
_JAX_RUN = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) == 1
    from kmersgwas_tpu.parallel import multihost
    base, ck, out, stop = sys.argv[1:5]
    z = np.load(out + ".in.npz")
    calls = []
    def progress(r):
        calls.append(r)
        if len(calls) == int(stop):
            raise SystemExit(3)
    per, nt, _ = multihost.run_distributed_scan(
        base, [str(a) for a in z["names"]], z["y"], ["a", "b"], kmer_len=15,
        n_top=15, maf=0.05, mac=2, batch_size=64, checkpoint_path=ck,
        checkpoint_every=1, progress=progress)
    np.savez(out, s0=per[0][0], r0=per[0][1], s1=per[1][0], r1=per[1][1],
             nt=nt)
""")


def _jax_one_device(base, ck, out, names, y, stop):
    np.savez(out + ".in.npz", names=np.array(names), y=y)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=1",
               PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", _JAX_RUN, base, ck, out,
                           str(stop)], env=env, capture_output=True,
                          text=True, timeout=180)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    base, names, rng = write_table(tmp_path, 95, 2000, 20)
    y = dyadic(rng, (20, 2))
    full = multihost.run_distributed_scan(base, names, y, ["a", "b"],
                                          device="cpu", **KW)
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out")
    if writer == "jax":
        proc = _jax_one_device(base, ck, out, names, y, stop=4)
        assert proc.returncode == 3, proc.stderr[-3000:]
        per, nt, _ = multihost.run_distributed_scan(
            base, names, y, ["a", "b"], device="cpu", checkpoint_path=ck,
            **KW)
    else:
        with pytest.raises(_Interrupt):
            multihost.run_distributed_scan(
                base, names, y, ["a", "b"], device="cpu", checkpoint_path=ck,
                checkpoint_every=1, progress=_bomb_at(4), **KW)
        proc = _jax_one_device(base, ck, out, names, y, stop=0)
        assert proc.returncode == 0, proc.stderr[-3000:]
        z = np.load(out + ".npz")
        per, nt = [(z["s0"], z["r0"]), (z["s1"], z["r1"])], int(z["nt"])
    assert nt == full[1]
    assert_same_top(per, full[0])


def test_union_patterns_chunked_rounds(monkeypatch):
    """The bounded-round pattern union (tests/test_multiprocess.py:743):
    exact over several chunk rounds, skewed set sizes and an empty
    process, with a simulated 3-process gather."""
    rng = np.random.default_rng(3)
    locals_ = [np.unique(rng.integers(0, 1 << 63, size=size,
                                      dtype=np.uint64) | (1 << 63))
               for size in (3500, 1200, 0)]
    calls = {"n": 0, "pos": 0}

    def fake_gather(a):
        if a.shape == (1,):                      # the lengths round
            return np.array([[len(x)] for x in locals_], np.int64)
        width, s = len(a), calls["pos"]
        calls["n"] += 1
        calls["pos"] += width
        out = np.zeros((3, width), np.uint64)
        for i, x in enumerate(locals_):
            out[i, :len(x[s:s + width])] = x[s:s + width]
        return out.view(np.int64)

    class Counter:
        def sorted_hashes(self):
            return locals_[0]

    monkeypatch.setattr(sharding, "all_gather_np", fake_gather)
    got = multihost._union_patterns_across_processes(Counter(), chunk=1000)
    assert calls["n"] >= 4
    assert got == len(np.unique(np.concatenate(locals_)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("n_proc", [2, 3])
def test_cli_processes_write_the_one_process_bytes(tmp_path, n_proc):
    """associate-mp over gloo: process 0's artifacts are byte-identical to
    the one-process run's. With 3 processes the spans are skewed
    (tests/test_multiprocess.py:174-250): most k-mers lie in the first
    eighth of the k-mer space, so two processes exhaust early and step on
    empty batches until the first finishes."""
    rng = np.random.default_rng(55)
    kmers = None
    if n_proc == 3:
        space = 1 << 30
        kmers = np.sort(np.concatenate([
            rng.choice(space // 8, size=500, replace=False),
            space // 8 + rng.choice(space - space // 8, size=40,
                                    replace=False)])).astype(np.uint64)
    base, names, rng = write_table(tmp_path, 44 + n_proc, 600, 24,
                                   kmers=kmers)
    pheno = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno, formats.PhenotypeTable(
        names=list("abc"), accessions=names, values=dyadic(rng, (24, 3))))
    args = ["associate-mp", "-p", pheno, "-t", base, "-k", "15", "-b", "25",
            "--maf", "0.05", "--mac", "2", "--batch_size", "96",
            "--device", "cpu", "--pattern_counter", "--first_phenotype_best",
            "30", "--coordinator", f"127.0.0.1:{_free_port()}"]
    one, many = tmp_path / "one", tmp_path / "many"
    one.mkdir()
    many.mkdir()
    port_cli(args + ["-o", str(one), "--num_processes", "1",
                     "--process_id", "0", "--dtable_cache",
                     str(tmp_path / "one.dtable")])
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu_torch.cli", *args,
         "-o", str(many), "--num_processes", str(n_proc), "--process_id",
         str(pid), "--dtable_cache", str(tmp_path / "span.dtable")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(n_proc)]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            pr.kill()
            out, _ = pr.communicate()
        outs.append(out.decode(errors="replace"))
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-3000:]
    spans = [multihost.host_row_span(base, i, n_proc) for i in range(n_proc)]
    edges = [0] + [hi for _, hi in spans]
    assert [lo for lo, _ in spans] == edges[:-1]
    assert edges[-1] == (600 if kmers is None else len(kmers))
    assert min(hi - lo for lo, hi in spans) > 0
    if n_proc == 3:                                 # skewed
        assert spans[0][1] >= 500
    files = sorted(os.listdir(one))
    assert files == sorted(os.listdir(many))
    assert {"pheno.tested_kmers", "pheno.pattern_counter"} <= set(files)
    assert sum(f.endswith(".bed") for f in files) == 3
    _, mismatch, errors = filecmp.cmpfiles(one, many, files, shallow=False)
    assert not mismatch and not errors, mismatch
