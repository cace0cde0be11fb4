"""The port's kinship (kmersgwas_tpu_torch.ops.kinship, pipeline.kinship,
parallel.multihost.run_distributed_kinship and the `kinship`/`kinship-mp`
CLI) against the JAX package on the CPU.

The arithmetic is integer (+-1 Gram, int64 totals) up to one f64 divide
done the same way on both sides, so every matrix must be EQUAL, not close:
the unpack, the accumulator over uneven batches with and without a forced
spill, `kinship_from_table` on both routes (and the stale-cache fallback),
checkpoints written by either package and resumed by the other, the CLI's
stdout byte for byte, and `kinship-mp` in 2 gloo processes against the
JAX package's single-process TSV byte for byte."""
import filecmp
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.core import dtable as jdtable
from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import kinship as jkin
from kmersgwas_tpu.parallel import multihost as jmh
from kmersgwas_tpu.pipeline import kinship as jkm
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.ops import bitplanes, kinship
from kmersgwas_tpu_torch.parallel import multihost
from kmersgwas_tpu_torch.pipeline import kinship as km

from test_pipeline import build_population

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_planes(seed, rows, n):
    """(rows, n_pad/32) uint32 planes of random bits over n samples."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = np.zeros((rows, n_pad), np.uint8)
    bits[:, :n] = rng.integers(0, 2, size=(rows, n))
    return jbits.pack_bits_np(bits)


def test_unpack_bits_pm1_matches_jax():
    packed = random_planes(0, 64, 100)
    packed[:, 0] |= np.uint32(1 << 31)          # sign bit of the int32 view
    got = bitplanes.unpack_bits_pm1(bitplanes.as_planes(packed))
    want = np.asarray(jbits.unpack_bits_pm1(jnp.asarray(packed)))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_rows", [300, 263, 0])
def test_accumulate_matches_jax(n_rows):
    """kinship_accumulate adds the Gram of rows [0, n_rows) only: the rows
    past it (random bits here) contribute nothing."""
    packed = random_planes(1, 300, 150)
    acc0 = np.arange(256 * 256, dtype=np.int32).reshape(256, 256) % 7
    want = np.asarray(jkin.kinship_accumulate(jnp.asarray(acc0),
                                              jnp.asarray(packed[:n_rows])))
    acc = torch.from_numpy(acc0.copy())
    out = kinship.kinship_accumulate(acc, bitplanes.as_planes(packed), n_rows)
    assert out is acc
    np.testing.assert_array_equal(acc.numpy(), want)
    gram = kinship.kinship_gram_plain(bitplanes.as_planes(packed), n_rows)
    np.testing.assert_array_equal(gram.numpy(), want - acc0)


def test_accumulate_masked_matches_jax():
    packed = random_planes(2, 200, 60)
    valid = (np.random.default_rng(3).random(200) < 0.7).astype(np.int8)
    acc0 = np.zeros((128, 128), np.int32)
    want = jkin.kinship_accumulate_masked(jnp.asarray(acc0),
                                          jnp.asarray(packed),
                                          jnp.asarray(valid))
    got = kinship.kinship_accumulate_masked(
        torch.from_numpy(acc0.copy()), bitplanes.as_planes(packed),
        torch.from_numpy(valid))     # in place: not on JAX's input buffer
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # in place, as on the card: the same partial taken twice adds twice
    acc = torch.ones((128, 128), dtype=torch.int32)
    assert kinship.kinship_accumulate_masked(
        acc, bitplanes.as_planes(packed), torch.from_numpy(valid)) is acc
    kinship.kinship_accumulate_masked(acc, bitplanes.as_planes(packed),
                                      torch.from_numpy(valid))
    np.testing.assert_array_equal(acc.numpy(), 1 + 2 * np.asarray(want))


@pytest.mark.parametrize("spill", [None, 150])
def test_accumulator_uneven_batches_match_jax(monkeypatch, spill):
    """Uneven batches through both accumulators; with the spill bound
    patched to 150 rows the port flushes its int32 partial to the int64
    total several times and must still end equal."""
    packed = random_planes(4, 700, 90)
    sizes = [37, 128, 5, 200, 64, 1, 265]
    flushes = []
    if spill:
        monkeypatch.setattr(kinship, "SPILL_ROWS", spill)
        real = kinship.KinshipAccumulator.flush

        def spy(self):
            flushes.append(self.rows_in_acc)
            real(self)
        monkeypatch.setattr(kinship.KinshipAccumulator, "flush", spy)
    ja = jkin.KinshipAccumulator(n_used=90, n_pad=128)
    pa = kinship.KinshipAccumulator(n_used=90, n_pad=128, device="cpu")
    s = 0
    for r in sizes:
        ja.add(jnp.asarray(packed[s:s + r]))
        # the port's batch rides in a larger buffer with a stale tail
        pa.add(bitplanes.as_planes(packed[s:s + r + 50]), r)
        s += r
    assert pa.n_rows == ja.n_rows == sum(sizes)
    got, want = pa.finalize(), ja.finalize()
    np.testing.assert_array_equal(pa.total, ja.total)
    np.testing.assert_array_equal(got, want)
    if spill:
        # a flush before every add that would pass the bound, and the last
        assert [f for f in flushes if f] == [37, 133, 200, 65, 265]


@pytest.mark.parametrize("shards", [2, 3])
def test_accumulator_over_a_mesh_matches_jax(monkeypatch, shards):
    """The accumulator over a mesh of cpu shards (one partial each, every
    batch cut into row shards whose valid rows are a prefix, some of them
    empty): uneven batches with a stale tail, the spill bound patched to
    150 rows, end equal to the JAX package's single accumulator."""
    from kmersgwas_tpu_torch.parallel import sharding
    monkeypatch.setattr(kinship, "SPILL_ROWS", 150)
    packed = random_planes(5, 700, 90)
    ja = jkin.KinshipAccumulator(n_used=90, n_pad=128)
    pa = kinship.KinshipAccumulator(
        n_used=90, n_pad=128, mesh=sharding.make_mesh(["cpu"] * shards))
    assert len(pa.device_accs) == shards
    assert pa.devices == [torch.device("cpu")]
    s = 0
    for r in [37, 128, 5, 200, 64, 1, 265]:
        ja.add(jnp.asarray(packed[s:s + r]))
        pa.add(bitplanes.as_planes(packed[s:s + r + 50]), r)
        s += r
    got, want = pa.finalize(), ja.finalize()
    assert pa.n_rows == ja.n_rows
    np.testing.assert_array_equal(pa.total, ja.total)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["table", "dtable"])
def test_kinship_from_table_matches_jax(tmp_path, route):
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    kw = dict(maf=0.1, batch_size=64)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "k.dtable")
    seen = []
    got = km.kinship_from_table(pop["base"], device="cpu",
                                progress=seen.append, **kw)
    want = jkm.kinship_from_table(pop["base"], **kw)
    np.testing.assert_array_equal(got, want)
    assert len(seen) >= 3 and max(seen) <= 64
    if route == "dtable":
        assert os.path.exists(kw["dtable_cache"])


def test_stale_dtable_falls_back_to_the_table(tmp_path):
    """A cache built for maf 0.1 is stale for maf 0.3: both packages leave
    it alone and stream the raw table."""
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    dtc = str(tmp_path / "k.dtable")
    km.kinship_from_table(pop["base"], device="cpu", maf=0.1, batch_size=64,
                          dtable_cache=dtc)
    before = open(dtc, "rb").read()
    got = km.kinship_from_table(pop["base"], device="cpu", maf=0.3,
                                batch_size=64, dtable_cache=dtc)
    np.testing.assert_array_equal(
        got, jkm.kinship_from_table(pop["base"], maf=0.3, batch_size=64,
                                    dtable_cache=dtc))
    np.testing.assert_array_equal(
        got, jkm.kinship_from_table(pop["base"], maf=0.3, batch_size=64))
    assert open(dtc, "rb").read() == before
    assert jdtable.DTableReader(dtc).hdr.min_count == 2      # ceil(20*0.1)


class _Interrupt(Exception):
    pass


def _bomb_at(n):
    calls = []

    def progress(r):
        calls.append(r)
        if len(calls) == n:
            raise _Interrupt
    return progress


@pytest.mark.parametrize("route", ["table", "dtable"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, route):
    """A run interrupted after 3 batches (checkpoint every 2) by one
    package is resumed to the end by the other: the matrix equals the
    uninterrupted one."""
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    kw = dict(maf=0.1, batch_size=48, checkpoint_path=str(tmp_path / "ck"),
              checkpoint_every=2)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "k.dtable")
    batches = []
    full = jkm.kinship_from_table(pop["base"], maf=0.1, batch_size=48,
                                  progress=batches.append)
    port = lambda **extra: km.kinship_from_table(  # noqa: E731
        pop["base"], device="cpu", **kw, **extra)
    jax = lambda **extra: jkm.kinship_from_table(  # noqa: E731
        pop["base"], **kw, **extra)
    first, second = (jax, port) if writer == "jax" else (port, jax)
    with pytest.raises(_Interrupt):
        first(progress=_bomb_at(3))
    z = np.load(str(tmp_path / "ck.npz"))
    assert bytes(z["stream"]).decode() == route
    assert int(z["n_rows"]) == 2 * 48           # the save after batch 2
    seen = []
    got = second(progress=seen.append)
    np.testing.assert_array_equal(got, full)
    assert seen == batches[2:]      # resumed after the first two batches


def test_kinship_cli_stdout_matches_jax(tmp_path, capsys):
    pop = build_population(tmp_path, n_samples=16, n_kmers=300)
    args = ["kinship", "-t", pop["base"], "--maf", "0.1", "--batch_size",
            "50"]
    jax_cli(args)
    want = capsys.readouterr().out
    port_cli(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 16


def test_refusals(tmp_path, monkeypatch, capsys):
    """A mesh and `kinship --devices 2` are accepted and give the
    single-device matrix and stdout; a checkpoint of another config, CPU
    tensors on another device and a missing card are refused."""
    from kmersgwas_tpu_torch.parallel import sharding
    pop = build_population(tmp_path, n_samples=16, n_kmers=200)
    np.testing.assert_array_equal(
        km.kinship_from_table(pop["base"], device="cpu", batch_size=50,
                              mesh=sharding.make_mesh(["cpu"] * 2)),
        km.kinship_from_table(pop["base"], device="cpu", batch_size=50))
    outs = []
    for n_dev in ("1", "2"):
        port_cli(["kinship", "-t", pop["base"], "--maf", "0.1",
                  "--devices", n_dev, "--device", "cpu"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 16
    # a checkpoint of another table/config is refused, not silently used
    ck = str(tmp_path / "ck")
    jkm.kinship_from_table(pop["base"], maf=0.1, batch_size=50,
                           checkpoint_path=ck, checkpoint_every=1)
    with pytest.raises(ValueError, match="refusing to resume"):
        km.kinship_from_table(pop["base"], device="cpu", maf=0.3,
                              batch_size=50, checkpoint_path=ck)
    packed = bitplanes.as_planes(random_planes(5, 64, 100))
    acc = kinship.kinship_init(128, "cpu")
    with pytest.raises(ValueError, match="no kernel"):
        kinship.kinship_accumulate(acc.to("meta"), packed.to("meta"))
    with pytest.raises(ValueError, match="n_rows"):
        kinship.kinship_accumulate(acc, packed, 65)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        km.kinship_from_table(pop["base"], device="cuda", maf=0.1)


@pytest.mark.parametrize("route", ["table", "dtable"])
def test_distributed_kinship_one_process_matches_jax(tmp_path, route):
    """run_distributed_kinship in one process, with per-process checkpoints
    and a resume, against the JAX package's driver (on conftest's
    8-device mesh) and its kinship_from_table; a JAX mp checkpoint resumes
    in the port."""
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    kw = dict(maf=0.1, batch_size=50)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "span.dtable")
    want = jkm.kinship_from_table(pop["base"], maf=0.1, batch_size=50)
    np.testing.assert_array_equal(
        multihost.run_distributed_kinship(pop["base"], device="cpu", **kw),
        want)
    ck = str(tmp_path / "ck")
    with pytest.raises(_Interrupt):
        jmh.run_distributed_kinship(pop["base"], checkpoint_path=ck,
                                    checkpoint_every=2, progress=_bomb_at(3),
                                    **kw)
    assert os.path.exists(ck + ".p0.npz")
    got = multihost.run_distributed_kinship(
        pop["base"], device="cpu", checkpoint_path=ck, checkpoint_every=2,
        **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        jmh.run_distributed_kinship(pop["base"], checkpoint_path=ck, **kw),
        want)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("route", ["table", "dtable"])
def test_kinship_mp_two_processes_write_the_jax_bytes(tmp_path, route):
    """kinship-mp in 2 processes over gloo on 127.0.0.1 (each streams its
    k-mer span): process 0's TSV is byte-identical to the JAX package's
    single-process kinship_from_table written by its write_kinship."""
    pop = build_population(tmp_path, n_samples=24, n_kmers=600, seed=13)
    out = str(tmp_path / "K.tsv")
    args = [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "kinship-mp",
            "-t", pop["base"], "--maf", "0.1", "--batch_size", "64", "-o",
            out, "--device", "cpu", "--coordinator",
            f"127.0.0.1:{_free_port()}", "--num_processes", "2"]
    if route == "dtable":
        args += ["--dtable_cache", str(tmp_path / "span.dtable")]
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen(args + ["--process_id", str(pid)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for pid in (0, 1)]
    logs = []
    for pr in procs:
        try:
            text, _ = pr.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            pr.kill()
            text, _ = pr.communicate()
        logs.append(text.decode(errors="replace"))
    for pr, text in zip(procs, logs):
        assert pr.returncode == 0, text[-3000:]
    spans = [multihost.host_row_span(pop["base"], i, 2) for i in (0, 1)]
    assert all(hi > lo for lo, hi in spans)
    ref = str(tmp_path / "ref.tsv")
    jkm.write_kinship(ref, jkm.kinship_from_table(pop["base"], maf=0.1,
                                                  batch_size=64))
    assert filecmp.cmp(out, ref, shallow=False)
    km.write_kinship(str(tmp_path / "port.tsv"), km.read_kinship(out))
    assert filecmp.cmp(str(tmp_path / "port.tsv"), ref, shallow=False)
