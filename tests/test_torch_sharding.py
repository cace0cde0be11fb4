"""The port's single-process device mesh (kmersgwas_tpu_torch.parallel.
sharding, `associate(mesh=)`, `kinship_from_table(mesh=)`, `run_gwas`
and the CLI's `--devices`) against the JAX package's 8-device CPU mesh
(tests/conftest.py), on the same numpy inputs; the port's mesh is 8 `cpu`
shards. Every case of tests/test_sharding.py, plus a batch that is not a
multiple of D * TILE_ROWS.

Tolerances: on dyadic phenotypes both packages' float32 scores are exact,
so rows, order and scores are EQUAL; on Gaussian phenotypes the port runs
at precision "highest" and its scores sit within rtol 1e-5 of the JAX
package's (f32 sums in another order), rows and order equal. Kinship is
integer arithmetic: equal. Against the port's own single-device run the
production mesh is exact (the same step on the same rows, merged under
the same order), and the CLI's `--devices 8` writes `--devices 1`'s
stdout and files byte for byte."""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmersgwas_tpu.core import formats
from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import kinship as jkin
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu.parallel import sharding as jsh
from kmersgwas_tpu.pipeline import checkpoint as jckpt
from kmersgwas_tpu.pipeline import kinship as jkm
from kmersgwas_tpu.pipeline import scan as jscan
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.ops import kinship as kin_ops
from kmersgwas_tpu_torch.ops import score, topk
from kmersgwas_tpu_torch.parallel import sharding as sh
from kmersgwas_tpu_torch.pipeline import checkpoint as pckpt
from kmersgwas_tpu_torch.pipeline import kinship as km
from kmersgwas_tpu_torch.pipeline import scan as pscan

from test_pipeline import K, build_population
from test_torch_scan import assert_same, dyadic

D = 8


@pytest.fixture(scope="module")
def jmesh():
    if len(jax.devices()) < D:
        pytest.skip("needs the 8-device virtual CPU platform")
    return jsh.make_mesh()


@pytest.fixture(scope="module")
def mesh():
    return sh.make_mesh(["cpu"] * D)


def make(rng, r, n, p):
    n_pad = -(-n // 128) * 128
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    padded = np.zeros((r, n_pad), dtype=np.uint8)
    padded[:, :n] = bits
    return bits, jbits.pack_bits_np(padded), \
        rng.normal(size=(n, p)).astype(np.float32), n_pad


def finalized_equal(got, want, rtol):
    for (gv, gr), (wv, wr) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_allclose(gv, wv, rtol=rtol)


def mesh_step(mesh, n, mc, k):
    """The port's mesh step (`cand_w` mode, 16 candidates a shard, a
    32-slot buffer) at precision "highest"."""
    return sh.build_sharded_scan_step_compact(
        mesh, n_used=n, min_count=mc, cand_k=k, tile_rows=pscan.TILE_ROWS,
        cand_w=16, cand_q=8, precision="highest")


def test_mesh_step_one_batch_equals_jax(mesh, jmesh):
    """build_sharded_scan_step_compact on one 4096-row batch, finalized
    across the shards: the JAX package's 8-device plain step, the port's
    8 shards (precision "highest") and the port's single-device
    topk.update keep the same rows in the same order. Gaussian y: the
    CPU's matmul sums a 512-row shard's products in another order than a
    4096-row batch's, so the single-device scores are held at rtol
    1e-6."""
    rng = np.random.default_rng(0)
    r, n, p, k, mc = 4096, 50, 3, 40, 2
    bits, packed, y, n_pad = make(rng, r, n, p)
    popcnt = bits.sum(axis=1).astype(np.float32)
    lo, hi = topk.encode_rows(np.arange(r))

    jstep = jsh.build_sharded_scan_step(jmesh, n_used=n, min_count=mc, k=k)
    jyp, jys = jscore.prepare_phenotypes(y, n_pad)
    jst = jtopk.TopKState(*jsh.replicate(jmesh, *jtopk.init_state(p, k)))
    want = jtopk.finalize(jstep(jst, *jsh.shard_batch(
        jmesh, [packed, popcnt, lo, hi]), *jsh.replicate(jmesh, jyp, jys)))

    yp, ysum = score.prepare_phenotypes(y, n_pad, "cpu")
    states = sh.init_sharded_buffered_state(mesh, p, k, 32)
    mesh_step(mesh, n, mc, k)(states, *sh.shard_batch(
        mesh, [packed, popcnt, lo, hi]), *sh.replicate(mesh, yp, ysum))
    got = sh.finalize_sharded_buffered(states)
    finalized_equal(got, want, 1e-5)

    pc = torch.from_numpy(popcnt)
    sc = score.score_batch_t(torch.from_numpy(packed.view(np.int32)), pc,
                             yp, ysum, n_used=n, min_count=mc,
                             precision="highest")
    ok = (pc >= mc) & (n - pc >= mc) & (pc > 0)
    sc = torch.where(ok, sc, float("-inf")).T
    one = topk.finalize(topk.update(topk.init_state(p, k), sc,
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi)))
    finalized_equal(got, one, 1e-6)


def test_mesh_step_multiple_updates_equals_jax(mesh, jmesh):
    """Three batches through the mesh step: the kept rows are the f64
    brute force's top-k, and the JAX package's plain mesh step's."""
    rng = np.random.default_rng(1)
    n, p, k = 30, 2, 16
    step = mesh_step(mesh, n, 1, k)
    jstep = jsh.build_sharded_scan_step(jmesh, n_used=n, min_count=1, k=k)
    states = sh.init_sharded_buffered_state(mesh, p, k, 32)
    jst = jtopk.TopKState(*jsh.replicate(jmesh, *jtopk.init_state(p, k)))
    seen = []
    for it in range(3):
        bits, packed, y, n_pad = make(rng, 1024, n, p)
        if it == 0:
            y0 = y
            yp, ysum = sh.replicate(mesh, *score.prepare_phenotypes(
                y0, n_pad, "cpu"))
            jy = jsh.replicate(jmesh, *jscore.prepare_phenotypes(y0, n_pad))
        popcnt = bits.sum(axis=1).astype(np.float32)
        rows = np.arange(it * 1024, (it + 1) * 1024)
        lo, hi = topk.encode_rows(rows)
        step(states, *sh.shard_batch(mesh, [packed, popcnt, lo, hi]), yp,
             ysum)
        jst = jstep(jst, *jsh.shard_batch(jmesh, [packed, popcnt, lo, hi]),
                    *jy)
        seen.append((bits, rows))
    got = sh.finalize_sharded_buffered(states)
    finalized_equal(got, jtopk.finalize(jst), 1e-5)
    allbits = np.concatenate([b for b, _ in seen]).astype(np.float64)
    allrows = np.concatenate([r for _, r in seen])
    n1 = allbits.sum(axis=1)
    for j in range(p):
        yj = y0[:, j].astype(np.float64)
        r_ = n * (allbits @ yj) - n1 * yj.sum()
        denom = n * n1 - n1 ** 2
        s = np.where((denom > 0) & (n1 >= 1) & (n1 <= n - 1),
                     r_ ** 2 / np.where(denom > 0, denom, 1), -np.inf)
        order = np.argsort(-s, kind="stable")[:k]
        assert set(got[j][1].tolist()) == set(allrows[order].tolist())


@pytest.mark.parametrize("form", ["step", "accumulate"])
def test_sharded_kinship_equals_jax(mesh, jmesh, form):
    """KinshipAccumulator(mesh=) over 8 shards against the JAX package's
    build_sharded_kinship_step (exact rows: 2048 = 8 x 256; the total it
    returns) and build_sharded_kinship_accumulate (2000 rows, 8 x 250;
    its per-shard partials summed): the port's batch is padded to 2048
    rows of ones and only its first 2000 are counted, so its last shard
    masks 48 padding rows. The total equals the JAX package's, bit for
    bit."""
    rng = np.random.default_rng(2)
    n = 40
    acc = kin_ops.KinshipAccumulator(n_used=n, n_pad=128, mesh=mesh)
    if form == "step":
        bits, packed, _, n_pad = make(rng, 2048, n, 1)
        acc.add(torch.from_numpy(packed.view(np.int32)))
        want = jsh.build_sharded_kinship_step(jmesh)(
            *jsh.replicate(jmesh, jnp.zeros((n_pad, n_pad), jnp.int32)),
            *jsh.shard_batch(jmesh, [packed]))
        want = np.asarray(want).astype(np.int64)
        g = bits.astype(np.int64)
        expect = np.stack([(1 ^ g[:, i][:, None] ^ g).sum(axis=0)
                           for i in range(n)])
    else:
        bits, packed, _, n_pad = make(rng, 2000, n, 1)
        valid = np.ones(2000, np.int8)
        padded = np.concatenate([packed, np.full((48, packed.shape[1]),
                                                 0xFFFFFFFF, packed.dtype)])
        acc.add(torch.from_numpy(padded.view(np.int32)), 2000)
        want = jsh.build_sharded_kinship_accumulate(jmesh)(
            jsh.shard_batch(jmesh, [np.zeros((D, n_pad, n_pad),
                                             np.int32)])[0],
            *jsh.shard_batch(jmesh, [packed, valid]))
        want = np.asarray(want).astype(np.int64).sum(axis=0)
        one = jkin.kinship_accumulate(jnp.zeros((n_pad, n_pad), jnp.int32),
                                      jnp.asarray(packed))
        np.testing.assert_array_equal(want, np.asarray(one))
        expect = None
    acc.flush()
    assert acc.n_rows == len(bits)
    np.testing.assert_array_equal(acc.total, want[:n, :n])
    if expect is not None:
        np.testing.assert_array_equal((len(bits) + acc.total) / 2.0, expect)


def test_shard_batch_views_and_padding(mesh):
    """Rows [d R/D, (d+1) R/D) per shard, padded at the end to a multiple
    of D; shards of a tensor on their own device are views; yp is placed
    once per distinct device."""
    x = torch.arange(64, dtype=torch.int32).reshape(16, 4)
    shards, = sh.shard_batch(mesh, [x])
    assert [s.data_ptr() for s in shards] == \
        [x[2 * d].data_ptr() for d in range(D)]
    odd, = sh.shard_batch(mesh, [np.arange(13, dtype=np.uint32)],
                          pad_value=7)
    flat = torch.cat(odd).numpy()
    np.testing.assert_array_equal(flat[:13], np.arange(13))
    assert (flat[13:] == 7).all() and len(flat) == 16
    assert flat.dtype == np.int32
    rep, = sh.replicate(mesh, np.ones(3, np.float32))
    assert len({id(t) for t in rep}) == 1


def test_make_mesh_and_mesh_for(monkeypatch):
    m = sh.make_mesh(["cpu", "cpu", torch.device("cpu")])
    assert m.size == 3 and m.distinct() == [torch.device("cpu")]
    assert sh.mesh_for(1, "cpu") is None and sh.mesh_for(None, "cpu") is None
    assert sh.mesh_for(4, "cpu").devices == (torch.device("cpu"),) * 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="one kind"):
        sh.make_mesh(["cuda:0", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        sh.make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        sh.mesh_for(2, "cuda")


@pytest.mark.parametrize("route,phen", [
    ("table", "dyadic"), ("dtable", "dyadic"), ("table", "gaussian"),
    ("dtable", "certify"),
])
def test_associate_mesh_matches_jax_mesh(tmp_path, mesh, jmesh, route,
                                         phen):
    """The production scan with a mesh, over many streamed batches: the
    port's 8 shards equal the port's single-device run exactly, and the
    JAX package's 8-device mesh in rows and order (scores equal on dyadic
    phenotypes, within rtol 1e-5 on Gaussian ones at "highest")."""
    pop = build_population(tmp_path, n_samples=24, n_kmers=600)
    n = len(pop["names"])
    if phen == "gaussian":
        y = np.random.default_rng(7).normal(size=(n, 3))
        extra = dict(score_precision="highest")
    else:
        y = dyadic(7, n, 3)
        extra = dict(certify_topk=True) if phen == "certify" else {}
    kw = dict(kmer_len=K, n_top=25, maf=0.05, mac=2, batch_size=64)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "pop.dtable")
    want = jscan.associate(pop["base"], pop["names"], y, list("abc"),
                           mesh=jmesh, **kw)
    got = pscan.associate(pop["base"], pop["names"], y, list("abc"),
                          device="cpu", mesh=mesh, **kw, **extra)
    one = pscan.associate(pop["base"], pop["names"], y, list("abc"),
                          device="cpu", **kw, **extra)
    assert_same(got, one)
    assert got.n_tested == want.n_tested
    for j in range(3):
        if phen == "certify":
            assert set(got.rows[j].tolist()) == set(want.rows[j].tolist())
            continue
        np.testing.assert_array_equal(got.rows[j], want.rows[j])
        np.testing.assert_array_equal(got.kmers[j], want.kmers[j])
        np.testing.assert_allclose(got.scores[j], want.scores[j],
                                   rtol=1e-5 if phen == "gaussian" else 0)


def test_associate_mesh_batch_off_the_quantum(tmp_path):
    """A batch of 1000 rows over 3 shards pads to 3 x 384 rows (not a
    multiple of D * TILE_ROWS before padding), the last batch shorter
    still; the result is the single-device run's."""
    pop = build_population(tmp_path, n_samples=20, n_kmers=900, seed=3)
    y = dyadic(4, 20, 2)
    kw = dict(kmer_len=K, n_top=30, maf=0.05, mac=2, batch_size=1000,
              device="cpu")
    one = pscan.associate(pop["base"], pop["names"], y, ["a", "b"], **kw)
    got = pscan.associate(pop["base"], pop["names"], y, ["a", "b"],
                          mesh=sh.make_mesh(["cpu"] * 3), **kw)
    assert one.n_tested > 1000 and one.n_tested % 1000
    assert_same(got, one)


class Boom(RuntimeError):
    pass


@pytest.mark.parametrize("first,second", [
    ("jax8", "port8"), ("port8", "jax8"), ("port8", "port1"),
])
def test_mesh_checkpoint_resumes(tmp_path, mesh, jmesh, first, second):
    """A meshed scan that crashed after 3 batches resumes from its
    checkpoint in the other package, or with one device, and ends equal to
    an unbroken single-device scan."""
    pop = build_population(tmp_path, n_samples=16, n_kmers=400)
    y = dyadic(8, 16, 2)
    kw = dict(kmer_len=K, n_top=20, maf=0.05, mac=2, batch_size=48)
    full = pscan.associate(pop["base"], pop["names"], y, ["a", "b"],
                           device="cpu", **kw)
    ck = str(tmp_path / "ck")
    runs = {"jax8": lambda **a: jscan.associate(mesh=jmesh, **a),
            "port8": lambda **a: pscan.associate(device="cpu", mesh=mesh,
                                                 **a),
            "port1": lambda **a: pscan.associate(device="cpu", **a)}
    calls = []

    def crash_after_3(r):
        calls.append(r)
        if len(calls) == 3:
            raise Boom()

    args = dict(table_base=pop["base"], pheno_accessions=pop["names"],
                pheno_values=y, pheno_names=["a", "b"], checkpoint_path=ck,
                checkpoint_every=1, **kw)
    with pytest.raises(Boom):
        runs[first](progress=crash_after_3, **args)
    st = (jckpt if first == "jax8" else pckpt).load_scan_state(ck)
    assert 0 < st[1] and st[2] == 3 * 48
    res = runs[second](**args)
    assert_same(res, full)


@pytest.mark.parametrize("route", ["table", "dtable"])
def test_kinship_from_table_mesh_bit_exact(tmp_path, mesh, jmesh, route):
    """kinship_from_table(mesh=) with an odd batch (37 rows: padded
    shards, masked rows) and a checkpoint every 2 batches equals the
    single-device matrix and the JAX package's 8-device one, bit for
    bit."""
    pop = build_population(tmp_path, n_samples=24, n_kmers=500)
    kw = dict(maf=0.05, batch_size=37)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "k.dtable")
    ref = km.kinship_from_table(pop["base"], device="cpu", **kw)
    want = jkm.kinship_from_table(pop["base"], mesh=jmesh, **kw)
    got = km.kinship_from_table(pop["base"], device="cpu", mesh=mesh,
                                checkpoint_path=str(tmp_path / "kck"),
                                checkpoint_every=2, **kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, want)


def test_associate_mesh_scaled_flagship(tmp_path, mesh, jmesh):
    """tests/test_sharding.py's flagship shape scaled down: P=101 columns,
    top-1001 (cand_k 256, BUF_CAP, cand_q and cand_w at their production
    values), 2^15 rows of 100 samples in 8192-row batches over 8 shards;
    the columns' rows and scores equal the single-device run's and the
    JAX package's 8-device mesh's (dyadic phenotypes)."""
    rng = np.random.default_rng(33)
    rows, n, p, k = 1 << 15, 100, 101, 1001
    names = [f"a{i}" for i in range(n)]
    base = str(tmp_path / "big")
    wf = (n + 63) // 64
    formats.write_names(base, names)
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, 31)
        rec = np.empty((rows, 1 + wf), dtype="<u8")
        rec[:, 0] = np.arange(rows, dtype=np.uint64) * np.uint64(11)
        rec[:, 1:] = rng.integers(0, 1 << 63, size=(rows, wf),
                                  dtype=np.uint64)
        rec[:, wf] &= np.uint64((1 << (n - (wf - 1) * 64)) - 1)
        rec.tofile(f)
    y = dyadic(5, n, p)
    cols = [f"c{j}" for j in range(p)]
    kw = dict(kmer_len=31, n_top=k, maf=0.05, mac=5, batch_size=1 << 13)
    one = pscan.associate(base, names, y, cols, device="cpu", **kw)
    got = pscan.associate(base, names, y, cols, device="cpu", mesh=mesh,
                          **kw)
    assert_same(got, one)
    want = jscan.associate(base, names, y, cols, mesh=jmesh, **kw)
    for j in range(0, p, 10):
        np.testing.assert_array_equal(got.rows[j], want.rows[j])
        np.testing.assert_array_equal(got.scores[j], want.scores[j])


@pytest.mark.parametrize("command", ["associate", "kinship", "gwas"])
def test_cli_devices_byte_identical(tmp_path, capsys, command):
    """`--devices 8 --device cpu` writes `--devices 1`'s stdout and files
    byte for byte (associate, kinship, gwas)."""
    pop = build_population(tmp_path, n_samples=24, n_kmers=400, seed=5,
                           causal_effect=3.0)
    y = dyadic(9, 24, 2).astype(np.float64)
    pheno = str(tmp_path / "pheno.tsv")
    formats.write_phenotypes(pheno, formats.PhenotypeTable(
        names=["a", "b"], accessions=pop["names"], values=y))
    outs = {}
    for n_dev in (1, 8):
        out = tmp_path / f"d{n_dev}"
        os.makedirs(out)
        table = str(out / "pop")       # gwas caches its kinship beside it
        for ext in (".table", ".names"):
            with open(pop["base"] + ext, "rb") as f, \
                    open(table + ext, "wb") as g:
                g.write(f.read())
        argv = {
            "associate": ["associate", "-p", pheno, "-b", "out", "-o",
                          str(out), "--kmers_table", table, "-n", "30",
                          "--kmer_len", str(K), "--mac", "2",
                          "--batch_size", "64", "--kmers_scores"],
            "kinship": ["kinship", "-t", table, "--maf", "0.1",
                        "--batch_size", "50"],
            "gwas": ["gwas", "--pheno", str(pop["pheno_path"]),
                     "--kmers_table", table, "--outdir", str(out / "g"),
                     "-l", str(K), "-k", "30", "--permutations", "8",
                     "--mac", "2", "--batch_size", "100",
                     "--min_data_points", "10", "--lmm_backend", "host64",
                     "--certify_topk"],
        }[command]
        capsys.readouterr()
        port_cli(argv + ["--device", "cpu", "--devices", str(n_dev)])
        outs[n_dev] = (capsys.readouterr().out, out)
    assert outs[8][0] == outs[1][0] and outs[1][0]
    a, b = outs[1][1], outs[8][1]
    files = sorted(os.path.relpath(os.path.join(r, f), a)
                   for r, _, fs in os.walk(a) for f in fs
                   if f not in ("log_file", "summary.json"))
    assert files == sorted(
        os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b)
        for f in fs if f not in ("log_file", "summary.json"))
    if command != "kinship":
        assert any(f.endswith(".bed") for f in files)
    _, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert not mismatch and not errors, mismatch
