"""The on-card smoke's (chip_smoke.py) reading of a profile, on the CPU:
which device events count as device time, and which score-plane instance
a kernel's name is. The smoke itself runs only on the card."""
import pathlib
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def event(name, us, device=DeviceType.CUDA, annotation=False):
    return SimpleNamespace(
        name=name, device_type=device, is_user_annotation=annotation,
        time_range=SimpleNamespace(elapsed_us=lambda: us))


def test_device_busy_counts_every_kernel_and_no_range():
    """The port's kernels that are not templates demangle without a return
    type, kgt::topw_select_kernel(...): they are device time. The device
    span of a range kgt::<function>, the host events and user annotations
    repeat time already counted and are not."""
    prof = SimpleNamespace(events=lambda: [
        event("kgt::topw_select_kernel(float const*, int const*, int)", 600),
        event("void kgt::score_plane_kernel<13, 1>(unsigned int const*)",
              1370),
        event("kgt::gen_planes_kernel(uint4*, float*, long long)", 180),
        event("void at::native::vectorized_elementwise_kernel<4>()", 50),
        event("kgt::_flush_merge", 5000),
        event("kgt::top_k_from_bmax", 3000),
        event("kgt::top_k_from_bmax", 3000, DeviceType.CPU),
        event("void at::native::sort<2>()", 700, DeviceType.CPU),
        event("marker", 900, annotation=True)])
    busy, per = chip_smoke.device_busy(prof)
    assert busy == pytest.approx(2.2)
    assert per == pytest.approx({
        "kgt::topw_select_kernel(float const*, int const*, int)": 0.6,
        "void kgt::score_plane_kernel<13, 1>(unsigned int const*)": 1.37,
        "kgt::gen_planes_kernel(uint4*, float*, long long)": 0.18,
        "void at::native::vectorized_elementwise_kernel<4>()": 0.05})
    assert chip_smoke.is_range("kgt::score_batch_t_bmax")
    assert not chip_smoke.is_range("kgt::tile_topc_kernel(float const*)")


@pytest.mark.parametrize("entry,mode", [("score_t", 0), ("score_bmax", 1),
                                        ("score_rows", 2)])
def test_plane_kernel_names_select_one_mode(entry, mode):
    """Each score-plane entry point's instances, score_plane_kernel<N8,
    MODE> at every chunk width, are told apart by MODE alone."""
    for n8 in (1, 2, 4, 8, 13, 16):
        for m in range(3):
            name = (f"void kgt::score_plane_kernel<{n8}, {m}>(unsigned int "
                    "const*, float const*, unsigned char const*, float*)")
            assert chip_smoke.is_plane_kernel(name, entry) == (m == mode)
    assert not chip_smoke.is_plane_kernel(
        "void kgt::score_topw_tiles_kernel<13>(unsigned int const*)", entry)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3kgt21gen_planes_w32_kernelILb1EEEvP5uint4Pfxjjjj' for 'sm_90a'
ptxas info    : Function properties for _ZN3kgt21gen_planes_w32_kernelILb1EEEvP5uint4Pfxjjjj
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 58 registers, used 0 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3kgt18tile_reduce_kernelILi32ELb1ELi2ELb1EEEvPKfS2_iiiiPfPiS4_S3_S4_S4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN3kgt18tile_reduce_kernelILi32ELb1ELi2ELb1EEEvPKfS2_iiiiPfPiS4_S3_S4_S4_S4_
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3kgt18tile_reduce_kernelILi1ELb0ELi0ELb0EEEvPKfS2_iiiiPfPiS4_S3_S4_S4_S4_' for 'sm_90a'
ptxas info    : Function properties for _ZN3kgt18tile_reduce_kernelILi1ELb0ELi0ELb0EEEvPKfS2_iiiiPfPiS4_S3_S4_S4_S4_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers, 416 bytes cmem[0]
"""


def test_ptxas_table_and_summary_of_the_register_kernels():
    """Phase 1 reads registers, spills and stack frames per kernel
    instance, names K9's instances by their template arguments, and fails
    where a register kernel uses local memory."""
    table = chip_smoke.ptxas_table(PTXAS_LOG)
    gen = table["_ZN3kgt21gen_planes_w32_kernelILb1EEEvP5uint4Pfxjjjj"]
    assert gen == dict(registers=58, stack=0, spill_stores=0, spill_loads=0)
    assert chip_smoke.template_args(
        "_ZN3kgt18tile_reduce_kernelILi32ELb1ELi2ELb1EEEvPKf") \
        == (32, 1, 2, 1)
    assert chip_smoke.template_args("_ZN3kgt16tile_topc_kernelEPKfiPfPi") \
        == ()
    lines = chip_smoke.ptxas_summary(table)
    assert lines[0].startswith("gen_planes_w32_kernel<popcount=1>: 58 "
                               "registers, 0 B spill stores")
    assert lines[1].endswith("<0,0,0> 20 (0)")
    assert lines[2].endswith("<1,2,1> 255 (36)")
    bad = chip_smoke.local_memory(table)
    assert len(bad) == 1 and "ILi32ELb1ELi2ELb1E" in bad[0]
    assert chip_smoke.tensor_core_spills(PTXAS_LOG) == []


SASS = """\
\t\tFunction : _ZN3kgt21gen_planes_w32_kernelILb0EEEvP5uint4Pfxjjjj
        /*0000*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;   /* 0x0 */
\t\tFunction : _ZN3kgt21gen_planes_w32_kernelILb1EEEvP5uint4Pfxjjjj
        /*0000*/                   LDC R1, c[0x0][0x28] ;           /* 0x0 */
        /*0010*/                   IMAD.WIDE.U32 R2, R3, R4, RZ ;   /* 0x0 */
        /*0020*/              @!P0 IMAD.HI.U32 R5, R6, R7, RZ ;     /* 0x0 */
        /*0030*/                   LOP3.LUT R8, R9, R10, R11, 0x96, !PT ;
        /*0040*/               @P1 POPC R12, R13 ;                  /* 0x0 */
        /*0050*/                   NOP ;                            /* 0x0 */
        /*0060*/                   STG.E.EF.128 desc[UR4][R2.64], R8 ;
\t\tFunction : _ZN3kgt18tile_reduce_kernelILi1ELb0ELi0ELb0EEEvPKf
        /*0000*/                   POPC R12, R13 ;                  /* 0x0 */
"""


def test_sass_counts_and_integer_floor():
    """K6's SASS is counted in the one function asked for, NOP aside, with
    predicated instructions; the floor is the slowest class over its
    issue rate."""
    got = chip_smoke.sass_opcodes(SASS, "gen_planes_w32_kernelILb1E")
    assert got == {"imad": 2, "lop3": 1, "popc": 1, "all": 6}
    per_block = {"imad": 40.0, "lop3": 24.0, "popc": 4.0, "all": 70.0}
    floor, by = chip_smoke.int_floor_ms(per_block, (1 << 21) * 8, 132,
                                        1.98e9)
    assert by == "imad"
    assert floor == pytest.approx(40 * (1 << 24) / (64 * 132 * 1.98e9) * 1e3)
    floor, by = chip_smoke.int_floor_ms(dict(per_block, popc=20.0), 1, 1,
                                        1.0)
    assert by == "popc" and floor == pytest.approx(20 / 16 * 1e3)


def test_kernel_ms_in_order_assigns_launches_to_jobs():
    """One profiler session holds several jobs: each takes the next reps
    kernels of its name in launch order (two jobs may share a name), other
    device events are skipped, and a job whose kernels are missing
    fails."""
    events = [("gen_planes_w32_kernel<true>", 30, 90.0),
              ("tile_reduce_kernel<16, 1, 2, 1>", 10, 46.0),
              ("Memset (Device)", 15, 1.0),
              ("tile_reduce_kernel<16, 1, 2, 1>", 20, 48.0),
              ("gen_planes_w32_kernel<true>", 40, 88.0),
              ("gen_planes_w32_kernel<false>", 50, 80.0),
              ("gen_planes_w32_kernel<false>", 60, 82.0)]
    jobs = [("reduce", "tile_reduce_kernel"), ("pc", "gen_planes_"),
            ("no pc", "gen_planes_")]
    got = chip_smoke.kernel_ms_in_order(events, jobs, reps=2)
    assert got == pytest.approx({"reduce": 0.047, "pc": 0.089,
                                 "no pc": 0.081})
    with pytest.raises(chip_smoke.PhaseError, match="1 of 2"):
        chip_smoke.kernel_ms_in_order(events[:6], jobs, reps=2)


def test_kinship_batch_split_divides_by_full_batch_equivalents():
    """A run of 2.5 full batches' rows: its device time and each kernel's
    per full batch, and the idle share they leave of a batch's wall."""
    per = {"void kgt::kinship_gram_kernel<4>(int const*)": 5.0,
           "kgt::kinship_transpose_kernel(unsigned int const*)": 0.5,
           "Memcpy HtoD (Pageable -> Device)": 2.0,
           "void at::native::vectorized_elementwise_kernel<4>()": 0.25}
    sp = chip_smoke.kinship_batch_split(10.0, 7.75, per, 2.5, "run")
    assert sp["busy"] == pytest.approx(3.1)
    assert (sp["gram"], sp["transpose"], sp["h2d"]) == pytest.approx(
        (2.0, 0.2, 0.8))
    assert sp["idle"] == pytest.approx(69.0)
    assert chip_smoke.kinship_batch_split(3.1, 7.75, per, 2.5, "run")[
        "idle"] == pytest.approx(0.0)


@pytest.mark.parametrize("wall", [3.0, 0.0001])
def test_kinship_batch_split_refuses_an_idle_share_outside_0_100(wall):
    """A batch's wall shorter than its device time (the enqueue intervals
    an earlier reading took) is no measurement: the phase fails."""
    with pytest.raises(chip_smoke.PhaseError, match="outside"):
        chip_smoke.kinship_batch_split(wall, 7.75, {}, 2.5, "steady")


def gwas_files(p_line="P1\t3.25", bim="A_1\nC_2\n"):
    import gzip
    import json
    summary = {"n_accessions": 5, "heritability": 0.5, "lmm_backend":
               "host64", "stage_seconds": {"scan": 1.0}}
    return {"summary.json": json.dumps(summary).encode(),
            "log_file": b"[stage] scan: 1.00s\n",
            "kmers/best_pvals": f"phenotype_value\t2.5\n{p_line}\n".encode(),
            "kmers/pheno.0.phenotype_value.bed": b"\x6c\x1b\x01",
            "kmers/pheno.0.phenotype_value.bim": bim.encode(),
            "kmers/output/phenotype_value.assoc.txt.gz": gzip.compress(
                b"chr\trs\tp_lrt\n0\tACGT_1\t1.000000e-03\n", mtime=0)}


def test_compare_gwas_outputs_parses_floats_and_holds_bytes():
    """Full floats within rtol 1e-9 and the lines that differ in bytes
    counted; summary.json's stage_seconds and log_file ignored; every
    other file byte for byte."""
    a = gwas_files()
    b = gwas_files(p_line="P1\t3.2500000000000004")
    b["log_file"] = b"[stage] scan: 2.00s\n"
    b["summary.json"] = b["summary.json"].replace(b'"scan": 1.0',
                                                  b'"scan": 2.0')
    assert chip_smoke.compare_gwas_outputs(a, b) == (2, 1)
    for bad in (gwas_files(p_line="P1\t3.26"),
                gwas_files(bim="C_1\nA_2\n"),
                gwas_files(p_line="P2\t3.25")):
        with pytest.raises(chip_smoke.PhaseError):
            chip_smoke.compare_gwas_outputs(a, bad)


@pytest.mark.parametrize("rows,p,w,tile_rows,lists,want_ms", [
    (2_000_000, 101, 256, 128, 1,
     (101 * 15_625 * 16 + 101 * 256 * 4) / 3.35e12 * 1e3),
    (2_097_152, 101, 128, 4096, 2,
     (101 * 512 * 16 + 2 * 101 * 128 * 4) / 3.35e12 * 1e3)])
def test_select_bound_reads_each_candidate_once(rows, p, w, tile_rows, lists,
                                                want_ms):
    """K1's select launch (and K8's, on its probe tiles) is bounded by what
    it has to read once: per tile and column three scores and a count, 16
    bytes, and the lanes of each list's w winners, at the H100's 3.35 TB/s;
    7.57 us at the scan cell's 2,000,000-row batch."""
    got = chip_smoke.select_bound_ms(rows, p, w, tile_rows, lists)
    assert got == pytest.approx(want_ms)
    if tile_rows == 128:
        assert got == pytest.approx(0.007568, rel=1e-3)
