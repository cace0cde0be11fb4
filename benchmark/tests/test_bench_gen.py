"""The benchmark's frozen generator: its plain twin against the port's
(so the traffic is the port's bench's traffic), and the built copy against
its plain twin on the card."""
import pytest
import torch

from benchmark import gen


@pytest.mark.parametrize("w32,popcount", [(32, True), (32, False),
                                          (8, True), (12, False)])
def test_plain_twin_equals_the_ports(w32, popcount):
    from kmersgwas_tpu_torch.ops import gen as port_gen
    rows = torch.arange(0, 3000, 7)
    step = torch.arange(len(rows)) % 5 + (1 << 33)
    seed = (1 << 40) + 12345
    mine = gen.gen_planes_plain(rows, w32, seed, step, popcount=popcount)
    theirs = port_gen.gen_planes_plain(rows, w32, seed, step,
                                       popcount=popcount)
    for a, b in zip(*(x if popcount else (x,) for x in (mine, theirs))):
        assert torch.equal(a, b)


def test_cpu_batch_is_the_plain_twin_of_its_rows():
    planes, pc = gen.gen_planes(640, 32, 99, 3, "cpu")
    p2, pc2 = gen.gen_planes_plain(torch.arange(640), 32, 99, 3)
    assert torch.equal(planes, p2) and torch.equal(pc, pc2)
    assert float(pc.mean()) == pytest.approx(512, rel=0.02)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,w32,popcount", [
    (2_000_000, 32, True), (1 << 20, 32, False), (100_003, 8, True),
    (4099, 12, False)])
def test_built_copy_equals_its_plain_twin_on_the_card(rows, w32, popcount):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed, step = 2**31 + 17, 1000
    got = gen.gen_planes(rows, w32, seed, step, "cuda", popcount=popcount)
    sample = torch.cat([torch.arange(0, rows, 997), torch.tensor([rows - 1])])
    want = gen.gen_planes_plain(sample.cuda(), w32, seed, step,
                                popcount=popcount)
    if popcount:
        assert torch.equal(got[0][sample.cuda()], want[0])
        assert torch.equal(got[1][sample.cuda()], want[1])
    else:
        assert torch.equal(got[sample.cuda()], want)
