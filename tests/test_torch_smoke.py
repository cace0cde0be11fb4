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
