"""chip_smoke.py's tools for holding the card's renders to the CPU's: the
pixel counts, their bars, and the routes that render each frame twice.

On the card phase 12b compares every CPU-rendered frame of its "right"
path and five EuRoC-proxy frames with the card's renders of them, frame by
frame: at most 0.1% of a frame's pixels moved by more than 1e-5
(tests/test_torch_proxy.py's bar) and none further apart than 1e-6 (the
card's render is the CPU's but for the last bits).  Here both renders are
the CPU's; the ``gpu``-marked test makes phase 12b's comparison on the card.
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from asdslam_torch.io import kitti_proxy  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def right_path(tmp_path):
    """chip_smoke's "right" ground truth written to a directory that
    kitti_proxy reads while the test runs."""
    chip_smoke.write_kitti_ground_truth(str(tmp_path), "right", n=10)
    saved = kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR
    kitti_proxy.GT_DIR = kitti_proxy.CAM_DIR = str(tmp_path)
    yield
    kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR = saved


def test_pixel_gap_counts():
    a = torch.zeros(4, 5)
    b = a.clone()
    b[2, 1] = 1e-6    # differs, not moved
    b[3, 4] = 0.25    # moved
    g = chip_smoke.pixel_gap(a, b)
    assert g == dict(pixels=20, differ=2, moved=1, max_abs=0.25)
    assert chip_smoke.pixel_gap(a, a) == dict(pixels=20, differ=0, moved=0, max_abs=0.0)
    sums = chip_smoke.gap_sums([g, chip_smoke.pixel_gap(a, a)])
    assert sums == dict(frames=2, pixels=40, differ=2, moved=1, max_abs=0.25,
                        frame_moved_share=0.05)
    assert chip_smoke.gap_text([g]).startswith("1 frames: 2 of 20 pixels differ")


def frame(moved=0, max_abs=0.0):
    return dict(frame=0, pixels=1000, differ=moved, moved=moved, max_abs=max_abs)


# (the frames' gaps, whether check_gaps passes them)
GAP_CASES = {
    "equal": ([frame(), frame()], True),
    "last bits": ([frame(max_abs=1.19e-7)] * 40, True),
    # 2 of 1000 pixels moved in one frame: 2 of 2000 in all is within the
    # share bar, the frame is not
    "one frame over the share bar": ([frame(), frame(moved=2, max_abs=1e-6)], False),
    # 1 of 1000 moved meets the share bar, its 0.168 is beyond the last bits
    "a pixel moved within the share bar": ([frame(moved=1, max_abs=0.168)], False),
    "beyond the last bits, none moved": ([frame(max_abs=2e-6)], False),
}


@pytest.mark.parametrize("case", GAP_CASES)
def test_check_gaps_holds_each_frame(case):
    gaps, ok = GAP_CASES[case]
    if ok:
        chip_smoke.check_gaps(case, gaps)
    else:
        with pytest.raises(AssertionError, match="frame 0"):
            chip_smoke.check_gaps(case, gaps)


def test_cpu_rendered_compares_every_frame(right_path):
    """cpu_rendered renders each frame on the CPU, hands it on, and keeps
    each frame's gap to a second render of it, in order."""
    with chip_smoke.cpu_rendered(kitti_proxy, "cpu") as kept:
        seq = kitti_proxy.KittiProxySequence(scale=0.3)
        frames = [seq[i][1] for i in (0, 4, 9)]
    assert seq.device == torch.device("cpu")
    assert [g["frame"] for g in kept["gaps"]] == [0, 4, 9]
    assert all(g["differ"] == 0 and g["pixels"] == frames[0].numel() for g in kept["gaps"])
    chip_smoke.check_gaps("cpu", kept["gaps"])
    plain = kitti_proxy.KittiProxySequence(scale=0.3, device="cpu")
    assert torch.equal(frames[1], plain[4][1])


def test_euroc_render_gap_frames():
    gaps = chip_smoke.euroc_render_gap("cpu")
    assert [g["frame"] for g in gaps] == list(chip_smoke.EUROC_GAP_FRAMES)
    assert all(g["pixels"] == 752 * 480 and g["differ"] == 0 for g in gaps)


@pytest.mark.gpu
def test_card_renders_are_the_cpu_s(tmp_path):
    """Phase 12b's comparison: the 40 frames of "right" at 1241x376 and the
    EuRoC-proxy frames, each rendered on the card against the CPU, within
    check_gaps' bars."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's renders against the CPU's")
    chip_smoke.write_kitti_ground_truth(str(tmp_path), "right")
    saved = kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR
    kitti_proxy.GT_DIR = kitti_proxy.CAM_DIR = str(tmp_path)
    try:
        with chip_smoke.cpu_rendered(kitti_proxy, "cuda") as kept:
            seq = kitti_proxy.KittiProxySequence()
            for i in range(len(seq)):
                seq[i]
    finally:
        kitti_proxy.GT_DIR, kitti_proxy.CAM_DIR = saved
    assert len(kept["gaps"]) == chip_smoke.N_KITTI
    chip_smoke.check_gaps("right", kept["gaps"])
    chip_smoke.check_gaps("EuRoC", chip_smoke.euroc_render_gap("cuda"))
