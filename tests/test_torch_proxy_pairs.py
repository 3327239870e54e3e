"""The port's ProxyPairSource (asdslam_torch/models/proxy_pairs.py) against the
JAX package's, on the CPU, over a TUM trajectory and a camera file that the
test writes (``GT_DIR`` / ``CAM_DIR`` monkeypatched, as
tests/test_torch_proxy.py does).

Bars: the same pixel picks (the numpy sampler's state equal after every
draw, so every frame pair, candidate choice and kept pair is the
reference's), and each pair's patches within the renderer's bar: at most
0.1% of pixels moved by more than 1e-5 (tests/test_torch_proxy.py)."""

import os

import numpy as np
import pytest
import torch

from asdslam_tpu.io import kitti_proxy as jkp
from asdslam_tpu.models import proxy_pairs as jpp
from asdslam_torch.io import kitti_proxy as tkp
from asdslam_torch.models import proxy_pairs as tpp
from test_torch_proxy import PIXEL_SHARE_BAR, moved_share, write_tum


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_proxy_pair_source_against_reference(tmp_path, monkeypatch):
    for mod in (tkp, jkp):
        monkeypatch.setattr(mod, "GT_DIR", str(tmp_path))
        monkeypatch.setattr(mod, "CAM_DIR", str(tmp_path))
    os.makedirs(tmp_path / "nvidia_asnd_KITTI00")
    write_tum(tkp.gt_path("00"))
    with open(tkp.camera_config_path("00"), "w") as f:
        f.write("718.856,718.856,607.1928,185.2157\n")
    kw = dict(scale=0.2, n_boxes=64, seed=5)
    ours = tpp.ProxyPairSource("00", device="cpu", **kw)
    ref = jpp.ProxyPairSource("00", **kw)
    np.testing.assert_array_equal(ours.K_np, ref.K_np)
    for batch, cap in ((24, 10), (16, 200)):
        oa, op = ours.sample(batch, per_frame_cap=cap)
        ra, rp = ref.sample(batch, per_frame_cap=cap)
        assert ours.rng.bit_generator.state == ref.rng.bit_generator.state
        assert oa.shape == ra.shape == (batch, 32, 32)
        for x, y in ((oa, ra), (op, rp)):
            assert all(moved_share(x[i], y[i]) <= PIXEL_SHARE_BAR for i in range(batch))
        assert oa.std(axis=(1, 2)).min() > 0.01  # textured patches, not sky
        # matched patches look alike: closer to their own positive than to another
        assert np.abs(oa - op).mean() < np.abs(oa - np.roll(op, 1, axis=0)).mean()
