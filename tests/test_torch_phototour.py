"""The port's PhotoTour readers and sampler (asdslam_torch/models/train.py) on
tests/test_phototour.py's on-disk fixture (8-bit palette BMPs, info.txt, an
m50 list): twins of its four tests, and the readers byte for byte the JAX
package's, the sampler's pairs equal for the same point picks."""

import numpy as np
import pytest
import torch

import jax

from asdslam_tpu.models import train as jtr
from asdslam_torch.models import asdnet as tnet
from asdslam_torch.models import train as ttr
from test_phototour import phototour_dir  # noqa: F401  (the fixture)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestPhotoTourPipeline:
    def test_loader_byte_exact(self, phototour_dir):  # noqa: F811
        root, patches, ids = phototour_dir
        loaded, lids = ttr.load_phototour(root)
        assert loaded.shape == (32, 64, 64)
        np.testing.assert_array_equal(lids, ids)
        np.testing.assert_allclose(loaded, patches.astype(np.float32) / 255.0, atol=1e-6)

    def test_pair_list_reader(self, phototour_dir):  # noqa: F811
        root, patches, ids = phototour_dir
        i1, i2, is_match = ttr.read_phototour_pairs(root, "m50_32_32_0.txt")
        assert len(i1) == len(i2) == len(is_match) == 32
        np.testing.assert_array_equal(is_match, ids[i1] == ids[i2])
        assert is_match.sum() >= 16

    def test_batch_sampler_matches_same_point(self, phototour_dir):  # noqa: F811
        root, patches, ids = phototour_dir
        loaded, lids = ttr.load_phototour(root)
        sel = ttr.draw_phototour(torch.Generator().manual_seed(0), lids, 8)
        a, p = ttr.phototour_batch(loaded, lids, sel)
        assert a.shape == (8, 32, 32) and p.shape == (8, 32, 32)
        # centre crops of two DIFFERENT patches of the same 3D point
        d = np.abs(a - p).mean()
        assert 0.0 < d < 0.2, d

    def test_train_steps_run_on_phototour_batches(self, phototour_dir):  # noqa: F811
        root, patches, ids = phototour_dir
        loaded, lids = ttr.load_phototour(root)
        model = tnet.ASDNetTrain(tnet.init_params(
            tnet.draw_init_seeds(torch.Generator().manual_seed(0))))
        g = torch.Generator().manual_seed(1)
        for _ in range(2):
            a, p = ttr.phototour_batch(loaded, lids, ttr.draw_phototour(g, lids, 16))
            loss = ttr.train_step(model, torch.tensor(a), torch.tensor(p), torch.tensor(0.1),
                                  ttr.draw_step(g, 16))
        assert np.isfinite(float(loss))


@pytest.mark.parametrize("max_patches", [None, 21])
def test_readers_against_reference(phototour_dir, max_patches):  # noqa: F811
    """load_phototour and read_phototour_pairs byte for byte the JAX
    package's; phototour_batch gives its pairs for the picks it draws."""
    root, _, _ = phototour_dir
    ours, ref = ttr.load_phototour(root, max_patches), jtr.load_phototour(root, max_patches)
    for x, y in zip(ours, ref):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    for x, y in zip(ttr.read_phototour_pairs(root, "m50_32_32_0.txt"),
                    jtr.read_phototour_pairs(root, "m50_32_32_0.txt")):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    patches, ids = ours
    key = jax.random.PRNGKey(4)
    ra, rp = jtr.phototour_batch(key, patches, ids, 12)
    n_points = int((np.unique(ids, return_counts=True)[1] >= 2).sum())  # points with a pair
    sel = np.asarray(jax.random.randint(key, (12,), 0, n_points))
    oa, op = ttr.phototour_batch(patches, ids, sel)
    assert oa.tobytes() == np.asarray(ra).tobytes() and op.tobytes() == np.asarray(rp).tobytes()
