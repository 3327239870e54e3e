"""The ``gpu`` twin of chip_smoke.py phase 16a: the reference's last jit
sites, captured, against their ``.eager`` on the card (the CPU tests are
tests/test_torch_graphs_last.py).  This file imports no JAX, so on the
card's machine, which has none (and where the tests' conftest cannot
load), it runs by a direct call:

    python3 -c "import sys; sys.path.insert(0, 'tests'); import test_torch_graphs_last_card as t; t.test_last_sites_equal_eager_on_the_card()"
"""

import os
import sys
import tempfile

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


@pytest.mark.gpu
def test_last_sites_equal_eager_on_the_card():
    """Phase 16a's checks on the card: the mesh halves and steps at every
    shard count, the renderers on real frames, the greedy engine, the Sim3
    alignment, the train step (cuDNN deterministic bitwise, its defaults
    within the gpu bars)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from asdslam_torch.config import SlamConfig
    from asdslam_torch.models import train as ttr

    card = chip_smoke.card_line()
    chip_smoke.mesh_step_checks("cuda", card)
    chip_smoke.render_checks(SlamConfig(), "cuda", card)
    chip_smoke.assignment_check("cuda", card)
    chip_smoke.sim3_align_check("cuda", card)
    with tempfile.TemporaryDirectory() as tmp:
        cache = os.path.join(tmp, "pairs.npz")
        ttr.write_pair_cache(cache, chip_smoke.N_POOL, chip_smoke.N_HELD_OUT)
        chip_smoke.train_checks(cache, "cuda", card)
