"""The fused step's stage clock on the card (the CPU tests are
tests/test_torch_tracing.py): the stamps against the device trace of
``torch.profiler``, and the stamped graph's results against the plain
graph's, bit for bit, at the KITTI shape.  This file imports no JAX, so on
the card's machine, which has none (and where the tests' conftest cannot
load), it runs by a direct call:

    python3 -c "import sys; sys.path.insert(0, 'tests'); import test_torch_tracing_card as t; t.test_stage_clock_on_the_card()"
"""

import functools
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

CHAINED = 4    # chained frames compared stamped against plain
REPLAYS = 8    # replays of the stamped step in the profiled slice
TOL_US, TOL_SHARE = 5.0, 0.01


def stage_kernel_starts(prof):
    """The start times (us) of the stamp kernels in a profile, in order."""
    from torch.autograd import DeviceType

    return sorted(e.time_range.start for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "stamp_kernel" in e.name)


@pytest.mark.gpu
def test_stage_clock_on_the_card():
    """At the KITTI shape: stamped and plain graphs give the same results
    bit for bit over chained frames; in a profiled slice every replay's
    stage durations from its stamps agree with the intervals between its
    stamp kernels' starts in the trace within 5 us or 1%."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from asdslam_torch.config import SlamConfig
    from asdslam_torch.frontend import track_step as ts

    cfg = SlamConfig()
    K, extract, frames_u8, _, cand, state = chip_smoke.build_tracking(cfg, "cuda")
    step = ts.make_track_step(cfg, K, extract, device="cuda")
    stamped = functools.partial(step, stamps=True)
    # warm-up, capture and a replay of each graph
    for _ in range(3):
        plain_out = chip_smoke.chain_outputs(step, frames_u8, state, cand, 1, CHAINED)
        stamped_out = chip_smoke.chain_outputs(stamped, frames_u8, state, cand, 1, CHAINED)
    torch.cuda.synchronize()
    for i, ((fp, rp), (fs, rs)) in enumerate(zip(plain_out, stamped_out)):
        assert rp.stamps is None and rs.stamps.shape == (len(ts.STAGES),)
        assert chip_smoke.tree_same_bits((fp, rp), (fs, rs._replace(stamps=None))), i

    args = (frames_u8[1], state["pose"], state["vel"], state["feat"], state["geom"], cand,
            state["crow"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        results = [stamped(*args)[1] for _ in range(REPLAYS)]
        torch.cuda.synchronize()
    starts = stage_kernel_starts(prof)
    n = len(ts.STAGES)
    assert len(starts) == n * REPLAYS, len(starts)
    worst_us, worst_share, stages_ms = 0.0, 0.0, []
    for r, res in enumerate(results):
        s = [int(x) for x in res.stamps.cpu()]
        assert s == sorted(s)
        trace = starts[r * n:(r + 1) * n]
        for i in range(n - 1):
            clock_us = (s[i + 1] - s[i]) * 1e-3
            trace_us = trace[i + 1] - trace[i]
            gap = abs(clock_us - trace_us)
            assert gap <= max(TOL_US, TOL_SHARE * trace_us), (r, ts.STAGES[i + 1], clock_us,
                                                              trace_us)
            worst_us = max(worst_us, gap)
            worst_share = max(worst_share, gap / trace_us if trace_us > 0 else 0.0)
        stages_ms.append({k: v * 1e3 for k, v in ts.stage_spans(s).items()})
    mean = {k: sum(d[k] for d in stages_ms) / len(stages_ms) for k in stages_ms[0]}
    print(f"stage clock on {chip_smoke.card_line()}: {REPLAYS} replays at the KITTI shape, "
          f"largest gap to the trace {worst_us:.3f} us ({100 * worst_share:.3f}% of its "
          f"interval); mean ms " + ", ".join(f"{k} {v:.3f}" for k, v in mean.items()),
          flush=True)
