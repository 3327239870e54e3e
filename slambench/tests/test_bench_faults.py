"""A run of each cell with the timed path broken underneath the harness
comes out not correct, and the same run unbroken comes out correct.

The runs skip the harness's look for a card and go through the rest of a
run on the CPU, at a small configuration of the cell (``cpu_route.small``),
with K1's wrapper on the searches' route (``cpu_route.kernel_route``).
About a minute a run on two torch threads."""

import traceback

import pytest
import torch

import cpu_route
import run

WORKLOADS = ("kitti.cruise", "euroc.mav")
SEED = 2 ** 31 + 12345


def small_run(workload, seconds=16.0):
    torch.set_num_threads(2)
    slam, traffic = cpu_route.small(workload)
    with cpu_route.kernel_route():
        return run.run_cell(workload, SEED, seconds, False, device="cpu", slam_overrides=slam,
                            traffic_overrides=traffic)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    out = small_run(workload)
    assert out["line"]["correct"], out["checks"]
    assert out["line"]["attempted"] > 0


@pytest.mark.parametrize("kind", cpu_route.FAULTS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_run_is_not_correct(workload, kind):
    """Not correct, or a crash inside the program, which prints no result
    and exits non-zero: the check refuses either."""
    with cpu_route.fault(kind):
        try:
            out = small_run(workload)
        except Exception as e:  # noqa: BLE001 - a crash is an outcome here
            frames = traceback.extract_tb(e.__traceback__)
            assert "asdslam_torch" in frames[-1].filename, "".join(traceback.format_tb(
                e.__traceback__))
            return
    assert not out["line"]["correct"], out["checks"]


def test_funnel_warm_up_fails_where_the_program_lacks_its_hooks():
    """A rename inside the program fails the run rather than moving the loop
    funnel's first run into the window unseen."""
    import types

    mapping = run.plugin("sessions", "mapping")
    for drop in mapping.FUNNEL_HOOKS + ("_map_stream",):
        lc = types.SimpleNamespace(_compute_sim3_and_correct=None, _correct_loop=None,
                                   counters={})
        tracker = types.SimpleNamespace(_map_stream=None)
        delattr(tracker if drop == "_map_stream" else lc, drop)
        system = types.SimpleNamespace(loop_closer=lc, store=None, tracker=tracker)
        with pytest.raises(RuntimeError, match="cannot reach"):
            mapping.warm_loop_funnel(system, print)
