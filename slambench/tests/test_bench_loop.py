"""A small run on the circle closes a loop inside its window, and judges
it: the program's ``loop_gap`` is at most a third of the one that the fault
"a loop found and counted but not corrected" leaves, and the fault's run
records its loops all the same.

The runs skip the harness's look for a card and go through the rest of a
run on the CPU, at the small configuration of ``kitti.cruise``
(``cpu_route.small``) on ``worlds/circle.py`` with a lap of 80 frames at
0.3 m (the loop phase's circle, in fewer frames), with K1's wrapper on the
searches' route.  The warm-up ends before the lap does, and each window
ends at the first frame after a loop closed in it, so both runs judge one
loop: this seed's closed at frame 117, matched to frame 38, some 32 frames
into the window, where the program read 0.00058 and the fault 0.053.
About three minutes a run on three torch threads, two runs."""

import math

import torch

import cpu_route
import control

SEED = 2 ** 31 + 12347
LOOP_TRAFFIC = dict(world="circle", step_m=0.3, lap_frames=80, n_boxes=6, tex_scale=0.4,
                    warmup_frames=85, max_fps=1.5)


def test_small_circle_closes_a_loop_and_judges_it():
    torch.set_num_threads(3)
    slam, _ = cpu_route.small("kitti.cruise")
    with cpu_route.kernel_route():
        r = control.readings("kitti.cruise", SEED, 240.0, device="cpu", slam_overrides=slam,
                             traffic_overrides=LOOP_TRAFFIC, until_loop=True,
                             loop_faults=("fault_loop_uncorrected",))
    loop = r["loop"]
    assert loop is not None, r
    program, fault = loop["program"], loop["fault_loop_uncorrected"]
    assert len(program["loops"]) == len(fault["loops"]) == 1, loop
    assert all(f1 >= LOOP_TRAFFIC["warmup_frames"] for _, f1 in program["loops"]), loop
    assert math.isfinite(program["loop_gap"]) and math.isfinite(fault["loop_gap"]), loop
    assert program["loop_gap"] <= fault["loop_gap"] / 3, loop
    # kitti's limits do not name loop_gap: the run itself judged three numbers
    assert set(r["program"]) == {"ate_share", "desc_gap", "k1_gap"}, r
