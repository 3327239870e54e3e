"""On the card: the controls of ``correct`` come out not correct and the
program comes out correct, at each cell's own size, on three seeds.

Run on a card from the checkout's root:
``python3 -m pytest slambench/tests/test_bench_control_card.py -m gpu``
(about 90 s a seed and cell)."""

import json
import math

import pytest
import torch

import cpu_route  # noqa: F401
import control
import run

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ("kitti.cruise", "euroc.mav"))
def test_controls_fail_and_the_program_passes(workload, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert control.main(["--workload", workload, "--seconds", "10", "--seeds",
                         *map(str, SEEDS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    with capsys.disabled():
        print("\n".join(lines))
    summary = json.loads(lines[-1])
    spec = run.load_json("slambench", "configs",
                         run.cell_of(run.load_json("BENCHMARK.json"), workload)["config"] + ".json")
    limits = spec["limits"]
    for name, v in summary["program_max"].items():
        assert math.isfinite(v) and v <= limits[name], (name, v)
    failed = [n for n, v in summary["control_min"].items() if v > limits[n]]
    assert failed, summary
    for name, v in summary["fault_min"].items():
        assert v > limits[name], (name, v)
