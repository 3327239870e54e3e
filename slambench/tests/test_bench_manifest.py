"""BENCHMARK.json keeps to the format the benchmark is checked against: its keys, names, units,
and a file for every configuration, traffic and metric it names."""

import json
import os
import re

import pytest

import cpu_route

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
ROOT = cpu_route.ROOT
# the numbers every configuration is judged on; a configuration may add
# loop_gap, and nothing else
CHECKS = {"ate_share", "desc_gap", "k1_gap"}


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def limits_ok(limits):
    return set(limits) in (CHECKS, CHECKS | {"loop_gap"})


@pytest.mark.parametrize("names, ok", [
    (CHECKS, True), (CHECKS | {"loop_gap"}, True), (CHECKS - {"k1_gap"}, False),
    (CHECKS - {"ate_share"} | {"loop_gap"}, False), (CHECKS | {"loop_rms"}, False),
    (CHECKS | {"loop_gap", "lap_share"}, False)])
def test_limits_take_the_three_numbers_and_loop_gap(names, ok):
    assert limits_ok(dict.fromkeys(names, 0.1)) == ok


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(m["paths"]) <= 16 and all(PATH.match(p) for p in m["paths"])
    assert all(not p.startswith("/") and ".." not in p.split("/") for p in m["paths"])
    assert 1 <= len(m["command"]) <= 32 and all(line_ok(w) for w in m["command"])
    for w in m["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in m["paths"]) and os.path.exists(
                os.path.join(ROOT, w))
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_units_and_keys():
    m = manifest()
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("slambench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            spec = json.load(f)
        assert spec["reduced"] == c["reduced"] and spec["source"] == c["source"]
        assert limits_ok(spec["limits"])
    configs = {c["name"] for c in m["configs"]}
    assert len(configs) == len(m["configs"])
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(ROOT, "slambench", "traffic", w["traffic"] + ".json"))
        names.add(w["name"])
    assert len(names) == len(m["workloads"])
    assert {w["config"] for w in m["workloads"]} == configs
    e2e = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in e2e
    metric_names = set()
    for e in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(e["name"]) and UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["name"] not in metric_names
        metric_names.add(e["name"])
        assert os.path.exists(os.path.join(ROOT, "slambench", "metrics", e["name"] + ".py"))
        for w in e.get("workloads", []):
            assert w in names
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    layers = {}
    for e in m["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line_ok(e["layer"]) and e["moves"] in e2e
        if e["name"].endswith("_roofline") or "mfu" in e["name"]:
            assert e["unit"] == "%"
    assert 1 <= len(m["per_layer"]) <= 128 and 1 <= len(m["end_to_end"]) <= 16


def test_check_budget_fits():
    m = manifest()
    assert 2 + 14 * 24 * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200 or \
        (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
