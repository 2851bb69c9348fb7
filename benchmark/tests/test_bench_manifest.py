"""BENCHMARK.json against the rules its format sets, and every file a cell
needs found by its name."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_sizes():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and 1 <= len(m["configs"]) <= 24
    assert 1 <= len(m["workloads"]) <= 24
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(m["command"]) <= 32
    for word in m["command"]:
        assert LINE.match(word) and not word.startswith("/") and \
            ".." not in word.split("/")
    for path in m["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert not path.endswith("_torch")


def test_names_and_units():
    m = manifest()
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    for name in names:
        assert NAME.match(name), name
    metric_names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in m["workloads"]}) == len(m["workloads"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(x["unit"]), x["unit"]
        assert x["better"] in ("lower", "higher")
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert x["moves"] in e2e and LINE.match(x["layer"])
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        for key in c["reduced"]:
            assert NAME.match(key)


def test_cells_take_one_chip_and_pair_once():
    m = manifest()
    configs = {c["name"] for c in m["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in configs
        assert NAME.match(w["traffic"]) and LINE.match(w["why"])
    assert configs == {w["config"] for w in m["workloads"]}


def test_check_fits_the_time_of_a_full_check():
    m = manifest()
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", [w["name"]
                                      for w in manifest()["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(workload):
    import harness
    import inputs
    entry, config, traffic = inputs.cell_files(workload)
    assert {"scene", "camera", "resolution", "settings",
            "frames_in_flight"} <= set(config)
    assert {"lights", "settings", "warmup_frames", "check"} <= set(traffic)
    assert callable(inputs.load_module(
        "scenes", config["scene"]["generator"]).write)
    assert callable(inputs.load_module(
        "layouts", traffic["lights"]["layout"]).lights)
    limits = inputs.read_json("checks", f"{workload}.json")["limits"]
    assert limits and set(limits) <= {"mean_abs_diff", "far_pixel_share"}
    counts = inputs.read_json("counts", f"{workload}.json")
    for trace in (False, True):
        for metric in harness.cell_metrics(workload, trace):
            assert callable(harness.load_reader(metric["name"]))
            if metric["name"].endswith("_roofline"):
                kernel = metric["name"].split("_")[0]
                assert {"operations", "bytes"} <= set(counts[kernel])
    for c in manifest()["configs"]:
        if c["name"] == entry["config"]:
            path = os.path.join(ROOT, c["file"])
            assert os.path.exists(path)
            with open(path) as f:
                assert json.load(f)["reduced"] == c["reduced"]


def test_every_cell_reports_enough():
    m = manifest()
    for w in m["workloads"]:
        def applies(x):
            return "workloads" not in x or w["name"] in x["workloads"]
        e2e = [x["name"] for x in m["end_to_end"] if applies(x)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(applies(x) for x in m["per_layer"])
