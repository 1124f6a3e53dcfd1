"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import re

import pytest

from benchmark import compare, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return manifest.benchmark()


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51 and isinstance(spec["run_seconds"], int)
    assert len(json.dumps(spec)) < 64 * 1024


def test_names_units_and_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and 0 < len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]} and UNIT.match(m["unit"])


@pytest.mark.parametrize("kind", ["config", "traffic", "flops", "cell", "metric"])
def test_every_file_found_by_name(spec, kind):
    for w in spec["workloads"]:
        traffic = manifest.traffic(w["traffic"])
        if kind == "config":
            assert manifest.config(w["config"])["name"] == w["config"]
        elif kind == "traffic":
            assert traffic["batch_size"] > 0 and traffic["n_frames"] > 0
        elif kind == "flops":
            assert manifest.flops(w["config"], traffic["batch_size"])["flops_per_step"] > 0
        elif kind == "cell":
            assert set(manifest.limits(w["name"])) == set(compare.NUMBERS)
            assert manifest.cell(w["name"])["window_epochs"] >= 1
    if kind == "metric":
        for m in spec["end_to_end"] + spec["per_layer"]:
            assert callable(manifest.metric_reader(m["name"]))


def test_warm_and_window_epochs_scale_with_the_run(spec):
    from benchmark import run

    for w in spec["workloads"]:
        cell = manifest.cell(w["name"])
        assert run.warm_epochs(w["name"], spec["run_seconds"]) == cell.get("warm_epochs", 1)
        assert run.window_epochs(w["name"], spec["run_seconds"]) == cell["window_epochs"]
        assert run.warm_epochs(w["name"], 0.1) == run.window_epochs(w["name"], 0.1) == 1


def test_each_cell_reports_setup_a_rate_and_per_layer_metrics(spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in manifest.reported(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = manifest.reported(w["name"], True)
        assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_split_metric_read_by_its_quantitys_reader():
    assert manifest.metric_reader("mfu_pct.full5").__module__ == "benchmark.metrics.mfu_pct"


def test_config_files_are_the_configs(spec):
    for c in spec["configs"]:
        data = manifest.config(c["name"])
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
