"""The benchmark's definition: every file it names is found by name, each
cell reports what its metrics move, the contract's limits on names, units
and bounds hold, and a new configuration, cell and metric take only new
files."""

import json
import os
import re
import shutil

import pytest

from bench_helpers import ROOT
from benchmark.harness.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return Spec()


def test_every_named_file_is_found(spec):
    cells = [c["name"] for c in spec.data["workloads"]]
    for c in spec.data["workloads"]:
        spec.check_cell(c["name"])
        conf = spec.config(c["config"])
        assert conf["name"] == c["config"]
        traffic = spec.traffic(c["traffic"])
        assert os.path.exists(os.path.join(
            spec.bench_dir, "drivers", traffic["driver"] + ".py"))
        limits = spec.limits(c["name"])["numbers"]
        for lim in limits.values():
            assert lim["lower"] < lim["limit"] < lim["upper"]
            assert lim["upper"] >= 3 * lim["lower"]
    for m in spec.data["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert set(m.get("workloads", cells)) <= set(cells)
    for entry in spec.data["configs"]:
        assert entry["file"].startswith(tuple(spec.data["paths"]))


def test_the_contract_limits_hold(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in d[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in d["end_to_end"]} >= {"setup_s"}
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in d["workloads"]:
        assert c["chips"] == 1 and len(c["why"]) <= 200
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    pairs = [(c["config"], c["traffic"]) for c in d["workloads"]]
    assert len(pairs) == len(set(pairs))
    for conf in d["configs"]:
        data = spec.config(conf["name"])
        assert conf["reduced"] == data["reduced"]
        assert all(k in data for k in conf["reduced"])
    assert len(json.dumps(d)) < 64 * 1024


def test_a_cell_whose_metric_moves_an_unreported_metric_is_refused(
        tmp_path, spec):
    data = json.loads(json.dumps(spec.data))
    for m in data["per_layer"]:
        if m["name"] == "host_ms.single":
            m["workloads"] = ["urban.sweep_tta"]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    bad = Spec(path=str(path))
    with pytest.raises(ValueError, match="serve_p95_ms"):
        bad.check_cell("urban.sweep_tta")


def test_a_new_configuration_cell_and_metric_take_only_new_files(tmp_path):
    """A throwaway configuration, traffic mix, cell and metric, added as
    files beside copies of the benchmark's, are found by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    conf = json.load(open(bench / "configs" / "uemda_r50_2urban.json"))
    conf.update(name="throwaway", arch="resnet18")
    (bench / "configs" / "throwaway.json").write_text(json.dumps(conf))
    traffic = json.load(open(bench / "traffic" / "sweep_tta.json"))
    traffic["batch"] = 2
    (bench / "traffic" / "sweep_b2.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "tiles.sweep.py").write_text(
        "def read(run):\n    return run['layer'].get('views')\n")
    (bench / "limits" / "throwaway.sweep_b2.json").write_text(
        (bench / "limits" / "urban.sweep_tta.json").read_text())
    data["configs"].append({"name": "throwaway", "source": "x",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": [], "why": "test"})
    data["workloads"].append({"name": "throwaway.sweep_b2",
                              "config": "throwaway", "traffic": "sweep_b2",
                              "chips": 1, "why": "test"})
    data["end_to_end"][1]["workloads"].append("throwaway.sweep_b2")
    data["per_layer"].append({"name": "tiles.sweep", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "serving loop",
                              "moves": "serve_mpix_per_s",
                              "workloads": ["throwaway.sweep_b2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    new = Spec(root=str(tmp_path), bench_dir=str(bench))
    new.check_cell("throwaway.sweep_b2")
    assert new.config("throwaway")["arch"] == "resnet18"
    assert new.traffic("sweep_b2")["batch"] == 2
    assert new.limits("throwaway.sweep_b2")["numbers"]["gap"]["limit"] > 0
    names = [m["name"] for m in new.per_layer("throwaway.sweep_b2")]
    assert names == ["tiles.sweep"]
    assert new.reader("tiles.sweep")({"layer": {"views": 7}}) == 7
