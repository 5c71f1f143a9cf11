"""``BENCHMARK.json`` holds to the benchmark's contract, and every name in
it resolves to its file."""
import json
import re

import pytest

from bench import harness, plugins
from bench.reference import gnn

SPEC = json.loads(harness.SPEC.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(harness.SPEC.read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_each_configuration_resolves_to_its_file(cfg):
    path = harness.ROOT / cfg["file"]
    assert path == harness.BENCH / "configs" / f"{cfg['name']}.json"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert data[key] != data["published"][key]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_to_its_files(cell):
    spec = harness.cell_spec(cell["name"])
    assert spec["workload"]["config"] == cell["config"]
    assert spec["workload"]["traffic"] == cell["traffic"]
    assert set(spec["workload"]["limits"]) == {"max_rel_err"}
    traffic, cfg = spec["traffic"], spec["config"]
    kind = plugins.load("traffic/kinds", traffic["kind"])
    assert callable(kind.Inputs)
    assert callable(plugins.load("traffic/loops", traffic["loop"]).window)
    assert callable(plugins.load("programs", cfg["family"]).Program)
    e2e = {m["name"] for m in harness.cell_metrics(cell["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(cell["name"], True)


@pytest.mark.parametrize("cfg", [c for c in SPEC["configs"] if json.loads(
    (harness.ROOT / c["file"]).read_text())["family"] == "gnn"],
    ids=lambda c: c["name"])
def test_each_gnn_configuration_names_its_parts(cfg):
    """A configuration of the ``gnn`` family names a model with a plain
    reference of every part, and the program's two graph inputs."""
    data = json.loads((harness.ROOT / cfg["file"]).read_text())
    model = gnn.model(data["model"])
    for part in ("normalize", "weight_shapes", "forward", "needed_macs"):
        assert callable(getattr(model, part))
    assert set(data["program"]["inputs"]) == {"adjacency", "features"}


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_its_reader(metric):
    assert callable(harness.reader(metric["name"]))


@pytest.mark.parametrize("folder,name", [
    ("traffic/kinds", "no-such-kind"), ("traffic/loops", "open"),
    ("reference/models", "gat"), ("metrics", "no_such_metric"),
    ("traffic/kinds", "../generator"), ("programs", "no-such-family")])
def test_an_unknown_part_is_refused(folder, name):
    with pytest.raises(LookupError):
        plugins.load(folder, name)
