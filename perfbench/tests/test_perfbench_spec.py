"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import os
import re

import pytest

from perfbench import spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in B["workloads"]]


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(B["command"]) <= 32 and all(line(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    files = [w for w in B["command"] if "/" in w or w.endswith(".py")]
    assert all(any(f.startswith(p + "/") for p in B["paths"]) for f in files)
    assert len(open(os.path.join(spec.ROOT, "BENCHMARK.json"), "rb").read()) <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in B["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    assert len({c["file"] for c in B["configs"]}) == len(names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("perfbench/") and os.path.exists(
            os.path.join(spec.ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert c["name"] in {w["config"] for w in B["workloads"]}


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in B["configs"]}
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(CELLS) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert 1 <= len(B["per_layer"]) <= 128
    layers: dict[str, str] = {}
    for m in B["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved)
        spec.layer_reader(m["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(CELLS)
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_enough(cell):
    c = spec.Cell(B, cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert callable(spec.loop_class(c.traffic["loop"]))
    assert callable(spec.generator(c.traffic["content"]))
    assert c.config["name"] == c.workload["config"]
    assert not c.config["reduced"]


def test_discovery_by_name():
    read, part = spec.layer_reader("device_idle_pct.seek")
    assert callable(read) and part == "seek"
    with pytest.raises(FileNotFoundError):
        spec.layer_reader("no_such_metric.encode")
    with pytest.raises(FileNotFoundError):
        spec.loop_class("no_such_loop")
    with pytest.raises(FileNotFoundError):
        spec.generator("no_such_content")
    assert spec.kernel_bytes("frames_to_cubes_kernel") is not None
    assert spec.kernel_bytes("no_such_kernel") is None
    with pytest.raises(KeyError):
        spec.Cell(B, "no.such.cell")
    assert spec.peaks()["hbm_bytes_per_s"] == 3.35e12
