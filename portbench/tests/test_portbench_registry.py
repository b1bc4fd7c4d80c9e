"""Every cell, configuration, traffic mix, limit file and per-layer metric
of the manifest is found by its name, and the manifest keeps the
benchmark's rules of names, units and keys."""

import json
import re

import pytest

from portbench.registry import PACKAGE_DIR, Registry, check_name

REG = Registry()
MANIFEST = REG.manifest
CELLS = [c["name"] for c in MANIFEST["workloads"]]
METRICS = [m["name"] for m in MANIFEST["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    c = REG.cell(cell)
    cfg = REG.config(c["config"])
    assert cfg["name"] == c["config"]
    traffic = REG.traffic(c["traffic"])
    kind = REG.kind(traffic["kind"])
    for fn in ("setup", "window", "end_to_end", "release", "check"):
        assert callable(getattr(kind, fn))
    assert set(REG.limits(cell)) and all(
        isinstance(v, (int, float)) for v in REG.limits(cell).values())
    assert c["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in REG.end_to_end(cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert REG.per_layer(cell)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_by_name(metric):
    reader = REG.reader(metric)
    assert callable(reader.read)
    m = next(m for m in MANIFEST["per_layer"] if m["name"] == metric)
    assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}
    for cell in m["workloads"]:
        assert m["moves"] in [e["name"] for e in REG.end_to_end(cell)]


def test_manifest_names_units_and_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = []
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        names += [w["name"], w["config"], w["traffic"]]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound",
                                          "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for name in names:
        assert NAME.match(name), name
        check_name(name)
    assert len(json.dumps(MANIFEST)) < 64 * 1024


def test_names_refuse_paths():
    for bad in ("../x", "a/b", "", ".hidden", "a b"):
        with pytest.raises(ValueError):
            check_name(bad)


def test_every_file_is_named_from_a_name():
    for p in PACKAGE_DIR.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts and "out" not in p.parts:
            rel = p.relative_to(PACKAGE_DIR.parent).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
