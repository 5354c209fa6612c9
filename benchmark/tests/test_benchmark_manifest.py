"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

import json
import re

import pytest
from conftest import BENCH, ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(TEXT.match(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in MANIFEST["paths"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_have_the_contracts_keys_and_names(section, keys):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) - {"workloads"} == keys if section in ("end_to_end", "per_layer") \
            else set(e) == keys
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        if section == "configs":
            assert all(NAME.match(k) for k in e["reduced"]) and len(e["reduced"]) <= 16
        if section == "workloads":
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
            assert e["chips"] in (1, 4)


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for s in ("end_to_end", "per_layer") for m in MANIFEST[s]]
    assert len(set(names)) == len(names)


def test_bounds_and_sources():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in MANIFEST["end_to_end"])
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MANIFEST["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in cells:
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in MANIFEST["per_layer"] if cell in m.get("workloads", [])]
        assert layers and all(m["moves"] in e2e for m in layers)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_named_file_is_under_paths():
    paths = [ROOT / p for p in MANIFEST["paths"]]
    under = lambda f: any(paths_i in f.parents for paths_i in paths)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        f = ROOT / c["file"]
        assert f.is_file() and under(f)
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_benchmark_files_are_named_from_name_characters():
    for f in BENCH.rglob("*"):
        if "__pycache__" in f.parts:
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


def test_shares_of_a_peak_are_named_for_the_driver():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
