"""``BENCHMARK.json`` and the files it names: the contract's form, and every
cell, configuration, traffic mix, limit file and metric reader in place."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from portbench import harness
from portbench.reference import compare

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["portbench"]
    assert all(isinstance(w, str) and 1 <= len(w) <= 200 for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [x["name"] for x in MANIFEST[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_form(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in MANIFEST["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_reader_declares_the_same(metric):
    """Each metric has its reader, ``metrics/<name>.py``, which declares the
    unit, source and, for a per-layer metric, layer and ``moves`` that
    ``BENCHMARK.json`` gives it."""
    mod = importlib.import_module(f"portbench.metrics.{metric['name']}")
    assert callable(mod.read)
    assert (mod.UNIT, mod.SOURCE) == (metric["unit"], metric["source"])
    if "layer" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])


def test_setup_s_is_there():
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25


@pytest.mark.parametrize("metric", MANIFEST["per_layer"],
                         ids=[m["name"] for m in MANIFEST["per_layer"]])
def test_moves_is_reported_by_each_of_its_cells(metric):
    cells = metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])
    for cell in cells:
        assert metric["moves"] in harness.Cell(cell, MANIFEST).end_to_end


def check_cell(w: dict, manifest: dict) -> None:
    """The cell's configuration, traffic and limits exist, its agent family
    has an adapter and a count module, its limits name numbers that its
    adapter compares, and it reports set-up, another end-to-end metric and
    a per-layer metric."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    cell = harness.Cell(w["name"], manifest)
    assert cell.config["name"] == w["config"]
    assert cell.traffic["num_envs"] > 0 and cell.traffic["checked_iterations"] == 3
    assert cell.limits and set(cell.limits) <= set(cell.adapter_module.NUMBERS)
    assert callable(cell.adapter_module.Adapter)
    assert callable(cell.counts_module.iteration_flops)
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2 and cell.per_layer
    for m in manifest["per_layer"]:
        if m["name"] in cell.per_layer:
            assert m["moves"] in cell.end_to_end, m["name"]


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=[w["name"] for w in MANIFEST["workloads"]])
def test_cell_files(w):
    check_cell(w, MANIFEST)


@pytest.mark.parametrize("family", ["ppo_gae", "ppo_gae_liquid"])
def test_ppo_adapters_compare_the_reference_numbers(family):
    mod = importlib.import_module(f"portbench.trainers.{family}")
    assert mod.NUMBERS == compare.NUMBERS


def test_configurations():
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(MANIFEST["workloads"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("portbench/")
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"] and body["source"] == c["source"]


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


def test_run_seconds_fit_a_full_check():
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s of compiling per cell and 1,200 s spare, within 43,200 s."""
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
