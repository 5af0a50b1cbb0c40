"""BENCHMARK.json and every file it names parse, and keep the contract's
shape: names, units, files under `paths`, a reader a metric, limits and
traffic a cell, an entry a configuration."""

import importlib
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["bench_port"]
    assert manifest["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_port/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert any(w["config"] == c["name"] for w in manifest["workloads"])


def test_workloads(manifest):
    seen = set()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        for part in ("traffic", w["traffic"]), ("limits", w["name"]):
            with open(os.path.join(ROOT, "bench_port", part[0],
                                   part[1] + ".json")) as f:
                data = json.load(f)
            if part[0] == "traffic":
                importlib.import_module(f"bench_port.entries.{data['entry']}")
                for check in data.get("checks", []):
                    mod = importlib.import_module(f"bench_port.checks.{check}")
                    assert callable(mod.numbers)


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names))
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        mod = importlib.import_module(f"bench_port.metrics.{m['name']}")
        assert callable(mod.read)
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["workloads"]
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in manifest["per_layer"])


def test_size(manifest):
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
