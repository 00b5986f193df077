"""BENCHMARK.json against the benchmark's contract: keys, names, units,
files found by name, and the chip time a full check takes."""

import json
import math
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51


def test_chip_time_of_a_full_check(bench):
    """2 + 14 runs a cell, each run_seconds + 60 s, 2 x 90 s of compile a
    cell and 1200 s spare fit 43200 s with the full 24 cells."""
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_configs(bench):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            config = json.load(f)
        assert config["name"] == c["name"]
        assert c["reduced"] == config["reduced"] == []
        assert "assumed" in config and "guarantees" in config


def test_workloads(bench):
    assert 1 <= len(bench["workloads"]) <= 24
    pairs, names = set(), set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["name"] not in names
        names.add(w["name"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert os.path.isfile(os.path.join(ROOT, "portbench", "traffic",
                                           w["traffic"] + ".json"))
    four = sum(1 for w in bench["workloads"] if w["chips"] == 4)
    assert four <= max(1, math.floor(len(bench["workloads"]) * 0.25))


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    seen = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in seen
        seen.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for cell in cells:
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["end_to_end"] if m["name"] != "setup_s")
        assert any(cell in m.get("workloads", [cell])
                   for m in bench["per_layer"])


def test_every_file_is_named_from_name_characters():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        if "__pycache__" in dirpath:
            continue
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
            assert PATH.match(rel), rel
