"""BENCHMARK.json keeps the contract's shape: names, units, files, and a
reader for every per-layer metric."""

from __future__ import annotations

import json
import os
import re

from portbench import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def bench():
    with open(os.path.join(common.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert all(PATH.match(p) and ".." not in p for p in b["paths"])
    names = [c["name"] for c in b["configs"]]
    cells = [w["name"] for w in b["workloads"]]
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        assert os.path.exists(os.path.join(common.ROOT, c["file"]))
        assert c["name"] in {w["config"] for w in b["workloads"]}
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert os.path.exists(os.path.join(
            common.HERE, "traffic", w["traffic"] + ".json"))
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        if m["source"] == "device_trace":  # read by a reader of its own
            assert callable(common.load_reader(m["name"]))
    layers = set()
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        assert os.path.exists(os.path.join(common.HERE, "metrics",
                                           m["name"] + ".py"))
        assert callable(common.load_reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.add(m["layer"])
    # every cell reports setup_s, another end-to-end metric and a per-layer
    for c in cells:
        assert sum(1 for m in b["end_to_end"]
                   if c in m.get("workloads", cells)) >= 2
        assert any(c in m["workloads"] for m in b["per_layer"])


def test_budget_fits_24_cells():
    b = bench()
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(b)) <= 64 * 1024
