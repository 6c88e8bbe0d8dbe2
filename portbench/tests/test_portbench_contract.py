"""``BENCHMARK.json`` keeps the contract's shape, and every name in it
finds its file."""

import json
import os
import re

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def _bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys_and_sizes():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["portbench"]
    assert all(TEXT.match(w) for w in b["command"])
    assert 1 <= len(b["configs"]) <= 24
    assert 1 <= len(b["workloads"]) <= 24
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_the_contract_keys_and_valid_names():
    b = _bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["source"] \
            == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and TEXT.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert os.path.exists(os.path.join(HERE, "layers",
                                           m["name"] + ".py"))
        assert TEXT.match(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_its_metrics_need():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}

    def cells(m):
        return m.get("workloads", [w["name"] for w in b["workloads"]])

    for w in b["workloads"]:
        own = [m for m in b["end_to_end"] if w["name"] in cells(m)]
        assert {"setup_s"} < {m["name"] for m in own}
        assert any(w["name"] in cells(m) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for c in cells(m):
            assert c in cells(e2e[m["moves"]])


def test_each_limit_is_set():
    b = _bench()
    for w in b["workloads"]:
        t = json.load(open(os.path.join(HERE, "traffic",
                                        w["traffic"] + ".json")))
        assert t["limits"] and all(v is not None and v >= 0
                                   for v in t["limits"].values())
