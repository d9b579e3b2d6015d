"""BENCHMARK.json against the contract's rules, and every configuration,
traffic mix, limit file and per-layer metric found by name from files."""

import json
import os
import re
import shutil

import pytest

from mdbench.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|"
                    r"expansion|experts_per_tok|embedding")


@pytest.fixture
def bench(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and len(bench["command"]) <= 32
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(root, p))
    for word in bench["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024


def test_entries(bench, root):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(root, c["file"]))
        assert len(c["reduced"]) <= 16
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    used = {w["config"] for w in bench["workloads"]}
    assert used == names
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in bench["workloads"]:
        mine = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["per_layer"])


def test_layers_spelled_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"loop", "forward", "fit", "host env", "kernels", "device"}


def test_everything_found_by_name(bench, root):
    man = Manifest.load(root)
    for w in bench["workloads"]:
        cell = man.cell(w["name"])
        assert man.config(cell["config"])["name"] == cell["config"]
        traffic = man.traffic(cell["traffic"])
        assert man.kind(traffic).run
        assert man.limits(cell["name"])
    for m in bench["per_layer"]:
        assert callable(man.reader(m["name"]))
        assert man.reader(m["name"])({}) is None     # nothing to read: nothing returned


def test_new_cell_is_files_only(bench, root, tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer metric
    added as new files, with entries in BENCHMARK.json, are found with no
    edit to any file that is there."""
    here = tmp_path / "mdbench"
    shutil.copytree(os.path.join(root, "mdbench"), here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "configs" / "dummy.json").write_text(json.dumps({"name": "dummy", "variant": "unit_cost"}))
    (here / "traffic" / "dummy_mix.json").write_text(json.dumps({"kind": "dismantle", "n": 8}))
    (here / "limits" / "dummy.dummy_mix.json").write_text(json.dumps({"limits": {"q_err": 1.0}}))
    (here / "metrics" / "dummy_ms.dismantle.py").write_text("def read(layer):\n    return 42.0\n")
    b = json.loads(json.dumps(bench))
    b["configs"].append({"name": "dummy", "source": "https://example.org", "reduced": [],
                         "file": "mdbench/configs/dummy.json", "why": "a test"})
    b["workloads"].append({"name": "dummy.dummy_mix", "config": "dummy", "traffic": "dummy_mix",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy_ms.dismantle", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "loop", "moves": "removals_per_s",
                           "workloads": ["dummy.dummy_mix"]})
    man = Manifest(b, here=str(here))
    cell = man.cell("dummy.dummy_mix")
    assert man.config(cell["config"])["name"] == "dummy"
    assert man.traffic(cell["traffic"])["n"] == 8
    assert man.limits(cell["name"]) == {"q_err": 1.0}
    assert [m["name"] for m in man.per_layer("dummy.dummy_mix")] == ["dummy_ms.dismantle"]
    assert man.reader("dummy_ms.dismantle")({}) == 42.0
