"""BENCHMARK.json keeps the contract's form, and every cell's files are
found by name, so that a cell added as files and manifest entries needs
no edit of a file that is there."""

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
MAN = harness.manifest()


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert MAN["paths"] == ["portbench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("group,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"})])
def test_entries_keep_to_their_keys_and_characters(group, keys):
    names = [e["name"] for e in MAN[group]]
    assert len(set(names)) == len(names)
    for e in MAN[group]:
        assert set(e) <= keys, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in e.get("reduced", ()):
            assert NAME.match(k)


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files_and_reports_its_metrics(cell):
    entry = harness.cell(MAN, cell)
    assert entry["chips"] == 1
    here = harness.HERE
    workload = harness.load_json(here / "workloads" / f"{cell}.json")
    assert workload["config"] == entry["config"]
    config = harness.load_json(here / "configs" /
                               f"{entry['config']}.json")
    assert config["name"] == entry["config"]
    assert (here / "drivers" / f"{workload['driver']}.py").is_file()
    e2e = harness.metrics_for(MAN, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.metrics_for(MAN, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(harness.load_module(
            here / "metrics" / f"{m['name']}.py").read)
    assert set(workload["limits"])


def test_config_files_match_the_manifest():
    for c in MAN["configs"]:
        cfg = harness.load_json(harness.REPO / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert c["file"].startswith("portbench/configs/")


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


ECHO = '''
def run(ctx):
    return {"setup_end": ctx.t_start + 1.5,
            "end_to_end": {"echo_rate": float(ctx.workload["traffic"]["n"])},
            "attempted": 3, "failed": 0, "device": {"platform": "cpu"},
            "checks": {"echo": 0.0}, "facts": {"n": 3},
            "trace": {"busy_s": 1.0, "window_s": 2.0,
                      "breakdown": {"device_ops": [], "idle_gaps": []}}}
'''


def test_a_cell_added_as_files_needs_no_edit(tmp_path):
    """A new workload, driver and metric in a copy of the benchmark are
    found by name, and no file that was there changes."""
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    before = _digests(tmp_path / "portbench")
    here = tmp_path / "portbench"
    (here / "drivers" / "echo.py").write_text(ECHO)
    (here / "metrics" / "echo.count.py").write_text(
        "def read(facts):\n    return facts['n'] * 2.0\n")
    (here / "workloads" / "echo.small.json").write_text(json.dumps(
        {"config": man["configs"][0]["name"], "driver": "echo",
         "traffic": {"n": 7}, "limits": {"echo": 0.0}}))
    man["workloads"].append({"name": "echo.small",
                             "config": man["configs"][0]["name"],
                             "traffic": "echo", "chips": 1, "why": "test"})
    man["end_to_end"].append({"name": "echo_rate", "unit": "1/s",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["echo.small"]})
    man["per_layer"].append({"name": "echo.count", "unit": "n",
                             "better": "higher", "source": "host_clock",
                             "layer": "echo", "moves": "echo_rate",
                             "workloads": ["echo.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    t0 = time.time()
    plain = harness.run_cell("echo.small", 1, 1.0, False, t0,
                             root=tmp_path, device="cpu")
    traced = harness.run_cell("echo.small", 1, 1.0, True, t0,
                              root=tmp_path, device="cpu")
    assert plain["correct"] and traced["correct"]
    assert plain["metrics"]["echo_rate"]["value"] == 7.0
    assert plain["metrics"]["setup_s"]["value"] == pytest.approx(1.5)
    assert traced["metrics"] == {"echo.count": {"value": 6.0,
                                                "unit": "n"}}
    after = _digests(tmp_path / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before
