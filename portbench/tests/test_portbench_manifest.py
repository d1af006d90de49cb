"""BENCHMARK.json keeps the contract's form, and every cell's files are
found by name, so that a cell added as files and manifest entries needs
no edit of a file that is there: with a driver of its own, or on four
chips, too. Each check is a function of a manifest and its checkout, so
that a copy of the benchmark with a stub cell added is held to them."""

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest

from portbench import calibrate, harness
from portbench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
MAN = harness.manifest()
GROUPS = [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"})]


def check_top_level(man):
    assert set(man) == KEYS
    assert man["command"] == ["python3", "portbench/run.py"]
    assert man["paths"] == ["portbench"]
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024


def check_entries(man, group, keys):
    names = [e["name"] for e in man[group]]
    assert len(set(names)) == len(names)
    for e in man[group]:
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


def check_bounds_and_sources(man):
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def check_cell(man, here, cell):
    """Cell ``cell`` of ``man`` finds its files under ``here`` (the
    checkout's ``portbench/``) and reports its metrics."""
    entry = harness.cell(man, cell)
    assert entry["chips"] in (1, 4)
    workload = harness.load_json(here / "workloads" / f"{cell}.json")
    assert workload["config"] == entry["config"]
    config = harness.load_json(here / "configs" /
                               f"{entry['config']}.json")
    assert config["name"] == entry["config"]
    for d in ("drivers", "tests/narrow", "calibration"):
        path = here / d / f"{workload['driver']}.py"
        assert path.is_file(), f"{cell}: {path} is missing"
    e2e = harness.metrics_for(man, cell, False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = harness.metrics_for(man, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in names
        assert callable(harness.load_module(
            here / "metrics" / f"{m['name']}.py").read)
    assert set(workload["limits"])


def check_four_chip_share(man):
    """At most a quarter of the cells, rounded down, ask for four chips;
    one always may."""
    cells = man["workloads"]
    four = [w["name"] for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4), four


def check_configs(man, root):
    for c in man["configs"]:
        cfg = harness.load_json(root / c["file"])
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
        assert c["file"].startswith("portbench/configs/")


def check_all(man, root):
    check_top_level(man)
    for group, keys in GROUPS:
        check_entries(man, group, keys)
    check_bounds_and_sources(man)
    check_four_chip_share(man)
    check_configs(man, root)
    for w in man["workloads"]:
        check_cell(man, root / "portbench", w["name"])


def test_top_level_keys_and_command():
    check_top_level(MAN)


@pytest.mark.parametrize("group,keys", GROUPS)
def test_entries_keep_to_their_keys_and_characters(group, keys):
    check_entries(MAN, group, keys)


def test_bounds_and_sources():
    check_bounds_and_sources(MAN)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files_and_reports_its_metrics(cell):
    check_cell(MAN, harness.HERE, cell)


def test_at_most_a_quarter_of_the_cells_ask_for_four_chips():
    check_four_chip_share(MAN)
    with pytest.raises(AssertionError):
        check_four_chip_share({"workloads": [
            {"name": f"c{i}", "chips": 4 if i < 2 else 1}
            for i in range(7)]})
    check_four_chip_share({"workloads": [
        {"name": f"c{i}", "chips": 4 if i < 2 else 1} for i in range(8)]})


def test_config_files_match_the_manifest():
    check_configs(MAN, harness.REPO)


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


NARROW = """
def overrides(workload, config, tmp_path):
    return {}, {"traffic": {"n": 3}}
"""

CALIBRATION = """
def rows(ctx_of, seeds, control, seconds):
    for i, seed in enumerate(seeds):
        ctx = ctx_of(seed)
        row = {"seed": seed, "program": {"echo": 0.0}}
        if i < control:
            row["control"] = {"echo": float(ctx.workload["traffic"]["n"])}
        yield row
"""


def _stub_checkout(tmp_path, narrow=True):
    """A copy of the benchmark with the driver ``echo`` added as files:
    its narrow CPU copy (unless ``narrow`` is false), its control
    readings, a configuration, its cells ``echo.small`` on one chip and
    ``echo.wide`` on four, an end-to-end metric and a per-layer reader.
    Returns the copy's root and the digests of the files it had."""
    root = tmp_path / "root"
    here = root / "portbench"
    shutil.copytree(harness.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(here)
    man = json.loads((harness.REPO / "BENCHMARK.json").read_text())
    (here / "drivers" / "echo.py").write_text(ECHO)
    if narrow:
        (here / "tests" / "narrow" / "echo.py").write_text(NARROW)
    (here / "calibration" / "echo.py").write_text(CALIBRATION)
    (here / "metrics" / "echo.count.py").write_text(
        "def read(facts):\n    return facts['n'] * 2.0\n")
    config = {"name": "echo-config", "source": "a test", "reduced": [],
              "file": "portbench/configs/echo-config.json", "why": "test"}
    (here / "configs" / "echo-config.json").write_text(json.dumps(
        {k: config[k] for k in ("name", "source", "reduced")}))
    man["configs"].append(config)
    cells = {"echo.small": 1, "echo.wide": 4}
    for cell, chips in cells.items():
        (here / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"config": "echo-config", "driver": "echo",
             "traffic": {"n": 7}, "limits": {"echo": 0.5}}))
        man["workloads"].append({"name": cell, "config": "echo-config",
                                 "traffic": "echo", "chips": chips,
                                 "why": "test"})
    man["end_to_end"].append({"name": "echo_rate", "unit": "1/s",
                              "better": "higher", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": list(cells)})
    man["per_layer"].append({"name": "echo.count", "unit": "n",
                             "better": "higher", "source": "host_clock",
                             "layer": "echo", "moves": "echo_rate",
                             "workloads": list(cells)})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root, before


def test_a_driver_of_its_own_and_a_four_chip_cell_join_as_files(tmp_path):
    """The manifest checks, the narrow CPU run and the control readings
    take a cell with a driver of its own, and a second cell of it on four
    chips, from new files only."""
    root, before = _stub_checkout(tmp_path)
    here = root / "portbench"
    man = harness.manifest(root)
    check_all(man, root)
    assert {"echo.small", "echo.wide"} <= {w["name"]
                                           for w in man["workloads"]}
    for cell in ("echo.small", "echo.wide"):
        assert tiny.overrides(cell, tmp_path, root) == (
            {}, {"traffic": {"n": 3}})
    result = tiny.run("echo.small", tmp_path, root=root)
    assert result["correct"]
    assert result["metrics"]["echo_rate"]["value"] == 3.0
    workload = harness.load_json(here / "workloads" / "echo.wide.json")

    def ctx_of(seed):
        return harness.Context("echo.wide", workload, {}, seed, 1.0, False,
                               0.0, "cpu")

    rows = list(calibrate.control_rows(workload["driver"], here)(
        ctx_of, [5, 6], 1, 1.0))
    assert [r["seed"] for r in rows] == [5, 6]
    limits = workload["limits"]
    assert all(r["program"][k] <= v for r in rows for k, v in limits.items())
    assert any(rows[0]["control"][k] > v for k, v in limits.items())
    assert "control" not in rows[1]
    after = _digests(here)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_driver_without_a_narrow_copy_fails_by_name(tmp_path):
    root, _ = _stub_checkout(tmp_path, narrow=False)
    missing = r"tests/narrow/echo\.py is missing"
    with pytest.raises(FileNotFoundError, match=missing):
        tiny.run("echo.small", tmp_path, root=root)
    with pytest.raises(AssertionError, match=missing):
        check_cell(harness.manifest(root), root / "portbench", "echo.small")
    with pytest.raises(FileNotFoundError, match=r"calibration/mute\.py"):
        calibrate.control_rows("mute", root / "portbench")
