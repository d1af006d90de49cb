"""A narrow copy of the benchmark's cells for its CPU tests, and a short
run of a cell through the harness on the CPU. What the copy narrows
depends on the cell's driver: ``narrow/<driver>.py`` beside this file
has ``overrides(workload, config, tmp_path) -> (config_override,
workload_override)``.

A configuration with a driver of its own joins as new files: its
``drivers/``, ``tests/narrow/`` and ``calibration/`` files, configuration,
workload and readers, and entries in BENCHMARK.json; it edits no file.
"""

from __future__ import annotations

import json
import time

from portbench import harness
from portbench.tests.narrow.train_cached import (  # noqa: F401
    STAGE, TINY_MODEL, generator_shapes, write_weights)

SEED = (1 << 31) + 12345

# cells whose files the benchmark keeps for a later manifest entry
KEPT = ["serve.single-client", "serve.closed-mixed"]
CELLS = [w["name"] for w in harness.manifest()["workloads"]] + [
    c for c in KEPT
    if c not in {w["name"] for w in harness.manifest()["workloads"]}]


def root_for(cell: str, tmp_path):
    """The checkout's root, or for a cell the manifest leaves out a root
    whose ``BENCHMARK.json`` adds it beside the same ``portbench/``."""
    man = harness.manifest()
    if any(w["name"] == cell for w in man["workloads"]):
        return harness.REPO
    workload = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    man["workloads"].append({"name": cell, "config": workload["config"],
                             "traffic": "kept", "chips": 1,
                             "why": "a test of the files kept for it"})
    root = tmp_path / "root"
    root.mkdir(exist_ok=True)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    if not (root / "portbench").exists():
        (root / "portbench").symlink_to(harness.HERE)
    return root


def narrow(driver: str, here=harness.HERE):
    """The module ``tests/narrow/<driver>.py`` under ``here``."""
    path = here / "tests" / "narrow" / f"{driver}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"driver {driver!r} has no narrow CPU copy: {path} is missing")
    return harness.load_module(path)


def overrides(cell: str, tmp_path, root=harness.REPO):
    """``(config_override, workload_override)`` of the narrow copy."""
    here = root / "portbench"
    workload = harness.load_json(here / "workloads" / f"{cell}.json")
    config = harness.load_json(here / "configs" /
                               f"{workload['config']}.json")
    return narrow(workload["driver"], here).overrides(workload, config,
                                                      tmp_path)


def run(cell: str, tmp_path, seconds: float = 2.0, trace: bool = False,
        traffic=None, root=None):
    """One run of the narrow copy of ``cell`` on the CPU, its traffic
    parameters changed by ``traffic``; ``root`` is the checkout's (by
    default :func:`root_for`'s)."""
    root = root or root_for(cell, tmp_path)
    cfg, wl = overrides(cell, tmp_path, root)
    if traffic:
        wl = harness._merge(wl, {"traffic": traffic})
    return harness.run_cell(cell, SEED, seconds, trace, time.time(),
                            root=root, config_override=cfg,
                            workload_override=wl, device="cpu")
