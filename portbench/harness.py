"""One run of one cell: find its files by name, run its driver, read the
metrics the manifest names for it, decide ``correct`` and build the
result line.

A cell ``<cell>`` of ``BENCHMARK.json`` has ``workloads/<cell>.json``:
``config`` (the manifest's), ``driver``, ``traffic`` (the driver's
parameters) and ``limits`` (one per number its check compares). The
driver, ``drivers/<driver>.py``, has ``run(ctx) -> dict`` with
``setup_end`` (``time.time()`` at the first timed request or step),
``end_to_end`` (metric -> value), ``attempted``, ``failed``,
``memory_peak_bytes``, ``checks`` (number -> value) and, traced, the
reduced ``trace`` and the ``facts`` that the per-layer readers,
``metrics/<metric>.py`` with ``read(facts) -> float or None``, take.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from typing import Dict, Mapping, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at ``path`` as a module (its name may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def manifest(root: Path = REPO) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(man: Mapping, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _applies(metric: Mapping, name: str, reported=None) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer one is every cell's that reports the metric it moves."""
    if "workloads" in metric:
        return name in metric["workloads"]
    return reported is None or metric["moves"] in reported


def metrics_for(man: Mapping, name: str, trace: bool):
    """The manifest's metrics that cell ``name`` reports: its end-to-end
    metrics, or (traced) its per-layer metrics."""
    e2e = [m for m in man["end_to_end"] if _applies(m, name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"] if _applies(m, name, names)]


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's name, its workload file, its
    configuration file, the run's arguments and the process's start."""

    name: str
    workload: Dict
    config: Dict
    seed: int
    seconds: float
    trace: bool
    t_start: float
    device: str = "cuda"


def judge(values: Mapping[str, float],
          limits: Mapping[str, float]) -> Dict[str, Dict[str, float]]:
    """Each compared number beside its limit; a number without a limit
    gets the limit 0."""
    return {k: {"value": float(v), "limit": float(limits.get(k, 0.0))}
            for k, v in values.items()}


def is_correct(checks: Mapping[str, Mapping[str, float]]) -> bool:
    return bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, root: Path = REPO,
             config_override: Optional[Mapping] = None,
             workload_override: Optional[Mapping] = None,
             device: str = "cuda") -> Dict:
    """One run of cell ``name``. The overrides (merged into the
    configuration and workload files) and ``device`` let the harness's
    own tests run a narrow copy of a cell on the CPU."""
    man = manifest(root)
    entry = cell(man, name)
    here = root / "portbench"
    workload = load_json(here / "workloads" / f"{name}.json")
    if workload["config"] != entry["config"]:
        raise ValueError(f"workloads/{name}.json names {workload['config']}"
                         f", BENCHMARK.json {entry['config']}")
    config = load_json(here / "configs" / f"{entry['config']}.json")
    if workload_override:
        workload = _merge(workload, workload_override)
    if config_override:
        config = _merge(config, config_override)
    driver = load_module(here / "drivers" / f"{workload['driver']}.py")
    ctx = Context(name, workload, config, seed, seconds, trace, t_start,
                  device)
    out = driver.run(ctx)
    metrics = {}
    setup_s = out["setup_end"] - t_start
    for m in metrics_for(man, name, trace):
        if trace:
            reader = load_module(here / "metrics" / f"{m['name']}.py")
            value = reader.read(out["facts"])
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = judge(out["checks"], workload.get("limits", {}))
    result = {"correct": is_correct(checks),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": out["device"]}
    if trace:
        t = out["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = t["breakdown"]
    result["notes"] = out.get("notes", {})
    result["checks"] = checks
    return result


def _merge(base: Mapping, over: Mapping) -> Dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, Mapping) and \
            isinstance(base.get(k), Mapping) else v
    return out
