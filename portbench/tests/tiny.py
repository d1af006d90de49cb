"""A narrow copy of the benchmark's cells for its CPU tests: the
flagship's audio (128 x 1024 images) with 8-channel networks at stage 1,
a generator weight file drawn from a seed in the published layout, and a
short run of a cell through the harness on the CPU."""

from __future__ import annotations

import hashlib
import json
import time

import numpy as np

from portbench import harness
from portbench.count.flops import channels

TINY_MODEL = {"fmap_base": 16, "fmap_max": 8, "fmap_min": 8,
              "compute_dtype": "float32", "conv_kernel": "xla",
              "dblock_kernel": "xla"}
STAGE = 1
SEED = (1 << 31) + 12345


def generator_shapes(model):
    ch = lambda s: channels(model, s)
    base = model["base_height"] * model["base_width"] * ch(0)
    out = [("latent_dense", (model["latent_dim"] + model["num_pitches"],
                             base))]
    for i in range(model["num_stages"]):
        out.append((f"block_{i}/conv0", (3, 3, ch(max(i - 1, 0)), ch(i))))
        out.append((f"block_{i}/conv1", (3, 3, ch(i), ch(i))))
        out.append((f"to_rgb_{i}", (1, 1, ch(i), model["num_channels"])))
    return out


def write_weights(path, model, stage=STAGE, seed=0):
    """A generator weight file like ``ema.npz``; returns the
    configuration's ``weights`` group for it."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, shape in generator_shapes(model):
        key = "".join(f"['{p}']" for p in ["params", *name.split("/")])
        arrays[key + "['kernel']"] = rng.standard_normal(shape).astype(
            np.float32)
        arrays[key + "['bias']"] = (0.02 * rng.standard_normal(
            shape[-1])).astype(np.float32)
    np.savez(path, __step__=np.int64(415000), __stage__=np.int64(stage),
             **arrays)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return {"path": str(path), "sha256": digest, "step": 415000,
            "stage": stage}


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


def overrides(cell: str, tmp_path):
    """``(config_override, workload_override)`` of the narrow copy."""
    workload = harness.load_json(harness.HERE / "workloads" / f"{cell}.json")
    config = harness.load_json(harness.HERE / "configs" /
                               f"{workload['config']}.json")
    model = dict(config["model"], **TINY_MODEL)
    weights = write_weights(tmp_path / "tiny_ema.npz", model)
    cfg = {"weights": weights, "model": TINY_MODEL,
           "train": {"unroll": 2, "stage_batch_sizes": [8] * 7}}
    t = workload["traffic"]
    if workload["driver"] == "train_cached":
        return cfg, {"traffic": {"stage": STAGE, "cached_notes": 32}}
    clients = min(4, t["clients"])
    return cfg, {"traffic": {"clients": clients, "reference_sample": 4,
                             "keep": {"per_client": 4 // clients}}}


def run(cell: str, tmp_path, seconds: float = 2.0, trace: bool = False,
        traffic=None):
    """One run of the narrow copy of ``cell`` on the CPU, its traffic
    parameters changed by ``traffic``."""
    cfg, wl = overrides(cell, tmp_path)
    if traffic:
        wl = harness._merge(wl, {"traffic": traffic})
    return harness.run_cell(cell, SEED, seconds, trace, time.time(),
                            root=root_for(cell, tmp_path),
                            config_override=cfg, workload_override=wl,
                            device="cpu")
