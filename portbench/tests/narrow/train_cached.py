"""The narrow CPU copy of a ``train_cached`` cell: the flagship's audio
(128 x 1024 images) with 8-channel networks at stage 1, a generator
weight file drawn from a seed in the published layout, and a cache of
32 notes. ``http_serve``'s copy takes the same networks and weights."""

from __future__ import annotations

import hashlib

import numpy as np

from portbench.count.flops import channels

TINY_MODEL = {"fmap_base": 16, "fmap_max": 8, "fmap_min": 8,
              "compute_dtype": "float32", "conv_kernel": "xla",
              "dblock_kernel": "xla"}
STAGE = 1


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


def networks(config, tmp_path):
    """The configuration override: the narrow networks, with a weight
    file for them written under ``tmp_path``."""
    model = dict(config["model"], **TINY_MODEL)
    weights = write_weights(tmp_path / "tiny_ema.npz", model)
    return {"weights": weights, "model": TINY_MODEL,
            "train": {"unroll": 2, "stage_batch_sizes": [8] * 7}}


def overrides(workload, config, tmp_path):
    return networks(config, tmp_path), {
        "traffic": {"stage": STAGE, "cached_notes": 32}}
