"""Is a note's wave a function of its seed alone, whatever batch it rides
in? One seeded note rendered alone (B=1) and first of a batch of 16, in
both packages, in float32 and bfloat16, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_batch_invariance.py            # tiny
    JAX_PLATFORMS=cpu python tests/torch_batch_invariance.py --flagship  # ~5 min

Prints one JSON line per dtype: the relative L2 distance of the note at
B=1 from the same note at B=16, and whether they are equal to the bit,
for the reference's seeded sampler, the port's, and the port's generator
image alone (the wave's difference without the synthesis). The tiny
model is ``torch_tiny_run.py``'s at stage 6; ``--flagship`` takes
``runs/flagship_r4``.
"""

import argparse
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch_tiny_run as tiny  # noqa: E402
from gansynth_tpu.synth.sampler import make_seeded_sampler as j_seeded  # noqa: E402,E501
from gansynth_tpu.utils.config import Config as JConfig  # noqa: E402
from gansynth_tpu_torch.synth.random import seeded_latents  # noqa: E402
from gansynth_tpu_torch.synth.sampler import (  # noqa: E402
    make_seeded_sampler,
    pitch_to_onehot,
)
from gansynth_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_ema_generator,
    load_ema_npz,
)
from gansynth_tpu_torch.utils.config import Config  # noqa: E402

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "runs", "flagship_r4")
BATCH = 16


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


def _models(flagship: bool, dtype: str):
    if flagship:
        with open(os.path.join(FLAGSHIP, "train_config.json")) as f:
            overrides = json.load(f)
        overrides["model"]["compute_dtype"] = dtype
        jcfg, tcfg = (JConfig().with_overrides(overrides),
                      Config().with_overrides(overrides))
        flat, _, stage = load_ema_npz(os.path.join(FLAGSHIP, "ema.npz"))
        tree = {}
        for k, v in flat.items():
            node = tree
            *path, leaf = re.findall(r"\['([^']+)'\]", k)
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        g = load_ema_generator(os.path.join(FLAGSHIP, "ema.npz"),
                               tcfg.model, "cpu")[0]
        return jcfg, tcfg, tree, g, stage
    overrides = {"model": {**tiny.TINY["model"], "compute_dtype": dtype},
                 "train": tiny.TINY["train"]}
    jcfg, tcfg = (JConfig().with_overrides(overrides),
                  Config().with_overrides(overrides))
    params = tiny.tiny_params()
    return jcfg, tcfg, params, tiny.port_generator(params, tcfg), 6


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--flagship", action="store_true")
    args = parser.parse_args()
    seeds = list(range(100, 100 + BATCH))
    pitches = [60 + i % 12 for i in range(BATCH)]
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg, params, g, stage = _models(args.flagship, dtype)
        js = j_seeded(jcfg, stage)
        j1, jb = (np.asarray(js(params, jnp.asarray(seeds[:n], jnp.int32),
                                jnp.asarray(pitches[:n], jnp.int32)))[0]
                  for n in (1, BATCH))
        ts = make_seeded_sampler(tcfg, g, stage)
        t1, tb = (ts(seeds[:n], pitches[:n]).float().numpy()[0]
                  for n in (1, BATCH))
        z = torch.from_numpy(seeded_latents(seeds, tcfg.model.latent_dim))
        labels = pitch_to_onehot(torch.tensor(pitches), tcfg)
        with torch.inference_mode():
            i1, ib = (g(z[:n], labels[:n], stage, 1.0)[0].float().numpy()
                      for n in (1, BATCH))
        print(json.dumps({
            "model": "flagship" if args.flagship else "tiny",
            "dtype": dtype, "batch": BATCH,
            "reference_wave": {"rel_l2": _rel(j1, jb),
                               "bit_equal": bool(np.array_equal(j1, jb))},
            "port_wave": {"rel_l2": _rel(t1, tb),
                          "bit_equal": bool(np.array_equal(t1, tb))},
            "port_image": {"rel_l2": _rel(i1, ib),
                           "bit_equal": bool(np.array_equal(i1, ib))}}),
            flush=True)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
