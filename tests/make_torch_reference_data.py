"""Makes ``tests/data/flagship_stage6_bf16.npz``: the JAX package's stage-6
bf16 generator output on the committed flagship EMA, for the port's card
test (``tests/test_torch_gpu.py``), which has no JAX to compute it.

    JAX_PLATFORMS=cpu python tests/make_torch_reference_data.py

Runs the reference (``gansynth_tpu``) on the CPU with the run's own config
(``runs/flagship_r4/train_config.json``: bf16, ``conv_kernel="xla"``) at
stage 6, alpha 1, on two latents drawn with the port's seeded threefry
(``gansynth_tpu_torch.synth.random.seeded_latents``, equal to
``jax.random.normal(key(seed))``) and two pitches. The image (tanh outputs
in [-1, 1]) is stored as float16, whose rounding (at most 2**-11 near +-1)
is far below the bf16 differences the test bounds; the latents, one-hot
pitches and seeds ride along. Pytest does not collect this file.
"""

import dataclasses
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from gansynth_tpu.models import Generator  # noqa: E402
from gansynth_tpu.utils.config import Config  # noqa: E402
from gansynth_tpu_torch.synth.random import seeded_latents  # noqa: E402
from gansynth_tpu_torch.utils.checkpoint import load_ema_npz  # noqa: E402

FLAGSHIP = os.path.join(ROOT, "runs", "flagship_r4")
OUT = os.path.join(ROOT, "tests", "data", "flagship_stage6_bf16.npz")
SEEDS = [11, 12]
PITCHES = [36, 60]
STAGE = 6


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    with open(os.path.join(FLAGSHIP, "train_config.json")) as f:
        config = Config().with_overrides(json.load(f))
    m = config.model
    assert (m.compute_dtype, m.conv_kernel) == ("bfloat16", "xla"), m
    params, step, stage = load_ema_npz(os.path.join(FLAGSHIP, "ema.npz"))
    assert stage == STAGE, stage
    tree = {}
    for key, arr in params.items():
        *path, leaf = re.findall(r"\['([^']+)'\]", key)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    z = seeded_latents(SEEDS, m.latent_dim)
    labels = np.eye(m.num_pitches, dtype=np.float32)[
        [p - m.pitch_min for p in PITCHES]]
    image = np.asarray(Generator(m).apply(tree, jnp.asarray(z),
                                          jnp.asarray(labels), STAGE,
                                          jnp.float32(1.0)))
    assert image.shape == (len(SEEDS), 128, 1024, 2), image.shape
    assert np.all(np.isfinite(image))
    np.savez_compressed(OUT, image=image.astype(np.float16), z=z,
                        labels=labels, seeds=np.array(SEEDS, np.int32),
                        pitches=np.array(PITCHES, np.int32),
                        stage=np.int32(STAGE), step=np.int32(step),
                        jax_version=np.array(jax.__version__))
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes, image "
          f"{image.shape}, range [{image.min():.4f}, {image.max():.4f}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
