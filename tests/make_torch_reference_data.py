"""Makes the JAX package's outputs on the committed flagship that the
port's card checks compare with (the card's machine has no JAX):

    JAX_PLATFORMS=cpu python tests/make_torch_reference_data.py
    JAX_PLATFORMS=cpu python tests/make_torch_reference_data.py --eval

Without arguments: ``tests/data/flagship_stage6_bf16.npz``, the stage-6
bf16 generator output, for ``tests/test_torch_gpu.py``.

``--eval``: ``tests/data/flagship_eval_ref.json``, for ``chip_smoke.py``'s
offline phase. The JAX package's ``evaluate_sampler`` on
``runs/flagship_r4/ema.npz`` with the run's own config (bf16, stage 6),
on the CPU: seed 0, the 61 pitches 24..84, fixture references,
attribution, at 2 samples a pitch (``metrics``) and at 8 (``metrics_n8``,
the run's own evaluation size). Its sampler draws each round's latents as
the reference's keyed sampler does (``jax.random.normal(key, (61,
256))``) and renders them ``RENDER_CHUNK`` notes a call (padded), which
keeps the CPU's memory small; the generator treats notes independently.
Beside them: the port's metrics of the same notes rendered on the CPU
(``port_cpu_metrics``, the port's keyed chain and generator, chunked the
same way), from which the card's bars are set, and the reference's
``roundtrip`` SNR of the fixture note at pitch 60. ~10 minutes.

Runs the reference (``gansynth_tpu``) on the CPU with the run's own config
(``runs/flagship_r4/train_config.json``: bf16, ``conv_kernel="xla"``) at
stage 6, alpha 1, on two latents drawn with the port's seeded threefry
(``gansynth_tpu_torch.synth.random.seeded_latents``, equal to
``jax.random.normal(key(seed))``) and two pitches. The image (tanh outputs
in [-1, 1]) is stored as float16, whose rounding (at most 2**-11 near +-1)
is far below the bf16 differences the test bounds; the latents, one-hot
pitches and seeds ride along. Pytest does not collect this file.
"""

import argparse
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
EVAL_OUT = os.path.join(ROOT, "tests", "data", "flagship_eval_ref.json")
SEEDS = [11, 12]
PITCHES = [36, 60]
STAGE = 6
EVAL_PITCHES = list(range(24, 85))
EVAL_SEED = 0
EVAL_SAMPLES = (2, 8)     # samples a pitch: the card's phase, the run's own
RENDER_CHUNK = 8
ROUNDTRIP_PITCH = 60


def _flagship():
    """(config, the EMA as a flax tree, step, stage) of the flagship."""
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
    return config, tree, step, stage


def main() -> int:
    config, tree, step, _ = _flagship()
    m = config.model
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


class _ChunkedSampler:
    """The reference's keyed sampler (``synth/sampler.py:_keyed_body``):
    ``z = normal(key, (B, latent_dim))``, one-hot pitches, the generator
    at ``stage``, synthesis; the generator and synthesis run on
    ``RENDER_CHUNK`` notes a call."""

    def __init__(self, config, params, stage):
        from gansynth_tpu.synth.sampler import make_latent_sampler
        from gansynth_tpu.train.step import pitch_to_onehot

        self.config, self.params = config, params
        self._onehot = pitch_to_onehot
        self._latent = make_latent_sampler(config, stage)

    def __call__(self, key, pitches):
        pitch = jnp.asarray(pitches, jnp.int32)
        n = pitch.shape[0]
        z = jax.random.normal(key, (n, self.config.model.latent_dim),
                              jnp.float32)
        labels = self._onehot(pitch, self.config)
        return _chunked(lambda a, b: np.asarray(
            self._latent(self.params, a, b)[0]), np.asarray(z),
            np.asarray(labels)), None


def _chunked(render, z, labels):
    """``render`` over ``RENDER_CHUNK`` rows at a time, the last chunk
    padded with zeros (one program shape), the padding dropped."""
    n, out = z.shape[0], []
    for i in range(0, n, RENDER_CHUNK):
        zc, lc = z[i:i + RENDER_CHUNK], labels[i:i + RENDER_CHUNK]
        pad = RENDER_CHUNK - zc.shape[0]
        zc = np.pad(zc, ((0, pad), (0, 0)))
        lc = np.pad(lc, ((0, pad), (0, 0)))
        out.append(render(zc, lc)[:RENDER_CHUNK - pad])
    return np.concatenate(out)


def _port_cpu_metrics(samples: int):
    """The port on the CPU: its keyed chain and generator, the same notes
    rendered ``RENDER_CHUNK`` a call, scored by its evaluation."""
    import torch

    import gansynth_tpu_torch.evaluation as T
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.synth.random import normal, seed_to_key, split
    from gansynth_tpu_torch.synth.sampler import (
        make_latent_sampler,
        pitch_to_onehot,
    )
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    config = run_config(FLAGSHIP)
    g, _, _ = load_ema_generator(os.path.join(FLAGSHIP, "ema.npz"),
                                 config.model, "cpu")
    latent = make_latent_sampler(config, g, STAGE)
    labels = pitch_to_onehot(torch.tensor(EVAL_PITCHES), config).numpy()
    key, waves = seed_to_key(EVAL_SEED), []
    for _ in range(samples):
        key, sub = split(key)
        z = normal(sub, (len(EVAL_PITCHES), config.model.latent_dim))
        waves.append(_chunked(lambda a, b: latent(a, b)[0].float().numpy(),
                              z, labels))
    return T.score_notes(np.concatenate(waves), EVAL_PITCHES * samples,
                         samples, config.audio.sample_rate,
                         T.fixture_reference_fn(), True)


def _roundtrip_snr(pitch: int) -> float:
    """The reference's ``cli roundtrip --pitch`` SNR, unrounded."""
    from gansynth_tpu.data.fixtures import synthesize_note
    from gansynth_tpu.ops import image_to_wave, wave_to_image
    from gansynth_tpu.utils.config import AudioConfig

    wave = synthesize_note(pitch)
    img = wave_to_image(jnp.asarray(wave[None]), AudioConfig())
    err = wave - np.asarray(image_to_wave(img, AudioConfig()))[0]
    return float(10 * np.log10(np.sum(wave ** 2)
                               / max(np.sum(err ** 2), 1e-30)))


def eval_main() -> int:
    from gansynth_tpu.evaluation import evaluate_sampler, fixture_reference_fn

    config, tree, step, stage = _flagship()
    sampler = _ChunkedSampler(config, tree, stage)
    out = {
        "settings": {
            "model_dir": "runs/flagship_r4", "step": step, "stage": stage,
            "compute_dtype": config.model.compute_dtype,
            "seed": EVAL_SEED, "pitches": EVAL_PITCHES,
            "samples_per_pitch": EVAL_SAMPLES[0],
            "samples_per_pitch_n8": EVAL_SAMPLES[1],
            "reference_set": "fixture", "attribution": True,
            "render_chunk": RENDER_CHUNK, "device": "cpu",
            "jax_version": jax.__version__,
        },
        "roundtrip": {"pitch": ROUNDTRIP_PITCH,
                      "snr_db": _roundtrip_snr(ROUNDTRIP_PITCH)},
    }
    for samples, name in zip(EVAL_SAMPLES, ("metrics", "metrics_n8")):
        out[name] = evaluate_sampler(
            sampler, pitches=EVAL_PITCHES, samples_per_pitch=samples,
            sample_rate=config.audio.sample_rate, seed=EVAL_SEED,
            reference_fn=fixture_reference_fn(config.audio.audio_length,
                                              config.audio.sample_rate),
            attribution=True)
        print(f"{name}: {out[name]['num_samples']:.0f} notes", flush=True)
    out["port_cpu_metrics"] = _port_cpu_metrics(EVAL_SAMPLES[0])
    with open(EVAL_OUT, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    print(f"wrote {EVAL_OUT}: {os.path.getsize(EVAL_OUT)} bytes")
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--eval", action="store_true",
                        help="write flagship_eval_ref.json")
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")
    raise SystemExit(eval_main() if args.eval else main())
