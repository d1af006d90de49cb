"""The latent+pitch -> waveform samplers (``gansynth_tpu/synth/sampler.py``).

    z (explicit, from one key for the batch, or from each note's seed via
    threefry), pitch one-hot
    -> generator (EMA weights) at ``stage`` -> mel-IF image
    -> [nearest upsample to 128x1024 below the final stage]
    -> image_to_wave (the synthesis kernel on CUDA) -> 64000-sample wave

Each ``make_*`` returns a plain function that runs under
``torch.inference_mode`` on the generator's device. :class:`Sampler` holds
a restored EMA generator with its config and stage, as the reference's
does, for ``generate`` and ``evaluate``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from gansynth_tpu_torch.models.layers import upsample_nearest
from gansynth_tpu_torch.ops.spectral import image_to_wave
from gansynth_tpu_torch.synth.random import Key, normal, seeded_latents
from gansynth_tpu_torch.utils.config import Config


def pitch_to_onehot(pitch: torch.Tensor, config: Config) -> torch.Tensor:
    """MIDI pitch [B] -> one-hot [B, num_pitches] float32 (pitches
    outside ``pitch_min..pitch_max`` clip to the ends)."""
    m = config.model
    idx = torch.clamp(pitch.long() - m.pitch_min, 0, m.num_pitches - 1)
    return torch.nn.functional.one_hot(idx, m.num_pitches).float()


def _full_wave(config: Config, image: torch.Tensor, stage: int) -> torch.Tensor:
    factor = 1 << (config.model.num_stages - 1 - stage)
    full = upsample_nearest(image, factor) if factor > 1 else image
    return image_to_wave(full, config.audio)


def _device_of(generator: torch.nn.Module) -> torch.device:
    return next(generator.parameters()).device


def make_latent_sampler(config: Config, generator: torch.nn.Module,
                        stage: Optional[int] = None):
    """``sample(z [B, D], labels [B, num_pitches]) -> (wave [B, 64000],
    image)``; inputs may be numpy arrays or tensors on any device."""
    stage = config.model.num_stages - 1 if stage is None else stage
    device = _device_of(generator)

    @torch.inference_mode()
    def sample(z, labels):
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        labels = torch.as_tensor(labels, dtype=torch.float32, device=device)
        image = generator(z, labels, stage, 1.0)
        return _full_wave(config, image, stage), image

    return sample


def make_sampler(config: Config, generator: torch.nn.Module,
                 stage: Optional[int] = None):
    """The keyed sampler: ``sample(key, pitches [B]) -> (wave [B, 64000],
    image)`` with ``z = jax.random.normal(key, (B, latent_dim))`` drawn by
    the port's threefry (``gansynth_tpu/synth/sampler.py:_keyed_body``).
    The training loop's sample dumps call it with ``fold_in(key(seed),
    step)``."""
    stage = config.model.num_stages - 1 if stage is None else stage
    device = _device_of(generator)

    @torch.inference_mode()
    def sample(key: Key, pitches: Sequence[int]):
        pitch = torch.as_tensor(list(pitches), dtype=torch.long, device=device)
        z = torch.from_numpy(
            normal(key, (pitch.shape[0], config.model.latent_dim))).to(device)
        image = generator(z, pitch_to_onehot(pitch, config), stage, 1.0)
        return _full_wave(config, image, stage), image

    return sample


def make_seeded_sampler(config: Config, generator: torch.nn.Module,
                        stage: Optional[int] = None):
    """``sample(seeds [B], pitches [B]) -> wave [B, 64000]``.

    Note i's latent is ``jax.random.normal(jax.random.key(seeds[i]),
    (latent_dim,))``, drawn by the port's threefry, so a note's audio is a
    function of (weights, seed, pitch) alone, whatever batch it rides in.
    """
    stage = config.model.num_stages - 1 if stage is None else stage
    device = _device_of(generator)

    @torch.inference_mode()
    def sample(seeds: Sequence[int], pitches: Sequence[int]) -> torch.Tensor:
        z = torch.from_numpy(
            seeded_latents(seeds, config.model.latent_dim)
        ).to(device)
        pitch = torch.as_tensor(list(pitches), dtype=torch.long, device=device)
        image = generator(z, pitch_to_onehot(pitch, config), stage, 1.0)
        return _full_wave(config, image, stage)

    return sample


class Sampler:
    """``sampler(key, pitches) -> (wave [B, 64000], image)`` over
    :func:`make_sampler`: the restored EMA ``generator`` with its
    ``config`` and ``stage`` (the final stage when None), as the
    reference's ``Sampler`` (``gansynth_tpu/synth/sampler.py:191``)."""

    def __init__(self, config: Config, generator: torch.nn.Module,
                 stage: Optional[int] = None):
        self.config = config
        self.generator = generator
        self.stage = config.model.num_stages - 1 if stage is None else stage
        self._sample = make_sampler(config, generator, self.stage)

    def __call__(self, key: Key, pitches: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._sample(key, [int(p) for p in pitches])
