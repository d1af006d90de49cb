"""The latent+pitch -> waveform samplers (``gansynth_tpu/synth/sampler.py``).

    z (explicit, from one key for the batch, or from each note's seed via
    threefry), pitch one-hot
    -> generator (EMA weights) at ``stage`` -> mel-IF image
    -> [nearest upsample to 128x1024 below the final stage]
    -> image_to_wave (the synthesis kernel on CUDA) -> 64000-sample wave

Each ``make_*`` returns a plain function that runs under
``torch.inference_mode`` on the generator's device. On a card every
sampler replays one CUDA graph per batch size (``utils/graphs.py``; the
reference's ``jax.jit`` of each): the seeded samplers (the serving path)
draw their latents in the graph by ``seeded_latents_torch``, with the
seeds and pitches copied in and the wave out; the keyed and latent
samplers (the loop's sample dumps, ``generate``, ``interpolate``,
``evaluate``) draw theirs on the host by threefry, as before, and copy
the latents and the one-hot labels in, the wave and the image out. Each
graph reads the generator's weights where they were at its capture, so a
sampler captures again once they have moved (``GraphedCall``'s
``watch``). On the CPU, or with ``graphs=False``, the same program runs
eagerly; ``sample.graphed`` is the :class:`GraphedCall` or None.
:class:`Sampler` holds a restored EMA generator with its config and
stage, as the reference's does, for ``generate`` and ``evaluate``.
:class:`SeededProgram` and :class:`LatentProgram` are the same bodies as
modules that ``torch.export`` traces (``synth/export.py``; the
reference's ``_seeded_body`` and ``_latent_body``): the seeded one draws
its latents in torch ops inside the program.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gansynth_tpu_torch.models.layers import upsample_nearest
from gansynth_tpu_torch.ops.spectral import image_to_wave
from gansynth_tpu_torch.synth.random import Key, normal, seeded_latents_torch
from gansynth_tpu_torch.utils import graphs as cuda_graphs
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


def _render(config: Config, generator: torch.nn.Module, stage: int,
            z: torch.Tensor, labels: torch.Tensor):
    """``(wave [B, 64000], image)`` of latents and pitch labels: every
    sampler's body."""
    image = generator(z, labels, stage, 1.0)
    return _full_wave(config, image, stage), image


class LatentProgram(torch.nn.Module):
    """``(z [B, D] f32, labels [B, num_pitches] f32) -> wave [B, 64000]``:
    :func:`make_latent_sampler`'s body as a module, without the image
    (the reference's ``_latent_body`` as ``synth/export.py`` exports it)."""

    def __init__(self, config: Config, generator: torch.nn.Module,
                 stage: int):
        super().__init__()
        self.config = config
        self.generator = generator
        self.stage = stage

    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return _render(self.config, self.generator, self.stage, z.float(),
                       labels.float())[0]


class SeededProgram(LatentProgram):
    """``(seeds [B] int32, pitch [B] int32) -> wave [B, 64000]``: note i's
    latent drawn in the program from ``jax.random.key(seeds[i])`` by
    :func:`seeded_latents_torch` (the reference's ``_seeded_body``)."""

    def forward(self, seeds: torch.Tensor,  # type: ignore[override]
                pitch: torch.Tensor) -> torch.Tensor:
        z = seeded_latents_torch(seeds, self.config.model.latent_dim)
        return super().forward(z, pitch_to_onehot(pitch, self.config))


def _device_of(generator: torch.nn.Module) -> torch.device:
    return next(generator.parameters()).device


def _latent_call(config: Config, generator: torch.nn.Module, stage: int,
                 graphs: bool):
    """``call(z [B, D] f32, labels [B, num_pitches] f32) -> (wave, image)``
    on the generator's device: one CUDA graph a batch size on a card
    (unless ``graphs`` is False), captured again when the generator's
    weights move; else eager."""
    def body(z, labels):
        return _render(config, generator, stage, z, labels)

    return cuda_graphs.on_device(body, _device_of(generator), graphs,
                                 watch=generator)


def _graphed(call):
    return call if isinstance(call, cuda_graphs.GraphedCall) else None


def make_latent_sampler(config: Config, generator: torch.nn.Module,
                        stage: Optional[int] = None, graphs: bool = True):
    """``sample(z [B, D], labels [B, num_pitches]) -> (wave [B, 64000],
    image)``; inputs may be numpy arrays or tensors on any device. On a
    card each batch size replays its CUDA graph (``sample.graphed``)."""
    stage = config.model.num_stages - 1 if stage is None else stage
    call = _latent_call(config, generator, stage, graphs)

    @torch.inference_mode()
    def sample(z, labels):
        return call(torch.as_tensor(z, dtype=torch.float32),
                    torch.as_tensor(labels, dtype=torch.float32))

    sample.graphed = _graphed(call)
    return sample


def _keyed_inputs(config: Config, key: Key, pitches: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host ``(z [B, D], labels [B, num_pitches])`` of a keyed batch: ``z =
    jax.random.normal(key, (B, latent_dim))`` by the port's threefry."""
    pitch = torch.as_tensor(list(pitches), dtype=torch.long)
    z = torch.from_numpy(normal(key, (len(pitch), config.model.latent_dim)))
    return z, pitch_to_onehot(pitch, config)


def make_sampler(config: Config, generator: torch.nn.Module,
                 stage: Optional[int] = None, graphs: bool = True):
    """The keyed sampler: ``sample(key, pitches [B]) -> (wave [B, 64000],
    image)`` with ``z = jax.random.normal(key, (B, latent_dim))`` drawn by
    the port's threefry (``gansynth_tpu/synth/sampler.py:_keyed_body``).
    The training loop's sample dumps call it with ``fold_in(key(seed),
    step)``. On a card each batch size replays its CUDA graph, the host's
    latents its static input (``sample.graphed``)."""
    stage = config.model.num_stages - 1 if stage is None else stage
    call = _latent_call(config, generator, stage, graphs)

    @torch.inference_mode()
    def sample(key: Key, pitches: Sequence[int]):
        return call(*_keyed_inputs(config, key, pitches))

    sample.graphed = _graphed(call)
    return sample


def seed_tensors(seeds: Sequence[int], pitches: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Host int32 ``(seeds [B], pitch [B])``, a seeded program's inputs.
    A seed is a 32-bit integer, as ``seed_to_key`` takes it; its int32
    form carries the same low word, which is all the key holds."""
    s = np.asarray(list(seeds), dtype=np.int64).reshape(-1)
    if s.size and not ((s >= -(1 << 31)).all() and (s < (1 << 32)).all()):
        raise ValueError(f"seeds {s.tolist()} are not all 32-bit integers")
    p = np.asarray(list(pitches), dtype=np.int64).reshape(-1)
    if s.shape != p.shape:
        raise ValueError(f"{s.size} seeds and {p.size} pitches")
    return (torch.from_numpy(s.astype(np.uint32).view(np.int32)),
            torch.from_numpy(p.astype(np.int32)))


def _seeded_call(config: Config, generator: torch.nn.Module, stage: int,
                 graphs: bool):
    """:class:`SeededProgram` on the generator's device: one CUDA graph a
    batch size on a card (unless ``graphs`` is False), else eager."""
    return cuda_graphs.on_device(SeededProgram(config, generator, stage),
                                 _device_of(generator), graphs,
                                 watch=generator)


def make_seeded_sampler(config: Config, generator: torch.nn.Module,
                        stage: Optional[int] = None, graphs: bool = True):
    """``sample(seeds [B], pitches [B]) -> wave [B, 64000]``.

    Note i's latent is ``jax.random.normal(jax.random.key(seeds[i]),
    (latent_dim,))``, drawn by the port's threefry in torch ops
    (:class:`SeededProgram`), so a note's audio is a function of (weights,
    seed, pitch) alone, whatever batch it rides in. On a card each batch
    size replays its own CUDA graph of the program (``sample.graphed``);
    on the CPU, or with ``graphs=False``, the program runs eagerly
    (``sample.graphed`` is None).
    """
    stage = config.model.num_stages - 1 if stage is None else stage
    call = _seeded_call(config, generator, stage, graphs)

    @torch.inference_mode()
    def sample(seeds: Sequence[int], pitches: Sequence[int]) -> torch.Tensor:
        return call(*seed_tensors(seeds, pitches))

    sample.graphed = _graphed(call)
    return sample


def _replicas(generator: torch.nn.Module, devices) -> list:
    """One EMA replica per listed device (a copy each, so a device listed
    twice holds two)."""
    return [copy.deepcopy(generator).to(torch.device(d)).eval()
            for d in devices]


def _split_render(calls, *inputs: torch.Tensor) -> torch.Tensor:
    """The batch's ``inputs`` split over the replicas' ``calls`` in order:
    every replica's share is launched before any result is read, then the
    waves come back to the host in batch order."""
    n, batch = len(calls), inputs[0].shape[0]
    if batch % n:
        raise ValueError(f"batch {batch} must divide the {n} devices")
    per = batch // n
    waves = [call(*(x[i * per:(i + 1) * per] for x in inputs))
             for i, call in enumerate(calls)]
    return torch.cat([w.cpu() for w in waves])


def make_dp_sampler(config: Config, generator: torch.nn.Module, devices,
                    stage: Optional[int] = None, graphs: bool = True):
    """The keyed sampler over ``devices`` (``gansynth_tpu/synth/sampler.py:
    make_dp_sampler``): ``sample(key, pitches [B]) -> wave [B, 64000]`` on
    the host, the batch's latents drawn from ``key`` as
    :func:`make_sampler` draws them and the batch split over one replica
    of ``generator`` per device (:class:`LatentProgram`). B must divide
    the device count. On cards each replica replays its own CUDA graph of
    its share (``sample.graphed``, one per replica on a card)."""
    stage = config.model.num_stages - 1 if stage is None else stage
    calls = [cuda_graphs.on_device(LatentProgram(config, g, stage),
                                   _device_of(g), graphs, watch=g)
             for g in _replicas(generator, devices)]

    @torch.inference_mode()
    def sample(key: Key, pitches: Sequence[int]) -> torch.Tensor:
        return _split_render(calls, *_keyed_inputs(config, key, pitches))

    sample.graphed = [c for c in calls if _graphed(c)]
    return sample


def make_dp_seeded_sampler(config: Config, generator: torch.nn.Module,
                           devices, stage: Optional[int] = None,
                           graphs: bool = True):
    """The seeded serving sampler over ``devices``
    (``gansynth_tpu/synth/sampler.py:make_dp_seeded_sampler``):
    ``sample(seeds [B], pitches [B]) -> wave [B, 64000]`` on the host.

    Serving needs no collective: a note is a function of its seed and
    pitch alone. So one process holds one replica of ``generator`` per
    device, splits the batch over them and launches every share before it
    reads any. B must divide the device count. A device's share renders
    what :func:`make_seeded_sampler` renders for the same notes at that
    share's batch size: on cards, each replica replays its own CUDA graph
    of its share (``sample.graphed``, one per replica on a card)."""
    stage = config.model.num_stages - 1 if stage is None else stage
    calls = [_seeded_call(config, g, stage, graphs)
             for g in _replicas(generator, devices)]

    @torch.inference_mode()
    def sample(seeds: Sequence[int], pitches: Sequence[int]) -> torch.Tensor:
        return _split_render(calls, *seed_tensors(seeds, pitches))

    sample.graphed = [c for c in calls if _graphed(c)]
    return sample


class Sampler:
    """``sampler(key, pitches) -> (wave [B, 64000], image)`` over
    :func:`make_sampler`: the restored EMA ``generator`` with its
    ``config`` and ``stage`` (the final stage when None), as the
    reference's ``Sampler`` (``gansynth_tpu/synth/sampler.py:191``). On a
    card each batch size replays its CUDA graph (:attr:`graphed`)."""

    def __init__(self, config: Config, generator: torch.nn.Module,
                 stage: Optional[int] = None, graphs: bool = True):
        self.config = config
        self.generator = generator
        self.stage = config.model.num_stages - 1 if stage is None else stage
        self._sample = make_sampler(config, generator, self.stage, graphs)
        self.graphed = self._sample.graphed

    def __call__(self, key: Key, pitches: Sequence[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._sample(key, [int(p) for p in pitches])
