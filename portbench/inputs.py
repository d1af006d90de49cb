"""The inputs the benchmark makes and hands to both the program and the
reference: the committed generator weights, the critic's weights and the
cached notes, the last two made on the device from the seed in a few
large calls."""

from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from portbench.count.flops import channels

REPO = Path(__file__).resolve().parents[1]


def load_npz(spec: Mapping) -> Tuple[Dict[str, np.ndarray], int, int]:
    """``(params keyed as the file keys them, step, stage)`` of the
    configuration's ``weights`` (a path in the checkout and its sha256,
    which must match: the weights are part of the yardstick)."""
    path = REPO / spec["path"]
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if digest != spec["sha256"]:
        raise RuntimeError(f"{spec['path']}: sha256 {digest}, the "
                           f"configuration states {spec['sha256']}")
    with np.load(path) as data:
        params = {k: data[k] for k in data.files if not k.startswith("__")}
        return params, int(data["__step__"]), int(data["__stage__"])


def critic_shapes(model: Mapping) -> List[Tuple[str, Tuple[int, ...]]]:
    """The critic's kernels in the published layout: fromRGB at every
    stage, blocks ``num_stages - 1 .. 1``, the final conv and dense layer
    and the two heads (biases have the kernels' last dimension)."""
    ch = lambda s: channels(model, s)
    rgb, top = model["num_channels"], model["num_stages"] - 1
    out = [(f"from_rgb_{s}", (1, 1, rgb, ch(s))) for s in range(top + 1)]
    for i in range(top, 0, -1):
        out.append((f"block_{i}/conv0", (3, 3, ch(i), ch(i))))
        out.append((f"block_{i}/conv1", (3, 3, ch(i), ch(i - 1))))
    grid = model["base_height"] * model["base_width"]
    out += [("final_conv", (3, 3, ch(0) + 1, ch(0))),
            ("final_dense", (grid * ch(0), ch(0))),
            ("critic_head", (ch(0), 1)),
            ("pitch_head", (ch(0), model["num_pitches"]))]
    return out


def critic_params(model: Mapping, seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """The critic's weights for ``seed``: kernels N(0, 1) (the
    equalized-learning-rate init), biases N(0, 0.02^2), keyed
    ``"<module>/kernel"`` and ``"<module>/bias"``; one draw for all
    kernels and one for all biases."""
    shapes = critic_shapes(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0xC21717)
    sizes = [math.prod(s) for _, s in shapes]
    kernels = torch.randn(sum(sizes), generator=gen, device=device)
    biases = 0.02 * torch.randn(sum(s[-1] for _, s in shapes),
                                generator=gen, device=device)
    out, k, b = {}, 0, 0
    for (name, shape), size in zip(shapes, sizes):
        out[f"{name}/kernel"] = kernels[k:k + size].view(shape)
        out[f"{name}/bias"] = biases[b:b + shape[-1]]
        k, b = k + size, b + shape[-1]
    return out


def flax_key(name: str) -> str:
    """``"block_6/conv0/kernel"`` -> ``"['params']['block_6']['conv0']
    ['kernel']"``, as ``ema.npz`` keys its arrays."""
    return "".join(f"['{p}']" for p in ["params", *name.split("/")])


def make_notes(n: int, seed: int, audio: Mapping, pitch_lo: int,
               pitch_hi: int, device, harmonics: int = 16,
               chunk: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` harmonic notes ``[n, audio_length]`` float32 and their MIDI
    pitches ``[n]`` int32 (uniform over ``pitch_lo..pitch_hi``): up to
    ``harmonics`` partials below Nyquist with random 1/k-scaled
    amplitudes and phases, a 10 ms attack and an exponential decay of
    0.5 to 4 per second, peak 0.8, over a noise floor at 1e-3."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) ^ 0x5EED0)
    sr, length = audio["sample_rate"], audio["audio_length"]
    pitches = torch.randint(pitch_lo, pitch_hi + 1, (n,), generator=gen,
                            device=device, dtype=torch.int32)
    k = torch.arange(1, harmonics + 1, device=device, dtype=torch.float32)
    f0 = 440.0 * 2.0 ** ((pitches.float() - 69.0) / 12.0)
    freq = f0[:, None] * k[None, :]
    amp = torch.rand(n, harmonics, generator=gen, device=device) / k
    amp = torch.where(freq < sr / 2.0, amp, torch.zeros_like(amp))
    phase = 2.0 * math.pi * torch.rand(n, harmonics, generator=gen,
                                       device=device)
    decay = 0.5 + 3.5 * torch.rand(n, 1, generator=gen, device=device)
    noise = torch.randn(n, length, generator=gen, device=device)
    t = torch.arange(length, device=device, dtype=torch.float32) / sr
    waves = torch.empty(n, length, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        w = torch.zeros(e - s, length, device=device)
        for h in range(harmonics):
            w += amp[s:e, h:h + 1] * torch.sin(
                2.0 * math.pi * freq[s:e, h:h + 1] * t + phase[s:e, h:h + 1])
        w *= torch.exp(-decay[s:e] * t) * torch.clamp(t / 0.01, max=1.0)
        w *= 0.8 / w.abs().amax(dim=1, keepdim=True).clamp_min(1e-6)
        waves[s:e] = w + 1e-3 * noise[s:e]
    return waves, pitches
