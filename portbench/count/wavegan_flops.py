"""Model FLOPs of WaveGAN's networks, layer by layer, from the
configuration's shapes (``model``: the ``model`` group of
``configs/wavegan-65536-train.json`` over the port's defaults; kernel 25,
stride 4 and 65536 samples are the architecture's).

Counted as ``count/flops.py`` counts the flagship: the multiply-adds of
every conv and dense layer, two operations each; elementwise work (the
activations, the pads, phase shuffle) left out; nothing recomputed. A
conv of stride s and kernel k from C_in to C_out channels at L outputs is
``L k C_in C_out`` multiply-adds; its transpose the same at its L inputs.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

Layer = Tuple[str, float]
LAYERS, KERNEL, STRIDE, SLICE_LEN = 6, 25, 4, 65536
BASE = SLICE_LEN // STRIDE ** LAYERS


def _widths(model: Mapping) -> List[int]:
    return [1] + [model["wavegan_dim"] << i for i in range(LAYERS)]


def generator_layers(model: Mapping) -> List[Layer]:
    """One note's forward: ``z_project``, ``upconv_0..5``."""
    c = _widths(model)
    inputs = model["latent_dim"] + model["num_pitches"]
    out = [("z_project", 2.0 * inputs * BASE * c[-1])]
    length = BASE
    for i in range(LAYERS):
        cin, cout = c[LAYERS - i], c[LAYERS - 1 - i]
        out.append((f"upconv_{i}", 2.0 * length * KERNEL * cin * cout))
        length *= STRIDE
    return out


def critic_layers(model: Mapping) -> List[Layer]:
    """One note's forward: ``downconv_0..5`` and the two heads."""
    c = _widths(model)
    out, length = [], SLICE_LEN
    for i in range(LAYERS):
        length //= STRIDE
        out.append((f"downconv_{i}", 2.0 * length * KERNEL * c[i] * c[i + 1]))
    flat = BASE * c[-1]
    out += [("critic_head", 2.0 * flat),
            ("pitch_head", 2.0 * flat * model["num_pitches"])]
    return out


def generator_flops(model: Mapping) -> float:
    return sum(f for _, f in generator_layers(model))


def critic_flops(model: Mapping) -> float:
    return sum(f for _, f in critic_layers(model))


def passes(critic_updates: int) -> Tuple[int, int]:
    """``(G passes, D passes)`` a step, a forward pass F, its backward to
    the inputs F and to the weights F, as ``count/flops.py`` counts them.
    Each critic update: G forward 1 F_G; the critic on real, fake and
    interpolates 3 F_D, the penalty's input gradient 1 F_D, the real and
    fake passes' backward 2 x 2 F_D, the penalty's second order 4 F_D.
    The generator update: G forward 1 F_G and backward 2 F_G; the critic
    forward 1 F_D and its backward to the wave 1 F_D."""
    return critic_updates + 3, 12 * critic_updates + 2


def train_step_flops(model: Mapping, batch: int, critic_updates: int
                     ) -> float:
    """One step of ``critic_updates`` critic updates and the generator
    update on ``batch`` notes each."""
    g, d = passes(critic_updates)
    return batch * (g * generator_flops(model) + d * critic_flops(model))
