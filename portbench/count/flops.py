"""Model FLOPs of the flagship's networks, layer by layer, from the
configuration's shapes (``model``: the ``model`` group of a
``configs/<config>.json``).

Counted: the multiply-adds of every convolution and dense layer, two
operations each. Elementwise work (activations, normalisation, pooling,
the minibatch statistic) is left out, as model FLOPs leave it out. The
generator's upsampling conv (nearest x2, then a 3x3 conv) is counted as
the transposed 4x4 stride-2 conv it equals, 4 taps an output pixel: the
least work its function needs. Nothing recomputed is counted.
"""

from __future__ import annotations

from typing import List, Mapping, Tuple

Layer = Tuple[str, float]


def channels(model: Mapping, stage: int) -> int:
    """The trunk's width at ``stage``: ``min(fmap_base >> stage,
    fmap_max)``, at least ``fmap_min``."""
    return max(min(model["fmap_base"] >> stage, model["fmap_max"]),
               model["fmap_min"])


def resolution(model: Mapping, stage: int) -> Tuple[int, int]:
    return model["base_height"] << stage, model["base_width"] << stage


def _conv(cin: int, cout: int, hw: Tuple[int, int], taps: int) -> float:
    return 2.0 * taps * cin * cout * hw[0] * hw[1]


def generator_layers(model: Mapping, stage: int) -> List[Layer]:
    """One note's forward: the latent dense layer, blocks ``0..stage``
    (block 0 two 3x3 convs; later blocks an upsampling conv and a 3x3
    conv) and the toRGB heads of ``stage`` and, fading, ``stage - 1``."""
    ch = lambda s: channels(model, s)
    latent_in = model["latent_dim"] + model["num_pitches"]
    base = model["base_height"] * model["base_width"] * ch(0)
    out = [("latent_dense", 2.0 * latent_in * base)]
    for i in range(stage + 1):
        hw = resolution(model, i)
        if i == 0:
            out.append((f"block_{i}.conv0", _conv(ch(0), ch(0), hw, 9)))
        else:
            out.append((f"block_{i}.conv0", _conv(ch(i - 1), ch(i), hw, 4)))
        out.append((f"block_{i}.conv1", _conv(ch(i), ch(i), hw, 9)))
    rgb = model["num_channels"]
    out.append((f"to_rgb_{stage}",
                _conv(ch(stage), rgb, resolution(model, stage), 1)))
    if stage > 0:
        out.append((f"to_rgb_{stage - 1}",
                    _conv(ch(stage - 1), rgb, resolution(model, stage - 1),
                          1)))
    return out


def critic_layers(model: Mapping, stage: int) -> List[Layer]:
    """One image's forward: fromRGB at ``stage`` (and the skip's at
    ``stage - 1``), blocks ``stage..1`` (two 3x3 convs each), the final
    3x3 conv over the widths plus the minibatch statistic, the final dense
    layer and the two heads."""
    ch = lambda s: channels(model, s)
    rgb = model["num_channels"]
    out = [(f"from_rgb_{stage}",
            _conv(rgb, ch(stage), resolution(model, stage), 1))]
    for i in range(stage, 0, -1):
        hw = resolution(model, i)
        out.append((f"block_{i}.conv0", _conv(ch(i), ch(i), hw, 9)))
        out.append((f"block_{i}.conv1", _conv(ch(i), ch(i - 1), hw, 9)))
        if i == stage:
            out.append((f"from_rgb_{stage - 1}",
                        _conv(rgb, ch(stage - 1),
                              resolution(model, stage - 1), 1)))
    hw0 = resolution(model, 0)
    out.append(("final_conv", _conv(ch(0) + 1, ch(0), hw0, 9)))
    out.append(("final_dense", 2.0 * hw0[0] * hw0[1] * ch(0) * ch(0)))
    out.append(("critic_head", 2.0 * ch(0)))
    out.append(("pitch_head", 2.0 * ch(0) * model["num_pitches"]))
    return out


def generator_flops(model: Mapping, stage: int) -> float:
    """One note through the generator at ``stage``."""
    return sum(f for _, f in generator_layers(model, stage))


def critic_flops(model: Mapping, stage: int) -> float:
    """One image through the critic at ``stage``."""
    return sum(f for _, f in critic_layers(model, stage))


# A forward pass F, its backward to the inputs F and to the weights F.
# Critic update, per sample: G forward (no gradient) 1 F_G; critic
# forwards on real, fake and interpolates 3 F_D; the penalty's gradient
# to the interpolates 1 F_D; the real and fake passes' backward 2 x 2
# F_D; the penalty's second order: the interpolates pass's backward 2 F_D
# and the backward of its input-gradient chain 2 F_D. Generator update:
# G forward 1 F_G, critic forward 1 F_D and its backward to the image
# 1 F_D, G's backward 2 F_G.
STEP_G_PASSES = 4
STEP_D_PASSES = 14


def train_step_flops(model: Mapping, stage: int, batch: int) -> float:
    """One WGAN-GP step at ``stage`` on ``batch`` samples."""
    return batch * (STEP_G_PASSES * generator_flops(model, stage)
                    + STEP_D_PASSES * critic_flops(model, stage))


def dblock_work(model: Mapping, batch: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one call of the final stage's critic block
    (K3): two 3x3 convs at the full resolution, bf16 in and out, the
    weights and biases read once."""
    stage = model["num_stages"] - 1
    h, w = resolution(model, stage)
    c0, c1 = channels(model, stage), channels(model, stage - 1)
    flops = 2.0 * batch * h * w * 9 * c0 * (c0 + c1)
    nbytes = 2.0 * (batch * h * w * c0 + batch * h * w // 4 * c1
                    + 9 * c0 * (c0 + c1) + c0 + c1)
    return flops, nbytes
