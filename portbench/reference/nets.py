"""The progressive generator and critic of GANSynth (Karras et al.'s
progressive GAN with equalized learning rate, pitch-conditioned), NHWC,
from parameter dicts in the published (flax) layout: ``"block_6/conv0/
kernel"`` [3, 3, C_in, C_out], dense kernels [in, out].

Equalized learning rate: a kernel is used times ``gain / sqrt(fan_in)``
(gain sqrt 2; 1 for toRGB and the two critic heads). Generator: pixel
norm of [z, one-hot pitch], dense to the 2 x 16 base grid, LeakyReLU 0.2,
pixel norm; per block: (nearest x2 upsampling from block 1 on) 3x3 conv,
LeakyReLU, pixel norm, twice; toRGB 1x1, faded over the upsampled toRGB
of the previous block by alpha; tanh. Critic: fromRGB 1x1 and LeakyReLU;
per block from the top: two 3x3 convs with LeakyReLU and 2x2 average
pooling, the first block faded over fromRGB of the pooled image;
minibatch stddev over groups of 4; 3x3 conv, dense, each with LeakyReLU;
a score head and a pitch-logit head.

``q`` is applied to the inputs and the scaled weights of every conv and
dense layer: the identity for the float32 reference, a lower precision
for the control (``quantize.fp8``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
SQRT2 = math.sqrt(2.0)


def _same(x):
    return x


def npz_key(key: str) -> str:
    """``"['params']['block_6']['conv0']['kernel']"`` -> ``"block_6/conv0/
    kernel"``."""
    parts = [p for p in key.replace("]", "").split("[") if p]
    parts = [p.strip("'") for p in parts]
    if parts and parts[0] == "params":
        parts = parts[1:]
    return "/".join(parts)


def conv(x, p: Params, name: str, gain=SQRT2, q=_same):
    k = p[name + "/kernel"]
    kh, kw, cin, _ = k.shape
    w = q(k * (gain / math.sqrt(kh * kw * cin)))
    y = F.conv2d(q(x).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1) + p[name + "/bias"]


def dense(x, p: Params, name: str, gain=SQRT2, q=_same):
    k = p[name + "/kernel"]
    w = q(k * (gain / math.sqrt(k.shape[0])))
    return q(x) @ w + p[name + "/bias"]


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def pixel_norm(x, eps=1e-8):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)


def up2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def down2(x):
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))


def fade(a, b, alpha):
    return a + (b - a) * alpha


def onehot(pitch: torch.Tensor, model: Mapping) -> torch.Tensor:
    idx = torch.clamp(pitch.long() - model["pitch_min"], 0,
                      model["num_pitches"] - 1)
    return F.one_hot(idx, model["num_pitches"]).float()


def generator(p: Params, z, labels, stage: int, alpha, model: Mapping,
              q=_same) -> torch.Tensor:
    """[B, latent] + one-hot [B, P] -> image [B, H, W, 2] at ``stage``."""
    x = pixel_norm(torch.cat([z, labels], dim=-1))
    x = dense(x, p, "latent_dense", q=q)
    c0 = p["block_0/conv1/kernel"].shape[-1]
    x = pixel_norm(lrelu(x.reshape(x.shape[0], model["base_height"],
                                   model["base_width"], c0)))
    prev = None
    for i in range(stage + 1):
        prev = x
        if i > 0:
            x = up2(x)
        x = pixel_norm(lrelu(conv(x, p, f"block_{i}/conv0", q=q)))
        x = pixel_norm(lrelu(conv(x, p, f"block_{i}/conv1", q=q)))
    out = conv(x, p, f"to_rgb_{stage}", gain=1.0, q=q)
    if stage > 0:
        prev_rgb = conv(prev, p, f"to_rgb_{stage - 1}", gain=1.0, q=q)
        out = fade(up2(prev_rgb), out, alpha)
    return torch.tanh(out)


def minibatch_stddev(x, group: int = 4, eps: float = 1e-8):
    b, h, w, c = x.shape
    g = group if b % group == 0 else b
    y = x.reshape(g, b // g, h, w, c)
    var = torch.mean((y - y.mean(dim=0, keepdim=True)) ** 2, dim=0)
    stat = torch.mean(torch.sqrt(var + eps), dim=(1, 2, 3))
    stat = stat.repeat(g)[:, None, None, None].expand(b, h, w, 1)
    return torch.cat([x, stat], dim=-1)


def critic(p: Params, image, stage: int, alpha, model: Mapping,
           q=_same) -> Tuple[torch.Tensor, torch.Tensor]:
    """image [B, H, W, 2] at ``stage`` -> (scores [B], pitch logits)."""
    x = lrelu(conv(image, p, f"from_rgb_{stage}", q=q))
    for i in range(stage, 0, -1):
        x = lrelu(conv(x, p, f"block_{i}/conv0", q=q))
        x = lrelu(conv(x, p, f"block_{i}/conv1", q=q))
        x = down2(x)
        if i == stage:
            skip = lrelu(conv(down2(image), p, f"from_rgb_{stage - 1}",
                              q=q))
            x = fade(skip, x, alpha)
    x = minibatch_stddev(x, model["mbstd_group_size"], model["mbstd_eps"])
    x = lrelu(conv(x, p, "final_conv", q=q))
    x = lrelu(dense(x.reshape(x.shape[0], -1), p, "final_dense", q=q))
    return (dense(x, p, "critic_head", gain=1.0, q=q)[:, 0],
            dense(x, p, "pitch_head", gain=1.0, q=q))
