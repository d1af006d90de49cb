"""Progressive pitch-conditioned generator (``gansynth_tpu/models/generator.py``).

All 7 stages' blocks and toRGB heads exist from construction, so the
parameter set does not depend on the stage; the forward pass runs blocks
``0..stage`` (a Python int) and fades the new stage's toRGB output in over
the upsampled previous one with ``alpha``. The output is the 2-channel
(scaled log-mel-magnitude, mel-IF) image, NHWC, float32, through tanh.

Module names mirror the reference's parameter tree: ``latent_dense``,
``blocks[i].conv0`` / ``conv1`` (``block_i``), ``to_rgb[i]``
(``to_rgb_i``).

With ``ModelConfig.remat`` each trunk block runs under
``models.layers.remat_call`` while gradients are taken, as the reference
wraps it in ``nn.remat`` (``generator.py:96``): the same values, fewer
activations kept.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from gansynth_tpu_torch.models.layers import (
    EqualizedConv,
    EqualizedDense,
    EqualizedUpConv,
    leaky_relu,
    lerp,
    pixel_norm,
    remat_call,
    upsample_nearest,
)
from gansynth_tpu_torch.utils.config import ModelConfig


class GeneratorBlock(nn.Module):
    """One trunk stage: [upsample x2 ->] two 3x3 eq-LR convs, each followed
    by LeakyReLU and pixel norm. ``conv_kernel`` goes to both stride-1 3x3
    convs (the up-conv stays on its own lowering, as in the reference)."""

    def __init__(self, in_channels: int, features: int, upsample: bool = True,
                 lrelu_slope: float = 0.2, pn_eps: float = 1e-8,
                 compute_dtype: str = "float32", conv_kernel: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.pn_eps = pn_eps
        if upsample:
            self.conv0 = EqualizedUpConv(in_channels, features,
                                         compute_dtype=compute_dtype,
                                         generator=generator)
        else:
            self.conv0 = EqualizedConv(in_channels, features,
                                       compute_dtype=compute_dtype,
                                       conv_kernel=conv_kernel,
                                       generator=generator)
        self.conv1 = EqualizedConv(features, features,
                                   compute_dtype=compute_dtype,
                                   conv_kernel=conv_kernel,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = pixel_norm(leaky_relu(self.conv0(x), self.lrelu_slope), self.pn_eps)
        return pixel_norm(leaky_relu(self.conv1(x), self.lrelu_slope),
                          self.pn_eps)


class Generator(nn.Module):
    """latents [B, D] + one-hot pitch [B, P] -> image at ``stage``'s
    resolution [B, H, W, 2]."""

    def __init__(self, config: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        ch = cfg.stage_channels
        cdt = cfg.compute_dtype
        self.latent_dense = EqualizedDense(
            cfg.latent_dim + cfg.num_pitches,
            cfg.base_height * cfg.base_width * ch(0),
            compute_dtype=cdt, generator=generator,
        )
        self.blocks = nn.ModuleList(
            GeneratorBlock(ch(max(i - 1, 0)), ch(i), upsample=i > 0,
                           lrelu_slope=cfg.leaky_relu_slope,
                           pn_eps=cfg.pixelnorm_eps, compute_dtype=cdt,
                           conv_kernel=cfg.conv_kernel, generator=generator)
            for i in range(cfg.num_stages)
        )
        self.to_rgb = nn.ModuleList(
            EqualizedConv(ch(i), cfg.num_channels, kernel_size=(1, 1),
                          gain=1.0, compute_dtype=cdt, generator=generator)
            for i in range(cfg.num_stages)
        )

    def forward(self, z: torch.Tensor, labels: torch.Tensor, stage: int,
                alpha=1.0) -> torch.Tensor:
        cfg = self.config
        if not 0 <= stage < cfg.num_stages:
            raise ValueError(f"stage must be in [0, {cfg.num_stages}), got {stage}")
        x = pixel_norm(torch.cat([z, labels.to(z.dtype)], dim=-1),
                       cfg.pixelnorm_eps)
        x = self.latent_dense(x).reshape(
            x.shape[0], cfg.base_height, cfg.base_width, cfg.stage_channels(0)
        )
        x = pixel_norm(leaky_relu(x, cfg.leaky_relu_slope), cfg.pixelnorm_eps)
        prev = None
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(stage + 1):
            block = self.blocks[i]
            prev, x = x, remat_call(block, x) if remat else block(x)
        out = self.to_rgb[stage](x)
        if stage > 0:
            prev_rgb = self.to_rgb[stage - 1](prev)
            out = lerp(upsample_nearest(prev_rgb, 2), out, alpha)
        out = out.float()
        if cfg.generator_output == "tanh":
            out = torch.tanh(out)
        return out
