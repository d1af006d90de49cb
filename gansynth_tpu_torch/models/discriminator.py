"""Progressive critic with an auxiliary pitch head
(``gansynth_tpu/models/discriminator.py``).

fromRGB at the input resolution (with its LeakyReLU, K5 on a card:
``EqualizedConv.lrelu``), blocks ``stage..1`` (two 3x3 eq-LR convs
and a 2x2 average pool each, down to the 2 x 16 base grid), minibatch
stddev, a final conv and dense trunk, then two heads: a scalar WGAN critic
score and 61-way pitch logits. The heads take no ``compute_dtype`` and run
in float32, as in the reference.

Every parameter exists from construction, so the parameter set does not
depend on the stage; the reference's zero-input calls on inactive blocks
(``discriminator.py:160-161``) only create parameters and are not made.
Module names mirror the reference's tree: ``from_rgb[i]`` (``from_rgb_i``),
``blocks["i"].conv0`` / ``conv1`` (``block_i``), ``final_conv``,
``final_dense``, ``critic_head``, ``pitch_head``.

With ``ModelConfig.remat`` each trunk block runs under
``models.layers.remat_call`` while gradients are taken, as the reference
wraps it in ``nn.remat`` (``discriminator.py:139``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from gansynth_tpu_torch.kernels.dblock import dblock_eligible, fused_dblock
from gansynth_tpu_torch.models.layers import (
    EqualizedConv,
    EqualizedDense,
    downsample_avg,
    he_scale,
    leaky_relu,
    lerp,
    minibatch_stddev,
    remat_call,
)
from gansynth_tpu_torch.utils.config import ModelConfig


class DiscriminatorBlock(nn.Module):
    """Two 3x3 eq-LR convs with LeakyReLU, then a 2x2 average pool; the
    input has ``features`` channels (the stage's width), as in every block
    of the critic.

    With ``dblock_kernel="pallas"`` an input that passes ``dblock_eligible``
    (the 64-channel stage-6 geometry) runs the whole chain through K3
    (``kernels.dblock.fused_dblock``) with the same parameters, their
    eq-LR scale folded in; other inputs take the convs below.
    """

    def __init__(self, features: int, out_features: int,
                 lrelu_slope: float = 0.2, compute_dtype: str = "float32",
                 conv_kernel: str = "xla", dblock_kernel: str = "xla",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lrelu_slope = lrelu_slope
        self.dblock_kernel = dblock_kernel
        self.conv0 = EqualizedConv(features, features,
                                   compute_dtype=compute_dtype,
                                   conv_kernel=conv_kernel,
                                   generator=generator)
        self.conv1 = EqualizedConv(features, out_features,
                                   compute_dtype=compute_dtype,
                                   conv_kernel=conv_kernel,
                                   generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0, c1 = self.conv0, self.conv1
        if self.dblock_kernel == "pallas" and dblock_eligible(
                x.shape, c0.weight.shape[0], c1.weight.shape[0]):
            gain = float(np.sqrt(2.0))
            k0 = c0.weight * he_scale(9 * x.shape[-1], gain)
            k1 = c1.weight * he_scale(9 * c0.weight.shape[0], gain)
            return fused_dblock(x.to(c0.compute_dtype).contiguous(), k0,
                                c0.bias, k1, c1.bias, self.lrelu_slope)
        x = leaky_relu(c0(x), self.lrelu_slope)
        x = leaky_relu(c1(x), self.lrelu_slope)
        return downsample_avg(x, 2)


class Discriminator(nn.Module):
    """image at ``stage``'s resolution [B, H, W, 2] -> (critic score [B],
    pitch logits [B, num_pitches]), both float32."""

    def __init__(self, config: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = cfg = config
        ch = cfg.stage_channels
        cdt = cfg.compute_dtype
        self.from_rgb = nn.ModuleList(
            EqualizedConv(cfg.num_channels, ch(i), kernel_size=(1, 1),
                          compute_dtype=cdt, generator=generator)
            for i in range(cfg.num_stages)
        )
        self.blocks = nn.ModuleDict({
            str(i): DiscriminatorBlock(
                ch(i), ch(i - 1), lrelu_slope=cfg.leaky_relu_slope,
                compute_dtype=cdt, conv_kernel=cfg.conv_kernel,
                dblock_kernel=cfg.dblock_kernel, generator=generator)
            for i in range(cfg.num_stages - 1, 0, -1)
        })
        self.final_conv = EqualizedConv(ch(0) + 1, ch(0), compute_dtype=cdt,
                                        generator=generator)
        self.final_dense = EqualizedDense(
            cfg.base_height * cfg.base_width * ch(0), ch(0),
            compute_dtype=cdt, generator=generator)
        self.critic_head = EqualizedDense(ch(0), 1, gain=1.0,
                                          generator=generator)
        self.pitch_head = EqualizedDense(ch(0), cfg.num_pitches, gain=1.0,
                                         generator=generator)

    def forward(self, image: torch.Tensor, stage: int, alpha=1.0,
                mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``mesh``: ``image`` is this rank's rows of a batch sharded over
        a data-parallel mesh, and the minibatch-stddev statistic is the
        global batch's (``layers.minibatch_stddev``)."""
        cfg = self.config
        if not 0 <= stage < cfg.num_stages:
            raise ValueError(f"stage must be in [0, {cfg.num_stages}), got {stage}")
        expected = cfg.stage_resolution(stage)
        if tuple(image.shape[1:3]) != expected:
            raise ValueError(f"stage {stage} expects {expected} images, got "
                             f"{tuple(image.shape[1:3])}")
        slope = cfg.leaky_relu_slope
        x = self.from_rgb[stage].lrelu(image, slope)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(stage, 0, -1):
            block = self.blocks[str(i)]
            x = remat_call(block, x) if remat else block(x)
            if i == stage:
                skip = self.from_rgb[stage - 1].lrelu(
                    downsample_avg(image, 2), slope)
                x = lerp(skip, x, alpha)
        x = minibatch_stddev(x, cfg.mbstd_group_size, cfg.mbstd_eps,
                             cfg.mbstd_replicas, mesh)
        x = leaky_relu(self.final_conv(x), slope)
        x = leaky_relu(self.final_dense(x.reshape(x.shape[0], -1)), slope)
        critic = self.critic_head(x)[:, 0]
        return critic, self.pitch_head(x)
