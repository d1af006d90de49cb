"""WGAN-GP, drift and auxiliary pitch losses (``gansynth_tpu/train/losses.py``).

The critic passed in is a function ``image -> (scores [B], pitch logits
[B, P])``. The gradient penalty keeps its graph
(``create_graph=True``), so differentiating it with respect to the
critic's parameters is the second-order gradient WGAN-GP needs.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def wgan_critic_loss(critic_real: torch.Tensor,
                     critic_fake: torch.Tensor) -> torch.Tensor:
    """E[D(fake)] - E[D(real)] (the critic minimizes this)."""
    return torch.mean(critic_fake) - torch.mean(critic_real)


def interpolate(real: torch.Tensor, fake: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Per-sample interpolates ``real + u (fake - real)``, ``u`` [B, 1, 1,
    1] uniform in [0, 1) (the reference draws it from its key)."""
    return real + u * (fake - real)


def penalty_from_grads(grads: torch.Tensor) -> torch.Tensor:
    """E[(||g||_2 - 1)^2] over per-sample gradient norms."""
    norms = torch.sqrt(
        torch.sum(torch.square(grads), dim=tuple(range(1, grads.ndim)))
        + 1e-12)
    return torch.mean(torch.square(norms - 1.0))


def gradient_penalty(
    critic_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    real: torch.Tensor, fake: torch.Tensor, u: torch.Tensor,
) -> torch.Tensor:
    """E[(||grad_x D(x_hat)||_2 - 1)^2] on uniform interpolates.

    The gradient is of the SUM of the critic scores with respect to the
    whole interpolated batch, so the coupling across samples that minibatch
    stddev adds is included, as in the reference.
    """
    x_hat = interpolate(real, fake, u).detach().requires_grad_()
    grads, = torch.autograd.grad(critic_fn(x_hat)[0].sum(), x_hat,
                                 create_graph=True)
    return penalty_from_grads(grads)


def drift_penalty(critic_real: torch.Tensor) -> torch.Tensor:
    """E[D(real)^2] (the PGGAN epsilon-drift term)."""
    return torch.mean(torch.square(critic_real))


def pitch_cross_entropy(logits: torch.Tensor,
                        labels_onehot: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy against one-hot pitch labels."""
    logprobs = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels_onehot * logprobs, dim=-1))


def generator_adversarial_loss(critic_fake: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)] (the generator maximizes the critic's score)."""
    return -torch.mean(critic_fake)
