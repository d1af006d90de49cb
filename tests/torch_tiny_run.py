"""A tiny run directory that both packages' CLIs restore: ``ema.npz``
written by the port's ``save_ema_npz`` from weights made in JAX, and a
``train_config.json``. The offline-CLI and evaluation tests share it.

The config is narrow (latent 8, fmap_base 64, fmap_max 16) with a short
ladder, so a checkpoint at step 5 sits at stage 1 by the schedule (its
image is nearest-upsampled to 128x1024 before synthesis).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gansynth_tpu.models import Generator as JGenerator
from gansynth_tpu.utils.config import Config as JConfig
from gansynth_tpu_torch.models.generator import Generator as TGenerator
from gansynth_tpu_torch.utils.checkpoint import from_jax_params, save_ema_npz
from gansynth_tpu_torch.utils.config import Config as TConfig
from gansynth_tpu_torch.utils.config import as_dict

TINY = {"model": {"latent_dim": 8, "fmap_base": 64, "fmap_max": 16,
                  "fmap_min": 8},
        "train": {"batch_size": 2, "stage_fade_steps": [0, 3, 3, 3, 3, 3, 3],
                  "stage_stable_steps": [3, 100, 3, 3, 3, 3, 3]}}
STEP = 5          # stage 1 by the schedule (stage_and_alpha(STEP - 1))
NPZ_STAGE = 2     # the stage recorded in the ema.npz of `make_run`


def configs():
    """(reference Config, port Config) of ``TINY``."""
    return JConfig().with_overrides(TINY), TConfig().with_overrides(TINY)


def tiny_params(seed: int = 0):
    """Reference generator parameters (a flax tree): JAX's init plus
    noise of scale 0.1, so every block's output carries signal."""
    jcfg, _ = configs()
    params = JGenerator(jcfg.model).init(
        jax.random.key(seed), jnp.zeros((1, 8)), jnp.zeros((1, 61)), 0,
        jnp.float32(1.0))
    rng = np.random.default_rng(seed + 5)
    return jax.tree.map(
        lambda p: p + jnp.asarray(
            0.1 * rng.standard_normal(p.shape).astype(np.float32)), params)


def port_generator(params, config=None) -> torch.nn.Module:
    """The port's generator holding ``params``."""
    config = config or configs()[1]
    g = TGenerator(config.model)
    g.load_state_dict(from_jax_params(params))
    return g.eval()


def make_run(path: str, params, *, stage=NPZ_STAGE, step=STEP,
             dtype=None, config=TINY) -> str:
    """Write ``train_config.json`` and ``ema.npz`` (``__stage__`` only when
    ``stage`` is not None) into ``path``; returns ``path``."""
    os.makedirs(path, exist_ok=True)
    tcfg = TConfig().with_overrides(config)
    with open(os.path.join(path, "train_config.json"), "w") as f:
        json.dump(as_dict(tcfg), f, indent=2, sort_keys=True)
    g = port_generator(params, TConfig().with_overrides(TINY))
    save_ema_npz(os.path.join(path, "ema.npz"), g, step, stage=stage,
                 dtype=dtype)
    return path
