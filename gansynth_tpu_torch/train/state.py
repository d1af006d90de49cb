"""Training state, Adam and the EMA update (``gansynth_tpu/train/state.py``).

The state carries the generator, the critic, the EMA generator, one Adam
for each network, the run's threefry key and the global step. Both networks create every
parameter at construction, so the state has the same parameters at every
stage.

The optimizer is optax's ``adam`` written out: one step count shared by
all parameters, and a parameter without a gradient updated as if its
gradient were zero. ``torch.optim.Adam`` keeps a count per parameter and
skips a parameter whose ``.grad`` is ``None``, so a block that joins at a
stage boundary would restart its bias correction there (about 10x
smaller first updates than optax's with b2 = 0.99).
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from gansynth_tpu_torch.models.discriminator import Discriminator
from gansynth_tpu_torch.models.generator import Generator
from gansynth_tpu_torch.synth import random as jrandom
from gansynth_tpu_torch.utils.config import Config


class Adam(torch.optim.Optimizer):
    """optax.adam: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2)
    g^2``, ``p -= lr mu_hat / (sqrt(nu_hat) + eps)`` with the bias
    corrections of one shared ``count``, taken in float32 as optax does.

    The bias corrections are computed on the host from the count
    (:meth:`bias_corrections`) and reach :meth:`update` as 0-d tensors on
    the parameters' device, so that a CUDA graph of the train step reads
    each step's own (a Python float would be frozen at the capture). The
    train step stages them and advances ``count`` itself
    (``train/step.py``); :meth:`step` is the same update for a caller
    that holds gradients in ``.grad``."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.count = 0

    # The shared count is state: it rides along when the optimizer is
    # copied, pickled or saved (``Optimizer`` keeps only its own fields).
    def __getstate__(self):
        return {**super().__getstate__(), "count": self.count}

    def state_dict(self):
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """``(1 - b1^count, 1 - b2^count)`` in float32, as optax takes
        them at its ``count``-th update."""
        group = self.param_groups[0]
        return (float(1 - np.float32(group["b1"]) ** count),
                float(1 - np.float32(group["b2"]) ** count))

    def init_moments(self) -> None:
        """Zero moments for every parameter that has none yet (a fresh or
        restored-at-0 optimizer), as the first update would make them."""
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)

    @torch.no_grad()
    def update(self, bc1: torch.Tensor, bc2: torch.Tensor) -> None:
        """One update with the bias corrections ``bc1``, ``bc2`` (0-d
        float32 tensors on the parameters' device); ``count`` is left to
        the caller."""
        self.init_moments()
        for group in self.param_groups:
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu, nu = self.state[p]["mu"], self.state[p]["nu"]
                mu.mul_(b1).add_(g * (1.0 - b1))
                nu.mul_(b2).add_(g * g * (1.0 - b2))
                update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.add_(update * -lr)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        self.count += 1
        device = self.param_groups[0]["params"][0].device
        self.update(*(torch.tensor(v, dtype=torch.float32, device=device)
                      for v in self.bias_corrections(self.count)))


def make_optimizer(config: Config, params: Iterable[torch.Tensor]) -> Adam:
    """One Adam per network (the reference makes two from one config)."""
    t = config.train
    return Adam(params, t.learning_rate, b1=t.adam_beta1, b2=t.adam_beta2,
                eps=t.adam_eps)


@torch.no_grad()
def ema_update(ema: nn.Module, model: nn.Module, decay: float) -> None:
    """In place: ``e = e * decay + p * (1 - decay)`` for every parameter."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(e * decay + p * (1.0 - decay))


@dataclasses.dataclass
class TrainState:
    """Everything one training step reads and updates. ``rng`` is the run's
    threefry key (two uint32 words, as ``jax.random.key_data`` gives them)
    and ``step`` the global step; the step draws its noise from
    ``fold_in(rng, step)``, as the reference does, so a resumed run replays
    the noise of an unbroken one."""

    g: Generator
    d: Discriminator
    ema: Generator
    g_opt: Adam
    d_opt: Adam
    rng: Tuple[int, int]
    step: int = 0


def train_key(seed: int) -> Tuple[int, int]:
    """The reference's state key (``train/state.py:create_train_state``):
    ``key(seed)`` split into (kg, kd, krest); the state keeps krest."""
    return jrandom.split(jrandom.seed_to_key(seed), 3)[2]


def _flax_param_key(key: jrandom.Key, path: Tuple) -> jrandom.Key:
    """flax's key of one parameter (``flax/core/scope.py:_fold_in_static``,
    flax 0.12.3 without ``flax_fix_rng_separator``): the first 4 bytes of
    the SHA-1 of the scope path, names as UTF-8 and the scope's rng
    counter as big-endian bytes, folded into the network's key."""
    digest = hashlib.sha1()
    for part in path:
        digest.update(part.encode() if isinstance(part, str)
                      else part.to_bytes((part.bit_length() + 7) // 8, "big"))
    return jrandom.fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


@torch.no_grad()
def init_like_reference(network: nn.Module, key: jrandom.Key) -> None:
    """In place: the weights ``network.init(key, ...)`` gives in the
    reference. Every module's kernel is its first parameter (rng counter
    1), drawn ``normal(1.0)`` in the reference's layout (HWIO, [in, out])
    and transposed; biases are zeros (``gansynth_tpu/models/layers.py:
    50,60``). The normals equal JAX's to an ulp or so
    (``synth/random.py``)."""
    from gansynth_tpu_torch.utils.checkpoint import _jax_path

    for name, p in network.named_parameters():
        *scope, leaf = _jax_path(name)
        if leaf == "bias":
            p.zero_()
            continue
        perm = (1, 0) if p.ndim == 2 else (2, 3, 1, 0)   # port -> reference
        w = jrandom.normal(_flax_param_key(key, (*scope, 1)),
                           [p.shape[i] for i in perm])
        p.copy_(torch.from_numpy(np.ascontiguousarray(
            w.transpose(np.argsort(perm)))))


def create_train_state(config: Config, seed: Optional[int] = None,
                       device="cuda", g: Optional[Generator] = None,
                       ema: Optional[Generator] = None) -> TrainState:
    """Fresh state on ``device``, as the reference makes it for ``seed``
    (``config.train.seed`` if None): ``key(seed)`` split into (kg, kd,
    krest); G and D initialised from kg and kd
    (:func:`init_like_reference`), or the given ``g`` (and ``ema``, else a
    copy of ``g``); Adam fresh for both; krest as the state's key
    (:func:`train_key`). Every process that makes the state from one seed
    holds the same weights. ``model.architecture = "wavegan"`` makes
    WaveGAN's networks (``models/wavegan.py``), initialised by
    ``init_wavegan`` from the same keys."""
    from gansynth_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    seed = config.train.seed if seed is None else seed
    kg, kd, _ = jrandom.split(jrandom.seed_to_key(seed), 3)
    if config.model.architecture == "wavegan":
        from gansynth_tpu_torch.models.wavegan import (
            WaveGANDiscriminator,
            WaveGANGenerator,
            init_wavegan,
        )

        make_g, make_d, init = (WaveGANGenerator, WaveGANDiscriminator,
                                init_wavegan)
    else:
        make_g, make_d, init = Generator, Discriminator, init_like_reference
    if g is None:
        g = make_g(config.model)
        init(g, kg)
    d = make_d(config.model)
    init(d, kd)
    g, d = g.to(dev).train(), d.to(dev).train()
    ema = (copy.deepcopy(g) if ema is None else ema.to(dev)).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
    return TrainState(g=g, d=d, ema=ema,
                      g_opt=make_optimizer(config, g.parameters()),
                      d_opt=make_optimizer(config, d.parameters()),
                      rng=train_key(seed))


def state_from_ema(config: Config, npz_path: str, device="cuda",
                   seed: Optional[int] = None) -> TrainState:
    """A state that resumes from an exported run: G and the EMA from the
    run's ``ema.npz``, D from the seeded init (the archive holds no D),
    Adam fresh, the seed's key, and the archive's step as the global
    step."""
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    g, step, _ = load_ema_generator(npz_path, config.model, device)
    ema = load_ema_generator(npz_path, config.model, device)[0]
    state = create_train_state(config, seed=seed, device=device, g=g,
                               ema=ema)
    state.step = step
    return state
