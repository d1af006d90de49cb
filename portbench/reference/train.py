"""The WGAN-GP step of GANSynth's progressive training, plain torch, for
the first steps of a run: the reference the training cell is held to.

One step at ``stage`` on a batch of waves and pitches: the mel-IF
frontend; the critic update (critic on real, on the generator's fake
from ``z_d`` and on the interpolates ``real + u (fake - real)``; loss
``E[D(fake)] - E[D(real)] + gp_weight E[(|grad D(x_hat)| - 1)^2] +
drift_weight E[D(real)^2] + aux_pitch_weight CE(real logits)`` (and the
fake logits' CE while ``d_pitch_ce_on_fake``); Adam); the generator
update on fresh latents ``z_g`` against the updated critic (``-E[D(G)] +
aux_pitch_weight CE``; Adam); the EMA ``e <- decay e + (1 - decay) g``.
Adam is optax's: one count for all parameters, bias corrections taken
in float32, a parameter without a gradient updated as with a zero one.
The noise and the cached batch's indices come from the run's key as the
program's contract states them: ``split(fold_in(key, step), 3)`` for
``(z_d, u, z_g)``, and per-epoch permutations keyed by
``fold_in(fold_in(key, 0x5E0F), epoch)`` for the ``shuffle`` stream.

The pitch-consistency loss is not written here: the cells run past its
release step, where the configuration turns it off; a run that would
need it raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from portbench.reference import nets, spectral, threefry as tf


def train_key(seed: int):
    """The state's key of a run seeded ``seed``: the third of
    ``split(key(seed), 3)``."""
    return tf.split(tf.seed_to_key(seed), 3)[2]


def step_noise(key, step: int, batch: int, latent: int):
    k_zd, k_u, k_zg = tf.split(tf.fold_in(key, step), 3)
    return (tf.normal(k_zd, (batch, latent)),
            tf.uniform(k_u, (batch, 1, 1, 1)),
            tf.normal(k_zg, (batch, latent)))


def batch_indices(key, step: int, batch: int, n: int) -> np.ndarray:
    """The ``shuffle`` stream's batch at ``step``: epoch permutations of
    [0, n) read at example offset ``step * batch``."""
    base = tf.fold_in(key, 0x5E0F)
    pos = step * batch + np.arange(batch)
    out = np.empty(batch, np.int64)
    for e in np.unique(pos // n):
        perm = tf.permutation(tf.fold_in(base, int(e)), n)
        sel = pos // n == e
        out[sel] = perm[pos[sel] % n]
    return out


def released(train: Mapping, step: int) -> Dict:
    """The train settings in force at ``step``: past
    ``pitch_consistency_release_step`` the consistency loss and the fake
    logits' CE are off."""
    t = dict(train)
    rel = t.get("pitch_consistency_release_step")
    if rel is not None and step >= rel:
        t["pitch_consistency_weight"] = 0.0
        t["d_pitch_ce_on_fake"] = False
    return t


def _ce(logits, labels):
    return -torch.mean(torch.sum(labels * torch.log_softmax(logits, -1), -1))


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], train: Mapping):
        self.b1, self.b2 = train["adam_beta1"], train["adam_beta2"]
        self.eps, self.lr = train["adam_eps"], train["learning_rate"]
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def update(self, params, grads) -> None:
        self.count += 1
        bc1 = float(1 - np.float32(self.b1) ** self.count)
        bc2 = float(1 - np.float32(self.b2) ** self.count)
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = self.b1 * self.mu[k] + (1.0 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1.0 - self.b2) * g * g
            p -= self.lr * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + self.eps)


def _grads(loss, params: Dict[str, torch.Tensor]):
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g.detach()
            for (k, p), g in zip(params.items(), got)}


def run_steps(cfg: Mapping, g_params, d_params, waves, pitches, key,
              step0: int, stage: int, steps: int, q=nets._same,
              half: bool = False) -> Dict[str, object]:
    """``steps`` steps from ``step0``: per step ``d_loss`` and ``g_loss``;
    the first step's gradients per leaf (``grads_g``, ``grads_d``, names
    as given); each network's parameters after the last step
    (``g``, ``d``, ``ema``). ``waves`` [N, T] and ``pitches`` [N] are the
    cached notes on the device the step runs on. ``half`` leaves out the
    second half of every batch (a planted fault)."""
    model, audio = cfg["model"], cfg["audio"]
    batch = cfg["train"]["stage_batch_sizes"][stage]
    n = waves.shape[0]
    dev = waves.device
    g = {k: v.detach().clone().float().requires_grad_() for k, v in
         g_params.items()}
    d = {k: v.detach().clone().float().requires_grad_() for k, v in
         d_params.items()}
    ema = {k: v.detach().clone().float() for k, v in g_params.items()}
    opt_g, opt_d = Adam(g, cfg["train"]), Adam(d, cfg["train"])
    out: Dict[str, object] = {"d_loss": [], "g_loss": []}
    for i in range(steps):
        step = step0 + i
        t = released(cfg["train"], step)
        if t["pitch_consistency_weight"] > 0 and \
                stage >= t["pitch_consistency_min_stage"]:
            raise NotImplementedError("pitch-consistency loss")
        idx = torch.from_numpy(batch_indices(key, step, batch, n)).to(dev)
        z_d, u, z_g = (torch.from_numpy(a).to(dev) for a in
                       step_noise(key, step, batch, model["latent_dim"]))
        wave, pitch = waves[idx], pitches[idx]
        if half:
            m = batch // 2
            wave, pitch, z_d, u, z_g = (a[:m] for a in
                                        (wave, pitch, z_d, u, z_g))
        labels = nets.onehot(pitch, model)
        alpha = 1.0
        with torch.no_grad():
            real = spectral.wave_to_image(wave, audio)
            factor = 1 << (model["num_stages"] - 1 - stage)
            if factor > 1:
                b, h, w, c = real.shape
                real = real.reshape(b, h // factor, factor, w // factor,
                                    factor, c).mean(dim=(2, 4))
            fake = nets.generator(g, z_d, labels, stage, alpha, model, q)

        def crit(x):
            return nets.critic(d, x, stage, alpha, model, q)

        c_real, l_real = crit(real)
        c_fake, l_fake = crit(fake)
        x_hat = (real + u * (fake - real)).detach().requires_grad_()
        gx, = torch.autograd.grad(crit(x_hat)[0].sum(), x_hat,
                                  create_graph=True)
        norms = torch.sqrt(torch.sum(gx * gx, dim=(1, 2, 3)) + 1e-12)
        gp = torch.mean((norms - 1.0) ** 2)
        aux = _ce(l_real, labels)
        if t["d_pitch_ce_on_fake"]:
            aux = aux + _ce(l_fake, labels)
        d_loss = (torch.mean(c_fake) - torch.mean(c_real)
                  + t["gp_weight"] * gp
                  + t["drift_weight"] * torch.mean(c_real ** 2)
                  + t["aux_pitch_weight"] * aux)
        grads_d = _grads(d_loss, d)
        opt_d.update(d, grads_d)

        fake = nets.generator(g, z_g, labels, stage, alpha, model, q)
        c_fake, l_fake = crit(fake)
        g_loss = -torch.mean(c_fake) + t["aux_pitch_weight"] * _ce(l_fake,
                                                                   labels)
        grads_g = _grads(g_loss, g)
        opt_g.update(g, grads_g)
        with torch.no_grad():
            decay = t["ema_decay"]
            for k in ema:
                ema[k] = ema[k] * decay + g[k] * (1.0 - decay)
        out["d_loss"].append(d_loss.item())
        out["g_loss"].append(g_loss.item())
        if i == 0:
            out["grads_g"], out["grads_d"] = grads_g, grads_d
        del grads_d, grads_g, gx, c_real, c_fake, l_real, l_fake
    out.update(g={k: v.detach() for k, v in g.items()},
               d={k: v.detach() for k, v in d.items()}, ema=ema)
    return out


def changes(after: Dict[str, torch.Tensor],
            before: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each leaf's change, on the host."""
    return {k: (after[k].float() - before[k].to(after[k].device).float())
            .cpu() for k in after}
