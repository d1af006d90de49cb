"""The WGAN-GP training step (``gansynth_tpu/train/step.py``).

One call is one iteration: the spectral frontend on the raw wave batch,
one critic update (three critic passes, real, fake and interpolates, with
the gradient penalty's second-order gradient), one generator update
against the refreshed critic, and the EMA update. ``stage`` is fixed when
the step is made; ``alpha`` is an argument.

The noise (the critic update's latents ``z_d``, the interpolation weights
``u`` and the generator update's latents ``z_g``) is the reference's
(``step.py:76-77``, ``losses.py:27``): ``split(fold_in(state.rng,
state.step), 3)`` gives one key for each, drawn with threefry on the host
(``synth/random.py``) and copied to the step's device in one transfer. So
the same seed and step give the reference's noise, and a resumed run
replays it. A caller may still pass any of the three explicitly; the
parity tests do.

A superstep (:func:`make_superstep`, :func:`make_cached_superstep`) is K
steps in one call, a Python loop over the step: the reference fuses them
into one ``lax.scan`` program, the port launches them one after another
and never waits for the device inside the loop (the metrics stay on the
device; the caller reads them at its log crossings). The cached form
gathers each step's batch from a dataset held on the device, at indices
drawn on the host from the state's key and step
(:func:`cached_batch_indices`, the reference's stream bit for bit).

``fused_critic`` ("none", "pair", "all") only schedules the reference's
critic passes (vmap stacks them; every pass keeps its own minibatch-stddev
groups), so all three compute the same function. The port runs the three
passes as separate critic calls under each of them.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gansynth_tpu_torch.models.layers import downsample_avg
from gansynth_tpu_torch.ops.harmonic import image_pitch_logits
from gansynth_tpu_torch.ops.spectral import wave_to_image
from gansynth_tpu_torch.synth import random as jrandom
from gansynth_tpu_torch.train import losses
from gansynth_tpu_torch.train.state import TrainState, ema_update
from gansynth_tpu_torch.utils.config import Config


def real_image_for_stage(wave: torch.Tensor, stage: int,
                         config: Config) -> torch.Tensor:
    """Frontend and progressive downsampling: wave [B, T] -> the image at
    the stage's resolution (the full-resolution image average-pooled)."""
    image = wave_to_image(wave, config.audio)
    factor = 1 << (config.model.num_stages - 1 - stage)
    if factor > 1:
        image = downsample_avg(image, factor)
    return image


def pitch_to_onehot(pitch: torch.Tensor, config: Config) -> torch.Tensor:
    """MIDI pitch [B] -> one-hot [B, num_pitches] float32; out-of-range
    pitches clip to the ends."""
    m = config.model
    idx = torch.clamp(pitch.long() - m.pitch_min, 0, m.num_pitches - 1)
    return F.one_hot(idx, m.num_pitches).float()


def step_noise(rng: Tuple[int, int], step: int, batch: int,
               latent_dim: int) -> Dict[str, np.ndarray]:
    """The step's noise as the reference draws it: ``split(fold_in(rng,
    step), 3)`` -> z_d = normal [batch, latent_dim], u = uniform [batch, 1,
    1, 1], z_g = normal [batch, latent_dim], float32 numpy arrays."""
    k_zd, k_interp, k_zg = jrandom.split(jrandom.fold_in(rng, step), 3)
    return {"z_d": jrandom.normal(k_zd, (batch, latent_dim)),
            "u": jrandom.uniform(k_interp, (batch, 1, 1, 1)),
            "z_g": jrandom.normal(k_zg, (batch, latent_dim))}


def host_to_device(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """``array`` on ``device``: pinned and asynchronous on a card, so the
    host does not wait for the stream (a copy from pageable memory
    synchronises it)."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_device(noise: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of all of ``noise``."""
    flat = host_to_device(np.concatenate([v.reshape(-1)
                                          for v in noise.values()]), device)
    out, at = {}, 0
    for k, v in noise.items():
        out[k] = flat[at:at + v.size].reshape(v.shape)
        at += v.size
    return out


def _set_grads(loss: torch.Tensor, params, mesh=None) -> None:
    """``p.grad`` for every parameter; ``None`` where ``loss`` does not
    depend on ``p`` (Adam then updates it as with a zero gradient). With a
    data-parallel ``mesh`` the gradients are the mean over the ranks of
    each rank's, all-reduced in one flat bucket (zeros for ``None``)."""
    params = list(params)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    if mesh is not None:
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        flat = mesh.all_reduce_mean(torch.cat([g.reshape(-1)
                                               for g in grads]))
        grads = [t.view_as(p) for t, p in
                 zip(flat.split([p.numel() for p in params]), params)]
    for p, g in zip(params, grads):
        p.grad = g


def _mean_over_ranks(metrics: Dict[str, torch.Tensor],
                     mesh) -> Dict[str, torch.Tensor]:
    """Every metric's mean over the ranks, in one all-reduce: the ranks'
    local batches are equal, so a mean of local means is the global
    batch's mean."""
    flat = mesh.all_reduce_mean(torch.stack(list(metrics.values())))
    return dict(zip(metrics, flat.unbind()))


StepFn = Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]


def make_train_step(config: Config, stage: int, mesh=None) -> StepFn:
    """The step function for ``stage``:
    ``step(state, wave [B, T], pitch [B], alpha, z_d=None, u=None,
    z_g=None) -> (state, metrics)``. Noise not passed is drawn from the
    state's key and step (:func:`step_noise`). The state is updated in
    place; the metrics are 0-d float32 tensors.

    With a data-parallel ``mesh`` (``parallel.sharding``), ``wave`` and
    ``pitch`` are this rank's rows of the global batch; the noise (drawn,
    or passed for the global batch) is taken at the same rows; the
    minibatch-stddev statistic, the gradients and the metrics are the
    global batch's, so every rank holds the same state after the step."""
    m, t = config.model, config.train
    if t.fused_critic not in ("none", "pair", "all"):
        raise ValueError(f"unknown fused_critic {t.fused_critic!r}")
    use_pc = (t.pitch_consistency_weight > 0.0
              and stage >= t.pitch_consistency_min_stage)

    def critic_update(state, real, labels, z_d, u, alpha):
        def critic_fn(x):
            return state.d(x, stage, alpha, mesh)

        with torch.no_grad():   # no gradient to G (step.py:89)
            fake = state.g(z_d, labels, stage, alpha)
        c_real, logits_real = critic_fn(real)
        c_fake, logits_fake = critic_fn(fake)
        gp = losses.gradient_penalty(critic_fn, real, fake, u)
        wgan = losses.wgan_critic_loss(c_real, c_fake)
        drift = losses.drift_penalty(c_real)
        ce = losses.pitch_cross_entropy(logits_real, labels)
        ce_fake = losses.pitch_cross_entropy(logits_fake, labels)
        aux = ce + ce_fake if t.d_pitch_ce_on_fake else ce
        d_loss = wgan + t.gp_weight * gp + t.drift_weight * drift \
            + t.aux_pitch_weight * aux
        _set_grads(d_loss, state.d.parameters(), mesh)
        state.d_opt.step()
        return {
            "d_loss": d_loss, "wgan": wgan, "gradient_penalty": gp,
            "drift": drift, "d_pitch_ce": ce, "d_pitch_ce_fake": ce_fake,
            "critic_real": torch.mean(c_real),
            "critic_fake": torch.mean(c_fake),
        }

    def generator_update(state, labels, z_g, alpha):
        fake = state.g(z_g, labels, stage, alpha)
        c_fake, logits_fake = state.d(fake, stage, alpha, mesh)
        adv = losses.generator_adversarial_loss(c_fake)
        ce = losses.pitch_cross_entropy(logits_fake, labels)
        g_loss = adv + t.aux_pitch_weight * ce
        out = {"g_adv": adv, "g_pitch_ce": ce}
        if use_pc:
            pc = losses.pitch_cross_entropy(
                image_pitch_logits(fake, stage, config,
                                   t.pitch_consistency_tau), labels)
            g_loss = g_loss + t.pitch_consistency_weight * pc
            out["g_pitch_consistency"] = pc
        out["g_loss"] = g_loss
        _set_grads(g_loss, state.g.parameters(), mesh)
        state.g_opt.step()
        return out

    def step_fn(state: TrainState, wave: torch.Tensor, pitch: torch.Tensor,
                alpha=1.0, z_d: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                z_g: Optional[torch.Tensor] = None):
        device = wave.device
        batch = wave.shape[0] * (1 if mesh is None else mesh.world)
        rows = slice(None) if mesh is None else mesh.rows(batch)
        given = {k: None if v is None else v[rows]
                 for k, v in (("z_d", z_d), ("u", u), ("z_g", z_g))}
        if any(v is None for v in given.values()):
            drawn = step_noise(state.rng, state.step, batch, m.latent_dim)
            given.update(_to_device({k: drawn[k][rows]
                                     for k, v in given.items() if v is None},
                                    device))
        z_d, u, z_g = given["z_d"], given["u"], given["z_g"]
        labels = pitch_to_onehot(pitch.to(device), config)
        with torch.no_grad(), record_function("spectral_frontend"):
            real = real_image_for_stage(wave.float(), stage, config)

        # ----- critic update -----
        with record_function("discriminator_update"):
            metrics = critic_update(state, real, labels, z_d, u, alpha)

        # ----- generator update (fresh latents, refreshed critic) -----
        with record_function("generator_update"):
            metrics.update(generator_update(state, labels, z_g, alpha))
        with record_function("ema_update"):
            ema_update(state.ema, state.g, t.ema_decay)
        state.step += 1
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if mesh is not None:
            metrics = _mean_over_ranks(metrics, mesh)
        metrics["alpha"] = torch.tensor(float(alpha))
        return state, metrics

    return step_fn


def _mean_metrics(metrics, alpha) -> Dict[str, torch.Tensor]:
    """The inner steps' metrics averaged on the device (the reference's
    ``jnp.mean`` over the scan axis), and the last alpha."""
    out = {k: torch.stack([m[k] for m in metrics]).mean(0)
           for k in metrics[0] if k != "alpha"}
    out["alpha"] = torch.tensor(float(alpha))
    return out


def make_superstep(config: Config, stage: int, mesh=None) -> StepFn:
    """K steps in one call: ``superstep(state, waves [K, B, T], pitches
    [K, B], alphas [K]) -> (state, metrics)``, the metrics averaged over
    the K steps, plus the last alpha. Each step draws its noise from
    ``(state.rng, state.step)``, so a run chunked into supersteps equals
    the same steps taken one at a time. With a ``mesh``, B is this rank's
    rows (:func:`make_train_step`)."""
    step_fn = make_train_step(config, stage, mesh)

    def superstep(state, waves, pitches, alphas):
        metrics = []
        for wave, pitch, alpha in zip(waves, pitches, alphas):
            state, m = step_fn(state, wave, pitch, float(alpha))
            metrics.append(m)
        return state, _mean_metrics(metrics, alphas[-1])

    return superstep


@functools.lru_cache(maxsize=4)
def _epoch_permutation(rng: Tuple[int, int], epoch: int,
                       num_examples: int) -> np.ndarray:
    """The shuffle law's permutation of epoch ``epoch`` (read-only; a few
    epochs are kept, so a step does not redraw its 2 x N sort keys)."""
    key = jrandom.fold_in(jrandom.fold_in(rng, 0x5E0F), epoch)
    perm = jrandom.permutation(key, num_examples)
    perm.setflags(write=False)
    return perm


def cached_batch_indices(rng: Tuple[int, int], step: int, batch: int,
                         num_examples: int,
                         law: str = "shuffle") -> np.ndarray:
    """Example indices (int32 ``[batch]``) of the cached stream's batch at
    global ``step``: a function of ``(rng, step)`` alone, so the stream is
    stateless and a resumed run reads the batches of an unbroken one.

    ``"shuffle"``: the concatenation of per-epoch permutations of [0, N)
    (epoch ``e``'s keyed by ``fold_in(fold_in(rng, 0x5E0F), e)``), read at
    example offset ``step * batch``; a batch across an epoch boundary
    takes the tail of one permutation and the head of the next (needs
    ``batch <= N``). ``"replacement"``: uniform draws keyed by
    ``fold_in(fold_in(rng, step), 0x5A17)``.
    """
    if law == "replacement":
        key = jrandom.fold_in(jrandom.fold_in(rng, step), 0x5A17)
        return jrandom.randint(key, (batch,), 0, num_examples)
    pos = step * batch + np.arange(batch)
    epoch, rank = pos // num_examples, pos % num_examples
    e0 = step * batch // num_examples
    return np.where(epoch == e0,
                    _epoch_permutation(rng, e0, num_examples)[rank],
                    _epoch_permutation(rng, e0 + 1, num_examples)[rank])


def _gather_from_owners(mesh, all_waves: torch.Tensor,
                        all_pitches: torch.Tensor, idx: np.ndarray,
                        num_examples: int):
    """This rank's rows of the batch at global example indices ``idx``
    from a cache sharded over the ranks (rank r holds examples ``[r N/W,
    (r+1) N/W)``): each rank writes the rows it owns into a zero batch,
    and one all-reduce of the bits (each element has one owner, so the
    sum is exact) gives every rank the batch; O(B T) a step."""
    per = num_examples // mesh.world
    owner, local = idx // per, idx % per
    mine = torch.from_numpy(np.flatnonzero(owner == mesh.rank)).to(
        all_waves.device)
    take = torch.from_numpy(local[owner == mesh.rank].astype(np.int64)).to(
        all_waves.device)
    waves = all_waves.new_zeros((len(idx), all_waves.shape[1]))
    pitches = all_pitches.new_zeros(len(idx))
    waves.index_copy_(0, mine, all_waves.index_select(0, take))
    pitches.index_copy_(0, mine, all_pitches.index_select(0, take))
    bits = torch.cat([waves.view(torch.int32).reshape(-1),
                      pitches.to(torch.int32)])
    mesh.all_reduce_sum(bits)
    rows = mesh.rows(len(idx))
    waves = bits[:waves.numel()].view(torch.float32).view_as(waves)
    return waves[rows], bits[waves.numel():][rows].to(all_pitches.dtype)


def make_cached_superstep(config: Config, stage: int, num_examples: int,
                          mesh=None) -> StepFn:
    """K steps over a dataset held on the device: ``superstep(state,
    all_waves [N, T], all_pitches [N], alphas [K]) -> (state, metrics)``.
    Each step gathers its batch at :func:`cached_batch_indices` of the
    state's key and step under ``config.train.cached_stream``, with the
    stage's batch (``stage_batch_sizes``); only the indices cross to the
    device.

    With a ``mesh``, every rank draws the global batch's indices and
    takes its rows: from its full copy of the dataset under
    ``device_cache_layout="replicate"``, or from their owners under
    ``"shard"`` (``all_waves`` is then this rank's N/W examples;
    ``num_examples`` stays N)."""
    step_fn = make_train_step(config, stage, mesh)
    batch = config.train.batch_for_stage(stage)
    sharded = mesh is not None and config.train.device_cache_layout == "shard"
    if mesh is not None:
        mesh.rows(batch)   # the global batch must divide the world size
    if sharded and num_examples % mesh.world:
        raise ValueError(
            f"device_cache_layout='shard' needs the dataset size "
            f"({num_examples}) divisible by the world size ({mesh.world}); "
            "pad/trim the cache or use 'replicate'")
    law = config.train.cached_stream
    if law not in ("shuffle", "replacement"):
        raise ValueError(f"unknown cached_stream {law!r}")
    if law == "shuffle" and batch > num_examples:
        raise ValueError(
            f"cached_stream='shuffle' needs batch ({batch}) <= dataset "
            f"size ({num_examples}); use 'replacement' or a smaller batch")

    def superstep(state, all_waves, all_pitches, alphas):
        metrics = []
        for alpha in alphas:
            idx = cached_batch_indices(state.rng, state.step, batch,
                                       num_examples, law)
            if sharded:
                wave, pitch = _gather_from_owners(mesh, all_waves,
                                                  all_pitches, idx,
                                                  num_examples)
            else:
                if mesh is not None:
                    idx = idx[mesh.rows(batch)]
                idx = host_to_device(idx.astype(np.int64), all_waves.device)
                wave = all_waves.index_select(0, idx)
                pitch = all_pitches.index_select(0, idx)
            state, m = step_fn(state, wave, pitch, float(alpha))
            metrics.append(m)
        return state, _mean_metrics(metrics, alphas[-1])

    return superstep
