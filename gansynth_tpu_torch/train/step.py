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
steps in one call, the reference's ``lax.scan`` over the step
(``unroll``). The cached form gathers each step's batch from a dataset
held on the device, at indices drawn on the host from the state's key and
step (:func:`cached_batch_indices`, the reference's stream bit for bit).

**The step as a CUDA graph holds it.** Every value that changes from step
to step reaches the step as a tensor at a fixed address. Before the K
steps the host packs one row per step (:func:`_stage_rows`): the noise,
the alpha, both Adams' bias corrections (from their host counts,
``Adam.bias_corrections``) and, for the cached stream, the batch's
example indices; one pinned copy puts the K rows on the device
(:class:`_Rows`). The step reads row ``pos``, a position the device keeps
and the step advances, and writes its metrics to row ``pos`` of a static
buffer; after the K steps they are averaged on the device (the
reference's ``jnp.mean`` over the scan axis). On a card each factory's
step is captured once into a CUDA graph (``utils/graphs.py``) for the
state it was given (a graph holds the parameters' addresses) and replayed
K times with no host work between the replays. The CPU and
``graphs=False`` run the same code eagerly, step by step. ``state.step``
and the Adams' counts stay host integers and advance by K once the K
steps are enqueued; the host never waits for the device (the caller
reads the metrics at its log crossings).

Each program keeps where its steps spend their time (:class:`StepPhases`,
``program.phases``): five marks a step, kernels that the graph replays
with the step, add the device's time to the frontend, the critic update,
the generator update, the EMA and the gap between steps; the host's
staging runs under the span ``superstep.stage``.

A data-parallel ``mesh`` is captured too, its collectives (the gradient
buckets, the metrics' mean, the critic's all-gather and its backward, the
sharded cache's gather) inside the graph, in the ``"thread_local"``
capture mode. The warm-up before a capture is a real step, which runs
those collectives, so the ranks capture together: each says whether its
graph is missing or stale, and all capture when one does
(``Mesh.any``, on the host); after the capture they check together that
every rank's succeeded, so a failure on one rank raises on all of them.
The sharded cache's rows come from their owners at a fixed shape
(:func:`_gather_from_owners`), from the global batch's indices staged in
each step's row.

WaveGAN (``model.architecture = "wavegan"``, ``models/wavegan.py``) runs
through the same program from the device cache only
(:func:`make_cached_superstep`): a step is ``train.critic_updates`` critic
updates, each on its own batch (the stream's at position ``step * n +
j``), latents, interpolation weights and phase-shuffle shifts, then the
generator update on the last batch's labels, all in the one graph. Its
row (:class:`_Rows`, :class:`WaveGANRow`) carries n of each, the shifts
as integers, and n bias corrections of the critic's Adam, whose count
advances n a step. The noise is ``models.wavegan.wavegan_noise``'s.

``fused_critic`` ("none", "pair", "all") only schedules the reference's
critic passes (vmap stacks them; every pass keeps its own minibatch-stddev
groups), so all three compute the same function. The port runs the three
passes as separate critic calls under each of them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gansynth_tpu_torch.kernels import marks
from gansynth_tpu_torch.models.layers import downsample_avg
from gansynth_tpu_torch.models.wavegan import (
    SHUFFLED,
    SLICE_LEN,
    wavegan_noise,
)
from gansynth_tpu_torch.ops.harmonic import image_pitch_logits
from gansynth_tpu_torch.ops.spectral import wave_to_image
from gansynth_tpu_torch.synth import random as jrandom
from gansynth_tpu_torch.train import losses
from gansynth_tpu_torch.train.state import TrainState, ema_update
from gansynth_tpu_torch.utils import graphs as cuda_graphs
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


def _host(array) -> np.ndarray:
    """A float32 numpy copy of ``array`` (numpy, or a tensor anywhere)."""
    if torch.is_tensor(array):
        array = array.detach().cpu().numpy()
    return np.asarray(array, np.float32)


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

_D_METRICS = ("d_loss", "wgan", "gradient_penalty", "drift", "d_pitch_ce",
              "d_pitch_ce_fake", "critic_real", "critic_fake")


def _make_core(config: Config, stage: int, mesh):
    """``(core, metric names)``: ``core(state, row, fetch, mark) ->
    metrics``, one step's device work on tensors, updating the state's
    tensors in place. ``row`` is what :meth:`_Rows.read` gives (the noise,
    alpha, each Adam's bias corrections, the batch's indices and, for
    WaveGAN, the phase-shuffle shifts); ``fetch(idx)`` gives a batch's
    ``(wave, pitch)``; ``mark(name)`` is called at the frontend's end,
    after each critic update and at the generator update's end
    (:class:`StepPhases`).

    GANSynth: the mel-IF frontend, one critic update and the generator
    update. WaveGAN (``model.architecture``): the frontend pads each of
    ``train.critic_updates`` batches to ``SLICE_LEN`` samples, a critic
    update on each (its metrics averaged over them), then the generator
    update with the last batch's labels."""
    m, t = config.model, config.train
    if t.fused_critic not in ("none", "pair", "all"):
        raise ValueError(f"unknown fused_critic {t.fused_critic!r}")
    wavegan = is_wavegan(config)
    n = critic_updates(config)
    use_pc = (t.pitch_consistency_weight > 0.0
              and stage >= t.pitch_consistency_min_stage)
    if use_pc and wavegan:
        raise ValueError("the pitch-consistency loss reads a spectral "
                         "image; WaveGAN has none")

    def critic_call(state, x, alpha, shifts):
        if wavegan:
            return state.d(x, shifts)
        return state.d(x, stage, alpha, mesh)

    def critic_update(state, real, labels, z_d, u, alpha, bc, shifts=None):
        def critic_fn(x, call):
            return critic_call(state, x, alpha,
                               None if shifts is None else shifts[call])

        with torch.no_grad():   # no gradient to G (step.py:89)
            fake = state.g(z_d, labels, stage, alpha)
        c_real, logits_real = critic_fn(real, 0)
        c_fake, logits_fake = critic_fn(fake, 1)
        gp = losses.gradient_penalty(lambda x: critic_fn(x, 2), real, fake,
                                     u)
        wgan = losses.wgan_critic_loss(c_real, c_fake)
        drift = losses.drift_penalty(c_real)
        ce = losses.pitch_cross_entropy(logits_real, labels)
        ce_fake = losses.pitch_cross_entropy(logits_fake, labels)
        aux = ce + ce_fake if t.d_pitch_ce_on_fake else ce
        d_loss = wgan + t.gp_weight * gp + t.drift_weight * drift \
            + t.aux_pitch_weight * aux
        _set_grads(d_loss, state.d.parameters(), mesh)
        state.d_opt.update(*bc)
        return dict(zip(_D_METRICS, (
            d_loss, wgan, gp, drift, ce, ce_fake, torch.mean(c_real),
            torch.mean(c_fake))))

    def generator_update(state, labels, z_g, alpha, bc, shifts=None):
        fake = state.g(z_g, labels, stage, alpha)
        c_fake, logits_fake = critic_call(state, fake, alpha, shifts)
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
        state.g_opt.update(*bc)
        return out

    def finish(state, metrics):
        ema_update(state.ema, state.g, t.ema_decay)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if mesh is not None:
            metrics = _mean_over_ranks(metrics, mesh)
        return metrics

    def core(state, row, fetch, mark):
        z_d, u, z_g, alpha, bc_d, bc_g, idx = row
        wave, pitch = fetch(idx)
        labels = pitch_to_onehot(pitch, config)
        with torch.no_grad():
            real = real_image_for_stage(wave.float(), stage, config)
        mark("frontend")

        # ----- critic update -----
        metrics = critic_update(state, real, labels, z_d, u, alpha, bc_d)
        mark("critic")

        # ----- generator update (fresh latents, refreshed critic) -----
        metrics.update(generator_update(state, labels, z_g, alpha, bc_g))
        mark("generator")
        return finish(state, metrics)

    def wavegan_core(state, row, fetch, mark):
        batches = [fetch(row.idx[j]) for j in range(n)]
        labels = [pitch_to_onehot(p, config) for _, p in batches]
        with torch.no_grad():
            reals = [F.pad(w.float(), (0, SLICE_LEN - w.shape[-1]))
                     for w, _ in batches]
        mark("frontend")
        updates = []
        for j in range(n):
            updates.append(critic_update(
                state, reals[j], labels[j], row.z_d[j], row.u[j][:, None],
                row.alpha, row.bc_d[j], row.shifts_d[j]))
            mark("critic")
        metrics = {k: torch.stack([r[k] for r in updates]).mean()
                   for k in updates[0]}
        metrics.update(generator_update(state, labels[-1], row.z_g, row.alpha,
                                        row.bc_g, row.shifts_g))
        mark("generator")
        return finish(state, metrics)

    names = (*_D_METRICS, "g_adv", "g_pitch_ce",
             *(("g_pitch_consistency",) if use_pc else ()), "g_loss")
    return (wavegan_core if wavegan else core), names


def is_wavegan(config: Config) -> bool:
    arch = config.model.architecture
    if arch not in ("gansynth", "wavegan"):
        raise ValueError(f"unknown model.architecture {arch!r}")
    return arch == "wavegan"


def critic_updates(config: Config) -> int:
    """``train.critic_updates``, checked: GANSynth's step has one."""
    n = int(config.train.critic_updates)
    if n < 1 or (n > 1 and not is_wavegan(config)):
        raise ValueError(f"critic_updates {n}: GANSynth's step makes one "
                         "critic update, WaveGAN's one or more")
    return n


def _stage_rows(state: TrainState, alphas, batch: int, latent_dim: int,
                mesh=None, given=None, indices=None) -> np.ndarray:
    """The next ``len(alphas)`` steps' rows (int32 ``[k, width]``, see
    :class:`_Rows`): step i's noise drawn from ``(state.rng, state.step +
    i)`` for the global ``batch`` (or taken from ``given``) at this rank's
    rows, its alpha, both Adams' bias corrections at their counts + i + 1,
    and ``indices[i]``."""
    rows = slice(None) if mesh is None else mesh.rows(batch)
    out = []
    for i, alpha in enumerate(alphas):
        noise = {k: _host(v) for k, v in (given or {}).items()}
        if len(noise) < 3:
            drawn = step_noise(state.rng, state.step + i, batch, latent_dim)
            noise = {**drawn, **noise}
        scalars = np.array(
            [alpha, *state.d_opt.bias_corrections(state.d_opt.count + i + 1),
             *state.g_opt.bias_corrections(state.g_opt.count + i + 1)],
            np.float32)
        floats = np.concatenate([noise[k][rows].reshape(-1)
                                 for k in ("z_d", "u", "z_g")] + [scalars])
        parts = [floats.astype(np.float32).view(np.int32)]
        if indices is not None:
            parts.append(np.asarray(indices[i], np.int32))
        out.append(np.concatenate(parts))
    return np.stack(out)


def _stage_wavegan_rows(state: TrainState, alphas, config: Config,
                        indices) -> np.ndarray:
    """WaveGAN's rows (:class:`_Rows` with ``updates`` n and shifts): step
    i's noise (``models.wavegan.wavegan_noise``), its alpha, the critic's
    bias corrections at its count + i n + j + 1 for update j and the
    generator's at its count + i + 1, the shifts and ``indices[i]`` ([n,
    batch])."""
    m, n = config.model, critic_updates(config)
    batch = config.train.batch_for_stage(0)
    d, g = state.d_opt, state.g_opt
    out = []
    for i, alpha in enumerate(alphas):
        noise = wavegan_noise(state.rng, state.step + i, batch, m.latent_dim,
                              n)
        scalars = [alpha] + [c for j in range(n) for c in
                             d.bias_corrections(d.count + i * n + j + 1)]
        scalars += g.bias_corrections(g.count + i + 1)
        floats = np.concatenate([noise["z_d"].reshape(-1),
                                 noise["u"].reshape(-1),
                                 noise["z_g"].reshape(-1),
                                 np.array(scalars, np.float32)])
        out.append(np.concatenate([
            floats.astype(np.float32).view(np.int32),
            noise["shifts_d"].reshape(-1), noise["shifts_g"],
            np.asarray(indices[i], np.int32).reshape(-1)]))
    return np.stack(out)


def _copy_in(dst: torch.Tensor, array: np.ndarray) -> None:
    """``dst[:len(array)] = array`` in one copy, from pinned memory to a
    card (the host does not wait; the copy keeps its source alive)."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst[:len(array)].copy_(src, non_blocking=True)


class WaveGANRow(NamedTuple):
    """One WaveGAN step's row on the device (``n`` critic updates)."""

    z_d: torch.Tensor        # [n, B, D]
    u: torch.Tensor          # [n, B]
    z_g: torch.Tensor        # [B, D]
    alpha: torch.Tensor
    bc_d: list               # n pairs of 0-d tensors
    bc_g: tuple
    shifts_d: torch.Tensor   # int64 [n, 3, 4]
    shifts_g: torch.Tensor   # int64 [4]
    idx: Optional[torch.Tensor]   # int64 [n, indices]


class _Rows:
    """The per-step values of up to ``kmax`` steps, on ``device``. Row k
    holds step k's z_d [n, b, D], u [n, b], z_g [b, D], alpha, the critic's
    bias corrections for each of its ``updates`` n and the generator's as
    float32 bits, then ``shifts`` phase-shuffle shifts (WaveGAN's, [n, 3,
    4] and [4]; none for GANSynth) and n times ``indices`` example indices
    (int32): this rank's batch's, or the global batch's for a sharded
    cache. :attr:`pos`, on the device, is the row the next step reads;
    each step writes its metrics to row ``pos`` of :attr:`metrics` and
    advances it."""

    def __init__(self, device, batch: int, latent_dim: int, kmax: int,
                 n_metrics: int, indices: int, updates: int = 1,
                 shifts: int = 0):
        self.batch, self.latent_dim = batch, latent_dim
        self.updates, self.shifts, self.indices = updates, shifts, indices
        self.floats = ((updates + 1) * batch * latent_dim + updates * batch
                       + 1 + 2 * updates + 2)
        self.width = self.floats + shifts + updates * indices
        self.rows = torch.zeros((kmax, self.width), dtype=torch.int32,
                                device=device)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
        self.metrics = torch.zeros((kmax, n_metrics), dtype=torch.float32,
                                   device=device)

    def load(self, rows: np.ndarray) -> None:
        _copy_in(self.rows, rows)
        self.pos.zero_()

    def read(self):
        """Row ``pos``: GANSynth's ``(z_d, u, z_g, alpha, bc_d, bc_g,
        idx)`` (u [b, 1, 1, 1]), or a :class:`WaveGANRow`."""
        row = self.rows.index_select(0, self.pos)[0]
        f = row.view(torch.float32)
        n, b, d = self.updates, self.batch, self.latent_dim
        nd = n * b * d
        z_d, u = f[:nd].view(n, b, d), f[nd:nd + n * b].view(n, b)
        o = nd + n * b
        z_g, s = f[o:o + b * d].view(b, d), f[o + b * d:self.floats]
        bc_d = [(s[1 + 2 * j], s[2 + 2 * j]) for j in range(n)]
        bc_g = (s[1 + 2 * n], s[2 + 2 * n])
        idx = row[self.floats + self.shifts:]
        idx = idx.long().view(n, self.indices) if self.indices else None
        if not self.shifts:
            return (z_d[0], u[0].view(b, 1, 1, 1), z_g, s[0], bc_d[0], bc_g,
                    None if idx is None else idx[0])
        ints = row[self.floats:self.floats + self.shifts].long()
        k = self.shifts - SHUFFLED
        return WaveGANRow(z_d, u, z_g, s[0], bc_d, bc_g,
                          ints[:k].view(n, -1, SHUFFLED), ints[k:], idx)

    def write(self, metrics: torch.Tensor) -> None:
        self.metrics.index_copy_(0, self.pos, metrics[None])
        self.pos.add_(1)

    def mean(self, k: int, names) -> Dict[str, torch.Tensor]:
        """Each metric averaged over the first k rows (the reference's
        ``jnp.mean`` over the scan axis)."""
        cols = self.metrics[:k].t().contiguous()
        return {name: cols[j].mean(0) for j, name in enumerate(names)}


class StepPhases:
    """Where a program's steps spend their time, kept by the program.

    Device: marks a step (``kernels/marks.py``: ``start`` before the
    row is read, ``frontend`` after the real batches, ``critic`` after
    each critic update with its Adam, ``generator`` after the generator
    update with its Adam, ``end`` after the row is written) add the time
    between them to the phases ``frontend``, ``critic`` (all of a step's
    critic updates), ``generator``, ``ema`` (EMA, the metrics, their mean
    over the ranks, the row write) and ``between`` (the previous step's
    end to this one's start: between replays and between supersteps; not
    counted at a program's first mark), and count the steps and the
    critic updates. The totals stay on the step's device, and the graph
    replays the marks with the step.

    Host: :meth:`staging` is the span ``superstep.stage`` (a profiler
    range) around the host's staging of a call's rows, and adds its ns to
    ``host_stage_ns``.

    :meth:`read` copies the totals to the host (one copy, which waits for
    the device); the caller chooses when. With a mesh each rank keeps its
    own."""

    def __init__(self):
        self.totals: Optional[torch.Tensor] = None
        self.host_stage_ns = 0

    def place(self, device: torch.device) -> None:
        """Zeroed totals on ``device`` unless they are there already."""
        if self.totals is None or self.totals.device != device:
            self.totals = marks.new_totals(device)

    def mark(self, name: str) -> None:
        marks.step_mark(self.totals, marks.MARKS.index(name))

    def anchor(self) -> None:
        """Enqueue the anchor: the next ``start`` adds to ``between`` only
        the time from here. A reader that copies the totals and then does
        other work calls it before the steps it times. Nothing before the
        first step."""
        if self.totals is not None:
            marks.step_mark(self.totals, marks.ANCHOR)

    @contextlib.contextmanager
    def staging(self):
        t0 = time.perf_counter_ns()
        try:
            with record_function("superstep.stage"):
                yield
        finally:
            self.host_stage_ns += time.perf_counter_ns() - t0

    def read(self) -> Dict[str, int]:
        """``{"steps": n, "critic_updates": m, "<phase>_ns": ...,
        "host_stage_ns": ...}``, each a total since the program was
        made."""
        t = ([0] * marks.SLOTS if self.totals is None
             else self.totals.tolist())
        return {"steps": t[marks.STEPS], "critic_updates": t[marks.CRITICS],
                **{f"{p}_ns": t[i] for i, p in enumerate(marks.PHASES)},
                "host_stage_ns": self.host_stage_ns}


def _state_tensors(state: TrainState):
    """Every tensor a step updates: the three networks' parameters and
    both Adams' moments."""
    out = [*state.g.parameters(), *state.d.parameters(),
           *state.ema.parameters()]
    for opt in (state.d_opt, state.g_opt):
        for group in opt.param_groups:
            out += [opt.state[p][k] for p in group["params"]
                    for k in ("mu", "nu")]
    return out


class _StepProgram:
    """One factory's step: :func:`_make_core` fed from :class:`_Rows`. On a
    card (with ``graphs``) it is captured once into a CUDA graph per set of
    addresses (the state's tensors, the rows and the static inputs) and
    replayed once a step; otherwise it runs eagerly, the same code."""

    def __init__(self, config: Config, stage: int, mesh, graphs: bool):
        self.core, self.names = _make_core(config, stage, mesh)
        self.latent_dim = config.model.latent_dim
        self.updates = critic_updates(config)
        self.shifts = ((3 * self.updates + 1) * SHUFFLED
                       if is_wavegan(config) else 0)
        if self.shifts and mesh is not None:
            raise ValueError("WaveGAN trains on one device (no mesh)")
        self.mesh = mesh
        self.graphs = graphs
        self.rows: Optional[_Rows] = None
        self.static: Dict[str, torch.Tensor] = {}
        self.graph: Optional[cuda_graphs.Graph] = None
        self.addresses = None
        self.phases = StepPhases()

    def buffer(self, name: str, shape, dtype, device) -> torch.Tensor:
        """A static input buffer, made anew (and the graph dropped) when
        its shape, type or device changes."""
        buf = self.static.get(name)
        if (buf is None or tuple(buf.shape) != tuple(shape)
                or buf.dtype != dtype or buf.device != device):
            buf = self.static[name] = torch.zeros(shape, dtype=dtype,
                                                  device=device)
            self.graph = None
        return buf

    def _body(self, state, fetch) -> None:
        mark = self.phases.mark
        mark("start")
        row = self.rows.read()
        metrics = self.core(state, row, lambda idx: fetch(idx, self.rows.pos),
                            mark)
        self.rows.write(torch.stack([metrics[k] for k in self.names]))
        mark("end")

    def _capture(self, state, fetch, device) -> cuda_graphs.Graph:
        # The warm-up is a real step: undo it (its phase marks too) before
        # the capture.
        tensors = _state_tensors(state) + [self.phases.totals]
        saved = [t.detach().clone() for t in tensors]

        def restore():
            with torch.no_grad():
                for t, s in zip(tensors, saved):
                    t.copy_(s)
            self.rows.pos.zero_()

        try:
            graph = cuda_graphs.Graph(
                lambda: self._body(state, fetch), device,
                before_capture=restore,
                mode="global" if self.mesh is None else "thread_local")
        except Exception:
            if self.mesh is not None:
                self.mesh.any(True)   # the other ranks raise too
            raise
        if self.mesh is not None and self.mesh.any(False):
            raise RuntimeError("the step's CUDA graph capture failed on "
                               "another rank")
        return graph

    def run(self, state, stage: Callable[[], np.ndarray], fetch, device,
            kmax: int, batch: int, indices: int,
            static=()) -> Dict[str, torch.Tensor]:
        """Enqueue the steps whose rows ``stage()`` gives (:func:`_stage_rows`,
        run inside :meth:`StepPhases.staging` with the rows' copy to the
        device) on ``state``; ``fetch(idx, pos)`` gives a step's ``(wave,
        pitch)`` from its row's ``indices`` device indices or from its
        position. Advances the host's step and Adam counts; returns the
        steps' mean metrics."""
        with self.phases.staging():
            rows = stage()
            k = len(rows)
            r = self.rows
            if (r is None or r.rows.shape[0] < k or r.batch != batch
                    or r.rows.device != device or r.indices != indices):
                r = self.rows = _Rows(device, batch, self.latent_dim,
                                      max(k, kmax), len(self.names), indices,
                                      self.updates, self.shifts)
                self.graph = None
            if rows.shape[1] != r.width:
                raise ValueError(f"staged rows of {rows.shape[1]} words, "
                                 f"the step reads {r.width}")
            r.load(rows)
        self.phases.place(r.rows.device)
        if self.graphs and cuda_graphs.available(device):
            for opt in (state.d_opt, state.g_opt):
                opt.init_moments()
            key = tuple(t.data_ptr() for t in
                        (*_state_tensors(state), *static,
                         *self.static.values()))
            stale = self.graph is None or key != self.addresses
            if self.mesh is not None:   # the warm-up runs collectives
                stale = self.mesh.any(stale)
            if stale:
                self.graph = None   # frees its pool before the next capture
                self.graph = self._capture(state, fetch, device)
                self.addresses = key
            for _ in range(k):
                self.graph.replay()
        else:
            for _ in range(k):
                self._body(state, fetch)
        state.step += k
        state.d_opt.count += k * self.updates
        state.g_opt.count += k
        return r.mean(k, self.names)


def _streamed(prog: _StepProgram, waves: torch.Tensor, pitches: torch.Tensor,
              kmax: int):
    """Static buffers [kmax, ...] holding ``waves`` [k, B, T] and
    ``pitches`` [k, B] at rows 0..k-1, and the fetch of row ``pos``."""
    device = waves.device
    wb = prog.buffer("waves", (kmax, *waves.shape[1:]), torch.float32,
                     device)
    pb = prog.buffer("pitches", (kmax, *pitches.shape[1:]), torch.int64,
                     device)
    wb[:len(waves)].copy_(waves)
    pb[:len(pitches)].copy_(pitches)
    return lambda idx, pos: (wb.index_select(0, pos)[0],
                             pb.index_select(0, pos)[0])


def make_train_step(config: Config, stage: int, mesh=None,
                    graphs: bool = True) -> StepFn:
    """The step function for ``stage``:
    ``step(state, wave [B, T], pitch [B], alpha, z_d=None, u=None,
    z_g=None) -> (state, metrics)``. Noise not passed is drawn from the
    state's key and step (:func:`step_noise`). The state is updated in
    place; the metrics are 0-d float32 tensors. On a card the step
    replays its CUDA graph (see the module's docstring).

    With a data-parallel ``mesh`` (``parallel.sharding``), ``wave`` and
    ``pitch`` are this rank's rows of the global batch; the noise (drawn,
    or passed for the global batch) is taken at the same rows; the
    minibatch-stddev statistic, the gradients and the metrics are the
    global batch's, so every rank holds the same state after the step."""
    _spectral_only(config)
    prog = _StepProgram(config, stage, mesh, graphs)

    def step_fn(state: TrainState, wave: torch.Tensor, pitch: torch.Tensor,
                alpha=1.0, z_d: Optional[torch.Tensor] = None,
                u: Optional[torch.Tensor] = None,
                z_g: Optional[torch.Tensor] = None):
        batch = wave.shape[0] * (1 if mesh is None else mesh.world)
        given = {k: v for k, v in (("z_d", z_d), ("u", u), ("z_g", z_g))
                 if v is not None}
        fetch = _streamed(prog, wave[None], torch.as_tensor(pitch)[None], 1)
        metrics = prog.run(
            state, lambda: _stage_rows(state, [float(alpha)], batch,
                                       config.model.latent_dim, mesh, given),
            fetch, wave.device, 1, wave.shape[0], 0)
        metrics["alpha"] = torch.tensor(float(alpha))
        return state, metrics

    step_fn.program = prog
    return step_fn


def make_superstep(config: Config, stage: int, mesh=None,
                   graphs: bool = True) -> StepFn:
    """K steps in one call: ``superstep(state, waves [K, B, T], pitches
    [K, B], alphas [K]) -> (state, metrics)``, the metrics averaged over
    the K steps, plus the last alpha. Each step draws its noise from
    ``(state.rng, state.step)``, so a run chunked into supersteps equals
    the same steps taken one at a time. On a card the K steps are K
    replays of one CUDA graph. With a ``mesh``, B is this rank's rows
    (:func:`make_train_step`)."""
    _spectral_only(config)
    prog = _StepProgram(config, stage, mesh, graphs)
    kmax = max(1, int(config.train.unroll))

    def superstep(state, waves, pitches, alphas):
        alphas = [float(a) for a in alphas]
        local = waves.shape[1]
        batch = local * (1 if mesh is None else mesh.world)
        size = max(kmax, len(alphas))
        fetch = _streamed(prog, waves, torch.as_tensor(pitches), size)
        metrics = prog.run(
            state, lambda: _stage_rows(state, alphas, batch,
                                       config.model.latent_dim, mesh),
            fetch, waves.device, size, local, 0)
        metrics["alpha"] = torch.tensor(alphas[-1])
        return state, metrics

    superstep.program = prog
    return superstep


def _spectral_only(config: Config) -> None:
    if is_wavegan(config):
        raise ValueError("WaveGAN's step reads several batches a step from "
                         "the device cache: make_cached_superstep "
                         "(cli train --device-cache)")


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
                        all_pitches: torch.Tensor, idx: torch.Tensor,
                        num_examples: int):
    """This rank's rows of the batch at global example indices ``idx`` (a
    device tensor [B]) from a cache sharded over the ranks (rank r holds
    examples ``[r N/W, (r+1) N/W)``): each rank takes all B rows at their
    local offsets and zeroes those it does not own, and one all-reduce of
    the bits (each element has one owner, so the sum is exact) gives every
    rank the batch. Every shape is fixed by B, whatever the indices, so a
    CUDA graph holds it; O(B T) a step."""
    per = num_examples // mesh.world
    mine = (idx // per) == mesh.rank
    local = idx % per
    waves = torch.where(mine[:, None], all_waves.index_select(0, local), 0)
    pitches = torch.where(mine, all_pitches.index_select(0, local), 0)
    bits = torch.cat([waves.view(torch.int32).reshape(-1),
                      pitches.to(torch.int32)])
    mesh.all_reduce_sum(bits)
    rows = mesh.rows(len(idx))
    waves = bits[:waves.numel()].view(torch.float32).view_as(waves)
    return waves[rows], bits[waves.numel():][rows].to(all_pitches.dtype)


def make_cached_superstep(config: Config, stage: int, num_examples: int,
                          mesh=None, graphs: bool = True) -> StepFn:
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
    ``num_examples`` stays N).

    WaveGAN (``model.architecture``) takes ``train.critic_updates`` n
    batches a step, the stream's at positions ``step * n + j``, and its
    own noise (``models.wavegan.wavegan_noise``)."""
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

    prog = _StepProgram(config, stage, mesh, graphs)
    kmax = max(1, int(config.train.unroll))
    local = batch if mesh is None else batch // mesh.world
    wavegan, n = is_wavegan(config), prog.updates

    def superstep(state, all_waves, all_pitches, alphas):
        alphas = [float(a) for a in alphas]

        def stage():
            if wavegan:
                idx = [[cached_batch_indices(state.rng, (state.step + i) * n
                                             + j, batch, num_examples, law)
                        for j in range(n)] for i in range(len(alphas))]
                return _stage_wavegan_rows(state, alphas, config, idx)
            idx = [cached_batch_indices(state.rng, state.step + i, batch,
                                        num_examples, law)
                   for i in range(len(alphas))]
            if not sharded:   # else the global batch's: each has an owner
                idx = [x if mesh is None else x[mesh.rows(batch)]
                       for x in idx]
            return _stage_rows(state, alphas, batch,
                               config.model.latent_dim, mesh, indices=idx)

        if sharded:
            def fetch(dev_idx, pos):
                return _gather_from_owners(mesh, all_waves, all_pitches,
                                           dev_idx, num_examples)
        else:
            def fetch(dev_idx, pos):
                return (all_waves.index_select(0, dev_idx),
                        all_pitches.index_select(0, dev_idx))
        metrics = prog.run(state, stage, fetch, all_waves.device,
                           max(kmax, len(alphas)), local,
                           batch if sharded else local,
                           static=(all_waves, all_pitches))
        metrics["alpha"] = torch.tensor(alphas[-1])
        return state, metrics

    superstep.program = prog
    return superstep
