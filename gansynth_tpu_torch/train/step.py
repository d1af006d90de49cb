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

``fused_critic`` ("none", "pair", "all") only schedules the reference's
critic passes (vmap stacks them; every pass keeps its own minibatch-stddev
groups), so all three compute the same function. The port runs the three
passes as separate critic calls under each of them.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from gansynth_tpu_torch.kernels import marks
from gansynth_tpu_torch.models.layers import downsample_avg
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
# alpha, then the critic's and the generator's Adam bias corrections
_SCALARS = 5


def _make_core(config: Config, stage: int, mesh):
    """``(core, metric names)``: ``core(state, wave, pitch, alpha, z_d, u,
    z_g, bc_d, bc_g, mark) -> metrics``, one step's device work on tensors
    (``bc_d``, ``bc_g``: each Adam's two bias corrections), updating the
    state's tensors in place; ``mark(name)`` is called at the frontend's,
    the critic update's and the generator update's ends
    (:class:`StepPhases`)."""
    m, t = config.model, config.train
    if t.fused_critic not in ("none", "pair", "all"):
        raise ValueError(f"unknown fused_critic {t.fused_critic!r}")
    use_pc = (t.pitch_consistency_weight > 0.0
              and stage >= t.pitch_consistency_min_stage)

    def critic_update(state, real, labels, z_d, u, alpha, bc):
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
        state.d_opt.update(*bc)
        return dict(zip(_D_METRICS, (
            d_loss, wgan, gp, drift, ce, ce_fake, torch.mean(c_real),
            torch.mean(c_fake))))

    def generator_update(state, labels, z_g, alpha, bc):
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
        state.g_opt.update(*bc)
        return out

    def core(state, wave, pitch, alpha, z_d, u, z_g, bc_d, bc_g, mark):
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
        ema_update(state.ema, state.g, t.ema_decay)
        metrics = {k: v.detach().float() for k, v in metrics.items()}
        if mesh is not None:
            metrics = _mean_over_ranks(metrics, mesh)
        return metrics

    names = (*_D_METRICS, "g_adv", "g_pitch_ce",
             *(("g_pitch_consistency",) if use_pc else ()), "g_loss")
    return core, names


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


def _copy_in(dst: torch.Tensor, array: np.ndarray) -> None:
    """``dst[:len(array)] = array`` in one copy, from pinned memory to a
    card (the host does not wait; the copy keeps its source alive)."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    if dst.device.type == "cuda":
        src = src.pin_memory()
    dst[:len(array)].copy_(src, non_blocking=True)


class _Rows:
    """The per-step values of up to ``kmax`` steps, on ``device``. Row k
    holds step k's z_d [b, D], u [b], z_g [b, D], alpha and the critic's
    and the generator's bias corrections as float32 bits, then
    ``indices`` example indices (int32): this rank's batch's, or the
    global batch's for a sharded cache. :attr:`pos`, on the
    device, is the row the next step reads; each step writes its metrics
    to row ``pos`` of :attr:`metrics` and advances it."""

    def __init__(self, device, batch: int, latent_dim: int, kmax: int,
                 n_metrics: int, indices: int):
        self.batch, self.latent_dim = batch, latent_dim
        self.floats = 2 * batch * latent_dim + batch + _SCALARS
        self.width = self.floats + indices
        self.rows = torch.zeros((kmax, self.width), dtype=torch.int32,
                                device=device)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=device)
        self.metrics = torch.zeros((kmax, n_metrics), dtype=torch.float32,
                                   device=device)

    def load(self, rows: np.ndarray) -> None:
        _copy_in(self.rows, rows)
        self.pos.zero_()

    def read(self):
        """``(z_d, u, z_g, alpha, bc_d, bc_g, idx)`` of row ``pos``."""
        row = self.rows.index_select(0, self.pos)[0]
        f = row.view(torch.float32)
        b, d = self.batch, self.latent_dim
        n = b * d
        s = f[2 * n + b:self.floats]
        idx = row[self.floats:].long() if self.width > self.floats else None
        return (f[:n].view(b, d), f[n:n + b].view(b, 1, 1, 1),
                f[n + b:2 * n + b].view(b, d), s[0], (s[1], s[2]),
                (s[3], s[4]), idx)

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

    Device: five marks a step (``kernels/marks.py``: ``start`` before the
    row is read, ``frontend`` after the real image, ``critic`` and
    ``generator`` after each update with its Adam, ``end`` after the row
    is written) add the time between them to the phases ``frontend``,
    ``critic``, ``generator``, ``ema`` (EMA, the metrics, their mean over
    the ranks, the row write) and ``between`` (the previous step's end to
    this one's start: between replays and between supersteps; not counted
    at a program's first mark), and count the steps. The totals stay on
    the step's device, and the graph replays the marks with the step.

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
        """``{"steps": n, "<phase>_ns": ..., "host_stage_ns": ...}``, each
        a total since the program was made."""
        t = ([0] * marks.SLOTS if self.totals is None
             else self.totals.tolist())
        return {"steps": t[marks.STEPS],
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
        z_d, u, z_g, alpha, bc_d, bc_g, idx = self.rows.read()
        wave, pitch = fetch(idx, self.rows.pos)
        metrics = self.core(state, wave, pitch, alpha, z_d, u, z_g, bc_d,
                            bc_g, mark)
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
                    or r.rows.device != device
                    or r.width - r.floats != indices):
                r = self.rows = _Rows(device, batch, self.latent_dim,
                                      max(k, kmax), len(self.names), indices)
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
        state.d_opt.count += k
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
    ``num_examples`` stays N)."""
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

    def superstep(state, all_waves, all_pitches, alphas):
        alphas = [float(a) for a in alphas]

        def stage():
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
