"""The outer training loop (``gansynth_tpu/train/loop.py``) on one device.

Python drives the schedule and the data; each chunk of up to
``config.train.unroll`` steps is one superstep (``train/step.py``), whose
inner steps the host launches without waiting for the device: on one
card, K replays of the step's CUDA graph (the reference's ``lax.scan``
program). The step function, and with it its graph, is kept for the
current ``(stage, fused, released)`` only: an anchor-release schedule
splits a stage into the pre- and post-release loss programs, a chunk
never crosses a stage change or the release step, and the old graph is
dropped (its memory freed) when the key changes. A graph is captured at
the first chunk after the state is made or restored, since it holds the
parameters' addresses. Checkpoints, ``ema.npz``, the sample dumps and the
STOP check run between supersteps. The sample dumps replay the stage's
keyed sampler's CUDA graph on a card (one sampler a stage; it captures
again if the EMA's weights have moved). Resume restores the full state
and recomputes the stage, alpha and release phase from the restored
step, so a restart lands where it left off.

Three data routes, as in the reference: ``data_iter`` (numpy batches, one
per step, fast-forwarded on resume by ``step - data_position``),
``data_factory`` (one stream per stage, built already advanced to the
step's place within its stage, for per-stage batch sizes) and
``device_dataset`` (the whole dataset on the device; each inner step
gathers its batch at indices that are a function of the state's key and
step, so the stream needs no position).

At a log crossing the loop reads one scalar of the metrics (``.item()``
waits for the device) before it reads the clock, so ``steps_per_sec``
counts finished steps. There it also reads the current step program's
phases (``train/step.py:StepPhases``) and logs, as ms a step since the
last log, each phase's device time (``phase_ms/<phase>``) and the host's
staging (``host_stage_ms``); with a mesh, rank 0's.

WaveGAN (``model.architecture``) has one stage at alpha 1
(``schedule_from_config``) and trains from ``device_dataset`` only; its
sample dumps write the EMA's waves (``make_wavegan_sampler``) with no
image.

Graceful stop: a ``STOP`` file in the workdir (``cli stop``) makes the
loop checkpoint at the next superstep boundary and return; the file is
consumed when honoured. A file already present at start is honoured at
the first boundary, never deleted unread: it may be a live request that
raced a supervised child's start.

Data parallelism (``mesh``, or ``use_mesh`` for the current process
group's, ``parallel/sharding.py``): every rank runs this loop on its card
with the same state (made from the seed or restored, then checked and
broadcast by ``replicate_on_mesh``) and takes its rows of every global
batch. A batch of the global size is sliced to the rank's rows; a batch
of the local size (``--multihost``, where each process decodes only its
slice) is taken as is. The device cache is placed per
``device_cache_layout``: a full copy on every rank, or rank r's N/W
examples under ``"shard"`` (N must divide the world size). On cards
every rank replays the step's CUDA graph, collectives included, as on
one card (``train/step.py``). Only rank 0
writes ``metrics.jsonl``, checkpoints, ``ema.npz`` and the sample dumps;
every rank restores. The STOP check of a group of ranks runs at the log
cadence's crossings and is a max over the ranks' file checks (the
reference's ``process_allgather``, on the host), so a STOP file on any
rank stops every rank at the same step.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from gansynth_tpu_torch.kernels import marks
from gansynth_tpu_torch.parallel.sharding import (
    cache_sharding,
    make_mesh,
    rank_rows,
    replicate_on_mesh,
)
from gansynth_tpu_torch.synth import random as jrandom
from gansynth_tpu_torch.train.schedule import schedule_from_config
from gansynth_tpu_torch.train.state import TrainState, create_train_state
from gansynth_tpu_torch.train.step import (
    make_cached_superstep,
    make_superstep,
    make_train_step,
)
from gansynth_tpu_torch.utils.config import Config
from gansynth_tpu_torch.utils.device import resolve_device


def _dump_samples(config, state, sample, step: int, workdir: str,
                  logger=None) -> None:
    """The EMA generator's notes at the configured pitches and the current
    stage, written as wavs (and TensorBoard summaries when the logger has
    a writer). ``sample`` is the stage's keyed sampler; the key is
    ``fold_in(key(train.seed), step)``, as in the reference."""
    from gansynth_tpu_torch.utils.audio_io import write_wav

    key = jrandom.fold_in(jrandom.seed_to_key(config.train.seed), step)
    waves, images = sample(key, config.train.sample_pitches)
    waves = waves.float().cpu().numpy()
    out_dir = os.path.join(workdir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    for pitch, wave in zip(config.train.sample_pitches, waves):
        write_wav(os.path.join(out_dir, f"step{step:08d}_pitch{pitch}.wav"),
                  wave, config.audio.sample_rate)
    if logger is not None and images is not None:   # WaveGAN's: no image
        logger.log_artifacts(step, waves, images.float().cpu().numpy(),
                             config.audio.sample_rate)


def _phase_ms(now: Dict[str, int],
              before: Optional[Dict[str, int]]) -> Dict[str, float]:
    """ms a step of each phase (``phase_ms/<phase>``) and of the host's
    staging (``host_stage_ms``) between two readings of a program's
    :meth:`StepPhases.read` (``before`` None: since the program was
    made); nothing when no step ended between them."""
    before = before or dict.fromkeys(now, 0)
    steps = now["steps"] - before["steps"]
    if steps <= 0:
        return {}
    ms = {f"phase_ms/{p}": now[f"{p}_ns"] - before[f"{p}_ns"]
          for p in marks.PHASES}
    ms["host_stage_ms"] = now["host_stage_ns"] - before["host_stage_ns"]
    return {k: v / 1e6 / steps for k, v in ms.items()}


def _crossed(prev: int, new: int, every: int) -> bool:
    """True when (prev, new] contains a multiple of ``every``."""
    return every > 0 and new // every > prev // every


def _maybe_inject_stall(spec: str, step: int) -> None:
    """Fault injection for the supervisor's stall test
    (``train/supervisor.py``): ``spec`` is ``"<step>:<flagfile>"``; hang
    once ``step`` reaches ``<step>`` unless ``<flagfile>`` exists (it is
    created on the way into the hang, so a supervised restart runs past
    it, like a transient wedge)."""
    at, flag = spec.split(":", 1)
    if step >= int(at) and not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write(str(step))
        while True:   # a wedged device call: never returns
            time.sleep(3600)


def _check_release(config: Config) -> Optional[Config]:
    """The released config when the run has a release step (validated as
    the reference does), else None."""
    release_step = config.train.pitch_consistency_release_step
    if release_step is None:
        return None
    if release_step < 0:
        raise ValueError(
            f"pitch_consistency_release_step {release_step} is negative "
            "(would mean 'released from step 0')")
    if config.train.pitch_consistency_weight == 0.0:
        raise ValueError(
            "pitch_consistency_release_step is set but "
            "pitch_consistency_weight is 0: there is no anchor to release, "
            "and the release would still turn off the AC-GAN fake-batch "
            "pitch CE (a change to D's objective). Set "
            "--pitch-consistency > 0, or drop the release flag and use the "
            "d_pitch_ce_on_fake config field directly.")
    return config.released()


def train(
    config: Config,
    data_iter: Optional[Iterator[Tuple[np.ndarray, np.ndarray]]],
    *,
    num_steps: Optional[int] = None,
    workdir: Optional[str] = None,
    mesh: Optional[object] = None,
    use_mesh: bool = False,
    device_dataset: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    data_position: int = 0,
    data_factory: Optional[Callable[[int, int, int], Iterator]] = None,
    device="cuda",
) -> TrainState:
    """Run (or resume) training on ``device``; returns the final state.

    ``data_iter`` yields (wave [B, 64000] f32, pitch [B] int) numpy
    batches; it may be None when ``device_dataset`` (all_waves [N, T],
    all_pitches [N], copied to the device once) or ``data_factory``
    (``(stage, global_batch, skip_batches) -> iterator``) supplies the
    data. ``data_position`` says how far the caller already advanced
    ``data_iter``; the loop skips the rest of the way to the restored
    step. With a ``workdir`` the loop logs to ``metrics.jsonl``, saves
    checkpoints under ``checkpoints/`` (restoring the latest at start), writes ``ema.npz`` at every checkpoint, dumps
    samples every ``sample_every`` steps and honours a ``STOP`` file.
    With ``mesh`` (or ``use_mesh``) the run is data-parallel on
    ``mesh.device``; see the module's docstring.
    """
    if use_mesh and mesh is None:
        mesh = make_mesh()
    device = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0   # writes the run's files
    schedule = schedule_from_config(config)
    unroll = max(1, int(config.train.unroll))
    sharded = mesh is not None and cache_sharding(
        config.train.device_cache_layout) == "shard"
    if device_dataset is not None:
        num_examples = int(len(device_dataset[0]))
        if sharded and num_examples % mesh.world:
            raise ValueError(
                f"device_cache_layout='shard' needs the dataset size "
                f"({num_examples}) divisible by the world size "
                f"({mesh.world}); pad/trim the cache or use 'replicate'")
    logger = checkpointer = None
    state = create_train_state(config, device=device)
    if workdir is not None:
        from gansynth_tpu_torch.utils.checkpoint import (
            Checkpointer,
            refuse_orbax,
        )
        from gansynth_tpu_torch.utils.logging import MetricLogger

        if lead:
            logger = MetricLogger(workdir)
        checkpointer = Checkpointer(os.path.join(workdir, "checkpoints"))
        refuse_orbax(checkpointer.directory)
        if checkpointer.latest_step() is not None:
            state, _ = checkpointer.restore(state)
    if mesh is not None:
        state = replicate_on_mesh(mesh, state)

    if device_dataset is not None:
        waves, pitches = device_dataset
        if sharded:
            rows = mesh.rows(num_examples)
            waves, pitches = waves[rows], pitches[rows]
        all_waves = torch.from_numpy(np.asarray(waves, np.float32)).to(device)
        all_pitches = torch.from_numpy(
            np.asarray(pitches, np.int32)).to(device)
    elif data_iter is None and data_factory is None:
        raise ValueError("pass data_iter, data_factory, or device_dataset")
    if (config.train.stage_batch_sizes is not None
            and device_dataset is None and data_factory is None):
        raise ValueError(
            "stage_batch_sizes needs data_factory (a fixed-batch "
            "data_iter cannot change shape across stages) or "
            "device_dataset")
    if data_iter is not None:
        behind = int(state.step) - data_position
        if behind < 0:
            raise ValueError(
                f"data_position {data_position} is ahead of the restored "
                f"step {int(state.step)}")
        for _ in range(behind):
            next(data_iter)
    if mesh is not None and unroll == 1 and data_iter is not None:
        from gansynth_tpu_torch.data.prefetch import prefetch_to_mesh

        data_iter = prefetch_to_mesh(data_iter, mesh,
                                     config.train.batch_size)

    release_step = config.train.pitch_consistency_release_step
    released_config = _check_release(config)

    step_fns: Dict[Tuple[int, bool, bool], Callable] = {}
    sampler_fns: Dict[int, Callable] = {}

    def get_sampler(stage: int):
        if stage not in sampler_fns:
            if config.model.architecture == "wavegan":
                from gansynth_tpu_torch.models.wavegan import (
                    make_wavegan_sampler,
                )

                sampler_fns[stage] = make_wavegan_sampler(config, state.ema)
            else:
                from gansynth_tpu_torch.synth.sampler import make_sampler

                sampler_fns[stage] = make_sampler(config, state.ema, stage)
        return sampler_fns[stage]

    def get_step_fn(stage: int, fused: bool, released: bool):
        key = (stage, fused, released)
        if key not in step_fns:
            step_fns.clear()   # the old graph's shapes or losses are gone
            cfg = released_config if released else config
            if device_dataset is not None:
                step_fns[key] = make_cached_superstep(cfg, stage,
                                                      num_examples, mesh)
            elif fused:
                step_fns[key] = make_superstep(cfg, stage, mesh)
            else:
                step_fns[key] = make_train_step(cfg, stage, mesh)
        return step_fns[key]

    def to_device(array, dtype, global_batch, axis=0):
        """A batch (or a [K, B, ...] chunk) on the device; under a mesh,
        this rank's part of it (``rank_rows``)."""
        array = np.asarray(array, dtype)
        if mesh is not None:
            array = rank_rows(mesh, array, global_batch, axis)
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    start = int(state.step)
    end = schedule.total_steps() if num_steps is None else start + num_steps
    if release_step is not None and release_step > end and start < end:
        # Not an error (a continuation may carry a later release), but a
        # typo'd step would otherwise never release, silently.
        warnings.warn(
            f"pitch_consistency_release_step {release_step} is at/past "
            f"this run's final step {end}: the anchor will NOT release "
            "during this invocation (typo?)", stacklevel=2)
    t_last = time.perf_counter()
    steps_since_log = 0
    stall_spec = os.environ.get("GANSYNTH_TRAIN_STALL")

    stop_path = os.path.join(workdir, "STOP") if workdir is not None else None
    if stop_path and os.path.exists(stop_path):
        warnings.warn(
            f"STOP file {stop_path} already present at startup: this run "
            "will checkpoint and exit at its first superstep boundary "
            "(remove the file first if that is not intended)", stacklevel=2)

    def _stop_requested(prev: int, new: int) -> bool:
        if stop_path is None:
            return False
        if mesh is None or mesh.world == 1:
            return os.path.exists(stop_path)
        # Every rank must stop at the same step: decide at the log
        # cadence's crossings, on any rank's file.
        if not _crossed(prev, new, max(config.train.log_every, 1)):
            return False
        return mesh.any(os.path.exists(stop_path))

    def _stage_start(step: int) -> int:
        for _, seg_start, seg_end in schedule.stage_boundaries():
            if step < seg_end:
                return seg_start
        return seg_start   # past the ladder: the final stage's segment

    factory_stage = None
    read_phases = None   # (program, its phases at the last log)
    step_idx = start
    while step_idx < end:
        stage, _ = schedule.stage_and_alpha(step_idx)
        if data_factory is not None and stage != factory_stage:
            data_iter = data_factory(stage,
                                     config.train.batch_for_stage(stage),
                                     step_idx - _stage_start(step_idx))
            if mesh is not None and unroll == 1:
                from gansynth_tpu_torch.data.prefetch import prefetch_to_mesh

                data_iter = prefetch_to_mesh(
                    data_iter, mesh, config.train.batch_for_stage(stage))
            factory_stage = stage
        k = min(unroll, end - step_idx,
                schedule.steps_until_stage_change(step_idx))
        released = release_step is not None and step_idx >= release_step
        if release_step is not None and not released:
            k = min(k, release_step - step_idx)
        alphas = np.asarray(
            [schedule.stage_and_alpha(step_idx + i)[1] for i in range(k)],
            np.float32)

        if device_dataset is not None:
            step_fn = get_step_fn(stage, True, released)
            state, metrics = step_fn(state, all_waves, all_pitches, alphas)
        elif k == 1 and unroll == 1:
            wave, pitch = next(data_iter)
            if not torch.is_tensor(wave):   # prefetched under a mesh
                batch = config.train.batch_for_stage(stage)
                wave = to_device(wave, np.float32, batch)
                pitch = to_device(pitch, np.int32, batch)
            step_fn = get_step_fn(stage, False, released)
            state, metrics = step_fn(state, wave, pitch, float(alphas[0]))
        else:
            batch = config.train.batch_for_stage(stage)
            batches = [next(data_iter) for _ in range(k)]
            waves = to_device(np.stack([np.asarray(b[0]) for b in batches]),
                              np.float32, batch, axis=1)
            pitches = to_device(np.stack([np.asarray(b[1])
                                          for b in batches]), np.int32,
                                batch, axis=1)
            step_fn = get_step_fn(stage, True, released)
            state, metrics = step_fn(state, waves, pitches, alphas)
        steps_since_log += k

        new_step = step_idx + k
        if logger is not None and (
                _crossed(step_idx, new_step, config.train.log_every)
                or new_step == end):
            metrics = dict(metrics)
            metrics["d_loss"] = metrics["d_loss"].item()   # waits for the device
            now = time.perf_counter()
            metrics["steps_per_sec"] = steps_since_log / max(now - t_last,
                                                             1e-9)
            t_last, steps_since_log = now, 0
            prog = step_fn.program
            phases = prog.phases.read()
            metrics.update(_phase_ms(phases, read_phases[1] if read_phases
                                     and read_phases[0] is prog else None))
            read_phases = (prog, phases)
            logger.log(new_step, metrics, stage=stage)
        stop_now = _stop_requested(step_idx, new_step)
        if lead and checkpointer is not None and (
                _crossed(step_idx, new_step, config.train.checkpoint_every)
                or new_step == end or stop_now):
            from gansynth_tpu_torch.utils.checkpoint import save_ema_npz

            checkpointer.save(new_step, state)
            save_ema_npz(
                os.path.join(workdir, "ema.npz"), state.ema, new_step,
                stage=schedule.stage_and_alpha(max(new_step - 1, 0))[0])
        if (lead and workdir is not None and config.train.sample_every
                and _crossed(step_idx, new_step, config.train.sample_every)):
            _dump_samples(config, state, get_sampler(stage), new_step,
                          workdir, logger)
        if stall_spec:
            _maybe_inject_stall(stall_spec, new_step)
        step_idx = new_step
        if stop_now:
            if os.path.exists(stop_path):   # on the ranks that hold it
                os.remove(stop_path)
            print(f"graceful stop: STOP file honored at step {new_step}; "
                  "checkpointed and exiting cleanly", flush=True)
            break

    if checkpointer is not None:
        checkpointer.wait()
    if logger is not None:
        logger.close()
    return state
