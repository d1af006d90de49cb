"""The outer training loop (``gansynth_tpu/train/loop.py``) on one device.

Python drives the schedule and the data; each chunk of up to
``config.train.unroll`` steps is one superstep (``train/step.py``), whose
inner steps the host launches without waiting for the device. Step
functions are cached per ``(stage, fused, released)``: an
anchor-release schedule splits a stage into the pre- and post-release
loss programs, and a chunk never crosses a stage change or the release
step. Resume restores the full state and recomputes the stage, alpha and
release phase from the restored step, so a restart lands where it left
off.

Three data routes, as in the reference: ``data_iter`` (numpy batches, one
per step, fast-forwarded on resume by ``step - data_position``),
``data_factory`` (one stream per stage, built already advanced to the
step's place within its stage, for per-stage batch sizes) and
``device_dataset`` (the whole dataset on the device; each inner step
gathers its batch at indices that are a function of the state's key and
step, so the stream needs no position).

At a log crossing the loop reads one scalar of the metrics (``.item()``
waits for the device) before it reads the clock, so ``steps_per_sec``
counts finished steps.

Graceful stop: a ``STOP`` file in the workdir (``cli stop``) makes the
loop checkpoint at the next superstep boundary and return; the file is
consumed when honoured. A file already present at start is honoured at
the first boundary, never deleted unread: it may be a live request that
raced a supervised child's start.

The reference's mesh arguments (``mesh``, ``use_mesh``,
``device_cache_layout="shard"``) raise ``NotImplementedError``: data
parallelism is ``ROADMAP.md`` queue 1 item 4.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

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
    waves, images = waves.float().cpu().numpy(), images.float().cpu().numpy()
    out_dir = os.path.join(workdir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    for pitch, wave in zip(config.train.sample_pitches, waves):
        write_wav(os.path.join(out_dir, f"step{step:08d}_pitch{pitch}.wav"),
                  wave, config.audio.sample_rate)
    if logger is not None:
        logger.log_artifacts(step, waves, images, config.audio.sample_rate)


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
    """
    if mesh is not None or use_mesh \
            or config.train.device_cache_layout == "shard":
        raise NotImplementedError(
            "data parallelism (mesh, use_mesh, device_cache_layout="
            "'shard') is not ported yet: ROADMAP.md queue 1 item 4")
    device = resolve_device(device)
    schedule = schedule_from_config(config)
    unroll = max(1, int(config.train.unroll))
    logger = checkpointer = None
    state = create_train_state(config, device=device)
    if workdir is not None:
        from gansynth_tpu_torch.utils.checkpoint import Checkpointer
        from gansynth_tpu_torch.utils.logging import MetricLogger

        logger = MetricLogger(workdir)
        checkpointer = Checkpointer(os.path.join(workdir, "checkpoints"))
        if checkpointer.latest_step() is not None:
            state, _ = checkpointer.restore(state)

    if device_dataset is not None:
        all_waves = torch.from_numpy(
            np.asarray(device_dataset[0], np.float32)).to(device)
        all_pitches = torch.from_numpy(
            np.asarray(device_dataset[1], np.int32)).to(device)
        num_examples = int(all_waves.shape[0])
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

    release_step = config.train.pitch_consistency_release_step
    released_config = _check_release(config)

    step_fns: Dict[Tuple[int, bool, bool], Callable] = {}
    sampler_fns: Dict[int, Callable] = {}

    def get_sampler(stage: int):
        if stage not in sampler_fns:
            from gansynth_tpu_torch.synth.sampler import make_sampler

            sampler_fns[stage] = make_sampler(config, state.ema, stage)
        return sampler_fns[stage]

    def get_step_fn(stage: int, fused: bool, released: bool):
        key = (stage, fused, released)
        if key not in step_fns:
            cfg = released_config if released else config
            if device_dataset is not None:
                step_fns[key] = make_cached_superstep(cfg, stage,
                                                      num_examples)
            elif fused:
                step_fns[key] = make_superstep(cfg, stage)
            else:
                step_fns[key] = make_train_step(cfg, stage)
        return step_fns[key]

    def to_device(array, dtype):
        return torch.from_numpy(np.asarray(array, dtype)).to(device)

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

    def _stage_start(step: int) -> int:
        for _, seg_start, seg_end in schedule.stage_boundaries():
            if step < seg_end:
                return seg_start
        return seg_start   # past the ladder: the final stage's segment

    factory_stage = None
    step_idx = start
    while step_idx < end:
        stage, _ = schedule.stage_and_alpha(step_idx)
        if data_factory is not None and stage != factory_stage:
            data_iter = data_factory(stage,
                                     config.train.batch_for_stage(stage),
                                     step_idx - _stage_start(step_idx))
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
            state, metrics = get_step_fn(stage, True, released)(
                state, all_waves, all_pitches, alphas)
        elif k == 1 and unroll == 1:
            wave, pitch = next(data_iter)
            state, metrics = get_step_fn(stage, False, released)(
                state, to_device(wave, np.float32),
                to_device(pitch, np.int32), float(alphas[0]))
        else:
            batches = [next(data_iter) for _ in range(k)]
            waves = to_device(np.stack([np.asarray(b[0]) for b in batches]),
                              np.float32)
            pitches = to_device(np.stack([np.asarray(b[1])
                                          for b in batches]), np.int32)
            state, metrics = get_step_fn(stage, True, released)(
                state, waves, pitches, alphas)
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
            logger.log(new_step, metrics, stage=stage)
        stop_now = stop_path is not None and os.path.exists(stop_path)
        if checkpointer is not None and (
                _crossed(step_idx, new_step, config.train.checkpoint_every)
                or new_step == end or stop_now):
            from gansynth_tpu_torch.utils.checkpoint import save_ema_npz

            checkpointer.save(new_step, state)
            save_ema_npz(
                os.path.join(workdir, "ema.npz"), state.ema, new_step,
                stage=schedule.stage_and_alpha(max(new_step - 1, 0))[0])
        if (workdir is not None and config.train.sample_every
                and _crossed(step_idx, new_step, config.train.sample_every)):
            _dump_samples(config, state, get_sampler(stage), new_step,
                          workdir, logger)
        if stall_spec:
            _maybe_inject_stall(stall_spec, new_step)
        step_idx = new_step
        if stop_now:
            os.remove(stop_path)
            print(f"graceful stop: STOP file honored at step {new_step}; "
                  "checkpointed and exiting cleanly", flush=True)
            break

    if checkpointer is not None:
        checkpointer.wait()
    if logger is not None:
        logger.close()
    return state
