"""Command line of the port: ``python -m gansynth_tpu_torch.cli <command>``.

Counterpart of ``gansynth_tpu/cli.py``. Ported subcommands:

- ``train``      progressive WGAN-GP training from TFRecords (or synthetic
                 fixtures with ``--synthetic``), checkpointed, resumable;
- ``stop``       ask a running ``train``/``supervise`` to checkpoint and
                 exit 0 at its next superstep boundary;
- ``supervise``  ``train`` under a watchdog that restarts it from the
                 latest checkpoint when its heartbeat stalls;
- ``export-ema`` the latest checkpoint's EMA generator as ``ema.npz``;
- ``export-model`` the portable serving artifact (``synth/export.py``): the
                 EMA generator and the whole seeded synthesis in one
                 ``torch.export`` file, with K1 kept in the program;
- ``fixtures``   synthetic NSynth-schema TFRecords (no TensorFlow);
- ``serve``      the HTTP synthesis service from a restored run, or from
                 an exported artifact (``--from-exported``);
- ``generate``   wav files of seeded notes from a restored run;
- ``interpolate`` a latent morph (and pitch glide) between two notes as
                 one wav a step and a crossfaded ``morph.wav``, from a
                 restored run or an artifact with its latent program;
- ``evaluate``   pitch-fidelity and distribution metrics of a restored
                 run, as JSON;
- ``roundtrip``  wave -> mel-IF image -> wave, with the SNR;
- ``validate-data`` the readiness gate of TFRecord files (schema,
                 distributions, decode rate, one superstep, roundtrip).

``serve``, ``generate``, ``interpolate``, ``evaluate`` and
``export-model`` restore through one function, :func:`_restore_sampler`:
the newest full checkpoint under ``checkpoints/`` when it is the port's,
else ``ema.npz`` (the reference's orbax checkpoints are not read), with
the run's ``train_config.json`` under the model flags and ``--config``. ``serve --from-exported`` and ``interpolate
--from-exported`` take a ``.gsx`` artifact instead, whose header carries
the config.

The flags and defaults are the reference's, apart from what the port
refuses with an error (exit 2): ``--ingest tf`` / ``--ingest tfdata``
(there is no TensorFlow beside the card; the native reader is the
default) and ``export-model --platforms`` other than ``cpu`` and
``cuda``. Commands that run a model take ``--device`` (default ``cuda``;
``cpu`` to run without a card).

Data parallelism is one process per card in a ``torch.distributed`` group
(``parallel/sharding.py``). ``train --data-parallel`` starts one worker
per visible card on a free local port, or joins the group when a launcher
(``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``) started it; every worker reads the global batch stream
and keeps its rows. ``train --multihost`` joins a launcher's group and
decodes only its slice of each global batch (``num_shards`` = world
size). ``--mbstd per-replica`` takes the minibatch statistic per rank
(``mbstd_replicas`` = world size). ``serve --data-parallel`` holds one
EMA replica per visible card and splits each batch over them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np

from gansynth_tpu_torch.utils.config import Config, ModelConfig, TrainConfig

_NO_TENSORFLOW = ("needs TensorFlow, which the port does not use; the port "
                  "reads TFRecords with its native reader (--ingest native, "
                  "the default)")


def run_config(model_dir: str) -> Config:
    """The run's ``train_config.json`` over the defaults (defaults alone
    when the run directory has none)."""
    saved = os.path.join(model_dir, "train_config.json")
    if not os.path.exists(saved):
        return Config()
    with open(saved) as f:
        return Config().with_overrides(json.load(f))


def _parse_stage_steps(text):
    """Comma-separated per-stage step counts -> tuple (None when unset)."""
    if not text:
        return None
    return tuple(int(s) for s in text.split(","))


def _build_config(args) -> Config:
    """The effective config: flags, then the ``--config`` JSON on top.
    ``--dump-config`` prints it (the reference's JSON for the same flags)
    and exits."""
    train = TrainConfig(
        batch_size=args.batch_size,
        stage_batch_sizes=_parse_stage_steps(args.stage_batch_sizes),
        learning_rate=args.learning_rate,
        fade_steps=args.fade_steps,
        stable_steps=args.stable_steps,
        stage_fade_steps=_parse_stage_steps(args.stage_fade_steps),
        stage_stable_steps=_parse_stage_steps(args.stage_stable_steps),
        unroll=args.unroll,
        device_cache_layout=getattr(args, "device_cache_layout",
                                    "replicate"),
        fused_critic=args.fused_critic,
        pitch_consistency_weight=args.pitch_consistency,
        pitch_consistency_release_step=args.pitch_consistency_release,
        seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every,
        sample_every=getattr(args, "sample_every", 0),
    )
    mbstd_replicas = 1
    if getattr(args, "mbstd", "global") == "per-replica":
        import torch

        from gansynth_tpu_torch.parallel.sharding import world_size

        mbstd_replicas = max(1, world_size(torch.device(args.device)))
    model = ModelConfig(
        latent_dim=args.latent_dim,
        fmap_base=args.fmap_base,
        fmap_max=args.fmap_max,
        compute_dtype=args.compute_dtype,
        mbstd_replicas=mbstd_replicas,
    )
    config = Config(model=model, train=train)
    if args.config:
        with open(args.config) as f:
            config = config.with_overrides(json.load(f))
    if args.dump_config:
        print(json.dumps(dataclasses.asdict(config), indent=2,
                         sort_keys=True))
        raise SystemExit(0)
    return config


def _add_common_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", help="JSON file with nested "
                   '{"audio": {...}, "model": {...}, "train": {...}} '
                   "overrides, applied on top of the flags")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--stage-batch-sizes", default=None,
                   help="comma-separated per-stage global batch sizes (one "
                   "per stage; overrides --batch-size)")
    p.add_argument("--learning-rate", type=float, default=8e-4)
    p.add_argument("--latent-dim", type=int, default=256)
    p.add_argument("--fmap-base", type=int, default=4096)
    p.add_argument("--fmap-max", type=int, default=256)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the networks (params stay "
                   "float32)")
    p.add_argument("--debug-nans", action="store_true",
                   help="torch.autograd anomaly detection (raises where a "
                   "backward pass makes a NaN)")
    p.add_argument("--fade-steps", type=int, default=800_000)
    p.add_argument("--stable-steps", type=int, default=800_000)
    p.add_argument("--stage-fade-steps", default=None,
                   help="comma-separated per-stage fade steps (one per "
                   "stage; overrides --fade-steps)")
    p.add_argument("--stage-stable-steps", default=None,
                   help="comma-separated per-stage stabilization steps")
    p.add_argument("--unroll", type=int, default=1,
                   help="train steps per superstep (one host call; the "
                   "metrics are read once per superstep at most)")
    p.add_argument("--fused-critic", default="none",
                   choices=["none", "pair", "all"],
                   help="the reference's schedule of the critic passes "
                   "(the same function; the port runs them one by one)")
    p.add_argument("--pitch-consistency", type=float, default=0.0,
                   help="weight of the generator-side harmonic-template "
                   "pitch CE (ops/harmonic.py); 0 = off")
    p.add_argument("--pitch-consistency-release", type=int, default=None,
                   metavar="STEP",
                   help="global step at which the anchor comes off in one "
                   "run: from STEP on the pitch-consistency weight is 0 and "
                   "the AC-GAN head stops training on fake batches")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-every", type=int, default=2000)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--dump-config", action="store_true",
                   help="print the effective config as --config-compatible "
                   "JSON and exit")


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' to run without "
                   "a card)")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _dp_worker(index: int, argv, port: int, world: int) -> None:
    """One ``train --data-parallel`` worker: rank ``index`` of ``world``
    on card ``index``, in the group at ``127.0.0.1:port``."""
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    rc = main(argv)
    if rc:
        raise SystemExit(rc)


def _spawn_workers(args, world: int) -> int:
    """``train --data-parallel`` without a launcher: one spawned worker a
    card, each running this command under a launcher's environment."""
    import torch.multiprocessing as mp

    try:
        mp.start_processes(_dp_worker, args=(args.argv, _free_port(), world),
                           nprocs=world, start_method="spawn")
    except mp.ProcessExitedException as e:
        print(f"error: data-parallel worker {e.error_index} exited with "
              f"{e.exit_code}", file=sys.stderr)
        return e.exit_code if e.exit_code and e.exit_code > 0 else 1
    return 0


def cmd_train(args) -> int:
    import torch
    import torch.distributed as dist

    from gansynth_tpu_torch.data.fixtures import write_synthetic_tfrecords
    from gansynth_tpu_torch.data.native_tfrecord import make_native_iterator
    from gansynth_tpu_torch.parallel import sharding
    from gansynth_tpu_torch.train.loop import train
    from gansynth_tpu_torch.utils.checkpoint import Checkpointer, refuse_orbax
    from gansynth_tpu_torch.utils.device import resolve_device, set_precision

    if args.ingest != "native":
        print(f"error: --ingest {args.ingest} {_NO_TENSORFLOW}",
              file=sys.stderr)
        return 2
    config = _build_config(args)
    device = resolve_device(args.device)
    ckpt_dir = os.path.join(args.model_dir, "checkpoints")
    try:
        refuse_orbax(ckpt_dir)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    mesh, own_group = None, False
    if args.data_parallel or args.multihost:
        world = sharding.world_size(device)
        for stage in range(config.model.num_stages):
            batch = config.train.batch_for_stage(stage)
            if batch % max(world, 1):
                print(f"error: stage {stage} global batch {batch} must "
                      f"divide the world size {world}", file=sys.stderr)
                return 2
        if not (dist.is_initialized() or sharding.launched()):
            if args.multihost:
                print("error: --multihost joins the process group of a "
                      "launcher (torchrun sets RANK, WORLD_SIZE, "
                      "MASTER_ADDR and MASTER_PORT)", file=sys.stderr)
                return 2
            if device.type != "cuda":
                print("error: --data-parallel starts one worker a card; on "
                      "the CPU run it under a launcher (torchrun "
                      "--nproc-per-node N)", file=sys.stderr)
                return 2
            return _spawn_workers(args, world)
        own_group = not dist.is_initialized()
        sharding.initialize_multihost(device)
        mesh = sharding.make_mesh()
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    set_precision()
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    # The effective config rides with the run: serve and export-ema read it.
    os.makedirs(args.model_dir, exist_ok=True)
    if lead:
        with open(os.path.join(args.model_dir, "train_config.json"),
                  "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2,
                      sort_keys=True)
    files = list(args.data or [])
    if args.synthetic and not files:
        # Per-run fixture file: concurrent runs never rewrite it mid-read,
        # and a resume reads the same data. Rank 0 writes it; a rank that
        # does not see it then (another host's disk) writes its own.
        path = os.path.join(args.model_dir, "fixtures.tfrecord")
        if lead and not os.path.exists(path):
            write_synthetic_tfrecords(path, num_examples=256,
                                      seed=config.train.seed)
        if mesh is not None:
            dist.barrier()
            if not os.path.exists(path):
                write_synthetic_tfrecords(path, num_examples=256,
                                          seed=config.train.seed)
        files = [path]
    if not files:
        print("error: pass --data <tfrecord...> or --synthetic",
              file=sys.stderr)
        return 2
    # --multihost: each process decodes its slice of every global batch.
    shards, shard = ((mesh.world, mesh.rank) if args.multihost
                     else (1, 0))

    # Resume position of the data stream (position == batch count == step).
    resume_step = 0
    if os.path.isdir(ckpt_dir):
        resume_step = Checkpointer(ckpt_dir).latest_step() or 0

    acoustic = not args.synthetic
    device_dataset, data, data_factory = None, None, None
    if args.device_cache:
        waves, pitches = [], []
        for w, p in make_native_iterator(
                files, config, acoustic_only=acoustic,
                families=args.instrument_families, batch_size=64,
                shuffle=False, repeat=False, drop_remainder=False):
            waves.append(w)
            pitches.append(p)
        device_dataset = (np.concatenate(waves), np.concatenate(pitches))
        if lead:
            print(f"device cache: {device_dataset[0].shape[0]} examples "
                  f"({device_dataset[0].nbytes / 2**20:.0f} MiB) on "
                  f"{device}", flush=True)
    elif config.train.stage_batch_sizes is not None:
        def data_factory(stage, global_batch, skip):
            return make_native_iterator(
                files, config, acoustic_only=acoustic,
                families=args.instrument_families,
                batch_size=global_batch // shards,
                seed=config.train.seed + 7919 * stage, num_shards=shards,
                shard_index=shard, skip_batches=skip)
    else:
        data = make_native_iterator(
            files, config, acoustic_only=acoustic,
            families=args.instrument_families,
            batch_size=config.train.batch_size // shards,
            seed=config.train.seed, num_shards=shards, shard_index=shard,
            skip_batches=resume_step)
    try:
        state = train(config, data, num_steps=args.num_steps,
                      workdir=args.model_dir, mesh=mesh,
                      device_dataset=device_dataset,
                      data_position=resume_step, data_factory=data_factory,
                      device=device)
    finally:
        if own_group:
            dist.destroy_process_group()
    if lead:
        print(f"trained to step {int(state.step)}; checkpoints in "
              f"{args.model_dir}/checkpoints", flush=True)
    return 0


def make_service(args):
    """``serve``'s service from its flags: ``(service, message)``, or
    ``(None, error)`` for flags it refuses (exit 2)."""
    from gansynth_tpu_torch.serve import SynthesisService

    if args.from_exported:
        if args.data_parallel:
            return None, ("--from-exported is a single lowered program; it "
                          "does not compose with --data-parallel")
        # The artifact's header carries the config: no run directory,
        # checkpoint or model flags.
        from gansynth_tpu_torch.synth.export import load_sampler_artifact
        from gansynth_tpu_torch.utils.device import set_precision

        set_precision()
        try:
            loaded = load_sampler_artifact(args.from_exported, args.device)
            service = SynthesisService(
                loaded.config(), None, exported=loaded,
                max_batch=args.max_batch,
                max_queue_notes=args.max_queue_notes,
                request_timeout_s=args.request_timeout,
            )
        except (OSError, ValueError) as e:
            return None, f"cannot serve {args.from_exported}: {e}"
        return service, (f"artifact from step {loaded.step} (stage "
                         f"{loaded.stage}) on {loaded.device}; warmup done")
    if not args.model_dir:
        return None, "serve needs --model-dir (or --from-exported ART.gsx)"
    sampler, step, stage, config = _restore_sampler(args, _build_config(args))
    devices = None
    if args.data_parallel:
        from gansynth_tpu_torch.parallel.sharding import devices_for

        devices = devices_for(next(sampler.generator.parameters()).device)
    service = SynthesisService(
        config, sampler.generator, stage=stage, max_batch=args.max_batch,
        max_queue_notes=args.max_queue_notes,
        request_timeout_s=args.request_timeout, devices=devices,
    )
    where = "" if devices is None else \
        f" on {len(devices)} device(s), ladder {service.batch_ladder}"
    return service, f"model at step {step}{where}; warmup done"


def cmd_serve(args) -> int:
    from gansynth_tpu_torch.serve import serve_forever

    service, message = make_service(args)
    if service is None:
        print(message, file=sys.stderr)
        return 2
    print(message, flush=True)
    serve_forever(service, args.host, args.port)
    return 0


# (flag name, parser default) of the model flags a restore depends on:
# a flag that differs from its default was set by the caller.
_MODEL_FLAG_DEFAULTS = (
    ("latent_dim", 256),
    ("fmap_base", 4096),
    ("fmap_max", 256),
    ("compute_dtype", "float32"),
)


def _restore_config(args, config: Config) -> Config:
    """The config a run was trained with (its ``train_config.json``), with
    the model flags the caller set and the ``--config`` JSON on top; the
    flags' ``config`` when the run has no ``train_config.json`` (the
    reference's ``_run_config``)."""
    if not os.path.exists(os.path.join(args.model_dir, "train_config.json")):
        return config
    run = run_config(args.model_dir)
    overrides = {name: getattr(args, name)
                 for name, default in _MODEL_FLAG_DEFAULTS
                 if getattr(args, name) != default}
    if overrides:
        run = dataclasses.replace(
            run, model=dataclasses.replace(run.model, **overrides))
    if args.config:
        with open(args.config) as f:
            run = run.with_overrides(json.load(f))
    return run


def _restore_sampler(args, config: Config):
    """Restore a run's EMA generator and the sampler over it:
    ``(sampler, step, stage, config)`` (the reference's
    ``_restore_sampler``).

    ``config`` is :func:`_restore_config`'s, which callers use from here
    on. The weights are the newest full checkpoint's EMA when that
    checkpoint is the port's (``checkpoints/<step>/state.pt``), else
    ``ema.npz``'s: an archived run keeps only the export, which may be
    stored in float16, and a run the reference trained has orbax
    checkpoints, which the port does not read, beside the ``ema.npz`` its
    loop wrote with each of them. ``--stage auto`` takes the
    stage recorded in ``ema.npz`` when the weights came from there, else
    the schedule's stage at ``step - 1``: a run stopped mid-ladder samples
    at the stage it trained (below the final stage the image is
    nearest-upsampled to full size before synthesis); ``--stage N``
    overrides.
    """
    from gansynth_tpu_torch.synth.sampler import Sampler
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.utils.checkpoint import (
        Checkpointer,
        load_ema_generator,
        orbax_steps,
    )
    from gansynth_tpu_torch.utils.device import resolve_device, set_precision

    config = _restore_config(args, config)
    device = resolve_device(args.device)
    set_precision()
    npz = os.path.join(args.model_dir, "ema.npz")
    ckpt_dir = os.path.join(args.model_dir, "checkpoints")
    npz_stage = None
    ours = Checkpointer(ckpt_dir).steps() if os.path.isdir(ckpt_dir) else []
    if ours and ours[-1] > max(orbax_steps(ckpt_dir), default=-1):
        state, step = Checkpointer(ckpt_dir).restore(
            create_train_state(config, device=device))
        generator = state.ema
        del state
    elif os.path.exists(npz):
        generator, step, npz_stage = load_ema_generator(npz, config.model,
                                                        device)
    else:
        raise FileNotFoundError(
            f"{args.model_dir} has neither a checkpoint of the port "
            "(checkpoints/<step>/state.pt) nor ema.npz")
    if args.stage != "auto":
        stage = int(args.stage)
    elif npz_stage is not None:
        stage = npz_stage
    else:
        stage, _ = schedule_from_config(config).stage_and_alpha(
            max(step - 1, 0))
    print(f"restored EMA generator from step {step} (sampling at stage "
          f"{stage}, {config.model.stage_resolution(stage)}) on {device}",
          flush=True)
    return Sampler(config, generator, stage=stage), step, stage, config


def cmd_generate(args) -> int:
    from gansynth_tpu_torch.synth.random import seed_to_key, split
    from gansynth_tpu_torch.utils.audio_io import write_wav

    sampler, _, _, config = _restore_sampler(args, _build_config(args))
    pitches = [int(p) for p in args.pitches]
    os.makedirs(args.output_dir, exist_ok=True)
    key = seed_to_key(args.seed)
    for i in range(args.num_samples):
        key, sub = split(key)
        waves, _ = sampler(sub, pitches)
        for pitch, wave in zip(pitches, waves.float().cpu().numpy()):
            out = os.path.join(args.output_dir, f"sample_{i}_pitch{pitch}.wav")
            write_wav(out, wave, config.audio.sample_rate)
            print(out)
    return 0


def cmd_interpolate(args) -> int:
    """A latent morph (and optionally a pitch glide) between two notes,
    rendered as one batch: a wav per step and a crossfaded ``morph.wav``
    in ``--output-dir``."""
    from gansynth_tpu_torch.synth.interpolate import (
        crossfade_concat,
        interpolation_labels,
        interpolation_latents,
    )
    from gansynth_tpu_torch.synth.random import normal, seed_to_key
    from gansynth_tpu_torch.synth.sampler import make_latent_sampler
    from gansynth_tpu_torch.utils.audio_io import write_wav

    if args.from_exported:
        # Needs the latent program (export-model --with-latent); the
        # config rides in the header.
        from gansynth_tpu_torch.synth.export import load_sampler_artifact

        try:
            loaded = load_sampler_artifact(args.from_exported, args.device)
        except (OSError, ValueError) as e:
            print(f"cannot interpolate from {args.from_exported}: {e}",
                  file=sys.stderr)
            return 2
        if not loaded.has_latent:
            print(f"{args.from_exported} ships only the seeded serving "
                  "program; re-export with `export-model --with-latent` to "
                  "interpolate from an artifact", file=sys.stderr)
            return 2
        config, render = loaded.config(), loaded.latent
    elif args.model_dir:
        sampler, _, stage, config = _restore_sampler(args,
                                                     _build_config(args))
        latent = make_latent_sampler(config, sampler.generator, stage)
        render = lambda z, labels: latent(z, labels)[0]  # noqa: E731
    else:
        print("interpolate needs --model-dir (or --from-exported ART.gsx)",
              file=sys.stderr)
        return 2
    d = config.model.latent_dim
    # The endpoints are the serving path's per-note latents of the seeds.
    za = normal(seed_to_key(args.seed_a), (d,))
    zb = normal(seed_to_key(args.seed_b), (d,))
    z = interpolation_latents(za, zb, args.steps, mode=args.mode)
    pitch_b = args.pitch if args.pitch_b is None else args.pitch_b
    labels = interpolation_labels(args.pitch, pitch_b, args.steps,
                                  config.model.pitch_min,
                                  config.model.num_pitches)
    waves = render(z, labels).float().cpu().numpy()
    os.makedirs(args.output_dir, exist_ok=True)
    for i, t in enumerate(np.linspace(0.0, 1.0, args.steps)):
        out = os.path.join(args.output_dir, f"interp_{i:02d}_t{t:.2f}.wav")
        write_wav(out, waves[i], config.audio.sample_rate)
        print(out)
    overlap = int(round(args.crossfade_ms / 1000.0
                        * config.audio.sample_rate))
    out = os.path.join(args.output_dir, "morph.wav")
    write_wav(out, crossfade_concat(waves, overlap), config.audio.sample_rate)
    print(out)
    return 0


def cmd_evaluate(args) -> int:
    from gansynth_tpu_torch.evaluation import (
        fixture_reference_fn,
        render_notes,
        score_notes,
        tfrecord_reference_fn,
    )

    sampler, step, _, config = _restore_sampler(args, _build_config(args))
    if args.lsd_data:
        reference_fn = tfrecord_reference_fn(args.lsd_data, config)
    else:
        reference_fn = fixture_reference_fn(config.audio.audio_length,
                                            config.audio.sample_rate)
    t0 = time.perf_counter()
    waves, pitches = render_notes(sampler, [int(p) for p in args.pitches],
                                  args.samples_per_pitch, args.seed)
    t1 = time.perf_counter()
    metrics = score_notes(waves, pitches, args.samples_per_pitch,
                          config.audio.sample_rate, reference_fn,
                          args.attribution)
    print(f"evaluate: rendered {len(pitches)} notes in {t1 - t0:.3f} s, "
          f"scored them in {time.perf_counter() - t1:.3f} s", flush=True)
    metrics["checkpoint_step"] = step
    # which references the distribution metrics were taken against
    metrics["reference_set"] = "tfrecord" if args.lsd_data else "fixture"
    metrics["reference_files"] = list(args.lsd_data or [])
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2, sort_keys=True)
        print(f"wrote {args.output}")
    summary = _pitch_accuracy_summary(metrics)
    if summary:
        print(summary)
    print(json.dumps(metrics))
    return 0


def _pitch_accuracy_summary(metrics: dict) -> str:
    """The per-detector accuracies on one line ("either" is the union of
    two detectors with opposite octave errors, so it is never printed
    alone); "" when the pitch metrics are absent."""
    acc = {
        "hps": metrics.get("pitch_accuracy"),  # harmonic-sum detector
        "acf": metrics.get("pitch_accuracy_acf"),
        "either": metrics.get("pitch_accuracy_either"),
    }
    if any(v is None for v in acc.values()):
        return ""
    line = (
        f"pitch accuracy: HPS {acc['hps']:.1%} / ACF {acc['acf']:.1%}"
        f" / either-detector union {acc['either']:.1%}"
    )
    cep = metrics.get("pitch_accuracy_cepstrum")
    cov = metrics.get("pitch_cepstrum_coverage")
    if cep is not None and cov and cep == cep:  # NaN-safe
        line += f" / cepstrum {cep:.1%} (on {cov:.0%} of notes)"
    return line


def cmd_roundtrip(args) -> int:
    import torch

    from gansynth_tpu_torch.data.fixtures import synthesize_note
    from gansynth_tpu_torch.ops.spectral import spectral_calls
    from gansynth_tpu_torch.utils.audio_io import read_wav, write_wav
    from gansynth_tpu_torch.utils.config import AudioConfig
    from gansynth_tpu_torch.utils.device import resolve_device, set_precision

    device = resolve_device(args.device)
    set_precision()
    audio_cfg = AudioConfig()
    if args.input:
        wave, sr = read_wav(args.input)
        if sr != audio_cfg.sample_rate:
            print(f"error: expected {audio_cfg.sample_rate} Hz, got {sr}",
                  file=sys.stderr)
            return 2
        n = audio_cfg.audio_length
        wave = np.pad(wave[:n], (0, max(0, n - wave.size)))
    else:
        wave = synthesize_note(args.pitch)
    to_image, to_wave = spectral_calls(audio_cfg, device)
    with torch.inference_mode():
        img = to_image(torch.from_numpy(wave[None]))
        recon = to_wave(img)[0].float().cpu().numpy()
    err = wave - recon
    snr = 10 * np.log10(np.sum(wave**2) / max(np.sum(err**2), 1e-30))
    print(f"mel-IF image: {tuple(img.shape)}; roundtrip SNR: {snr:.2f} dB "
          f"(mel pseudo-inverse is lossy by design)")
    if args.output:
        write_wav(args.output, recon, audio_cfg.sample_rate)
        print(args.output)
    return 0


def cmd_validate_data(args) -> int:
    from gansynth_tpu_torch.data.validate import validate_data
    from gansynth_tpu_torch.utils.device import resolve_device, set_precision

    if args.ingest != "native":
        print(f"error: --ingest {args.ingest} {_NO_TENSORFLOW}",
              file=sys.stderr)
        return 2
    for f in args.data:
        if not os.path.exists(f):
            print(f"error: {f}: no such file", file=sys.stderr)
            return 2
    device = None
    if not args.skip_train_check:
        device = resolve_device(args.device)
        set_precision()
    report = validate_data(
        args.data, max_examples=args.max_examples,
        throughput_seconds=args.throughput_seconds,
        train_stage=args.train_stage,
        run_train_check=not args.skip_train_check, device=device)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    print(json.dumps(report))
    if not report["ok"]:
        print("validate-data: FAILED (see schema_problems / decode_ok / "
              "train_check_ok above)", file=sys.stderr)
        return 1
    print(f"validate-data: OK: {report['examples_scanned']} examples "
          f"scanned, {report['trainable_acoustic_in_range']} trainable "
          f"after the acoustic+pitch filters, decode "
          f"{report['decode_examples_per_sec']:.0f} ex/s "
          f"({report['decode_headroom_vs_chip']:.0f}x one card's demand)")
    return 0


def cmd_export_ema(args) -> int:
    """Archive a run: the latest full checkpoint's EMA generator as a
    compact ``ema.npz`` in the reference's format."""
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.utils.checkpoint import (
        Checkpointer,
        refuse_orbax,
        save_ema_npz,
    )

    config = _restore_config(args, _build_config(args))
    ckpt_dir = os.path.join(args.model_dir, "checkpoints")
    try:
        refuse_orbax(ckpt_dir)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    template = create_train_state(config, device=args.device)
    state, step = Checkpointer(ckpt_dir).restore(template)
    stage, _ = schedule_from_config(config).stage_and_alpha(max(step - 1, 0))
    out = args.output or os.path.join(args.model_dir, "ema.npz")
    dtype = None if args.dtype == "float32" else args.dtype
    save_ema_npz(out, state.ema, step, stage=stage, dtype=dtype)
    size = os.path.getsize(out) / 2**20
    print(f"wrote {out} ({size:.1f} MiB, step {step}, stage {stage})")
    return 0


def cmd_export_model(args) -> int:
    """The portable serving artifact (``synth/export.py``): the restored
    EMA generator and the whole seeded synthesis in one ``.gsx`` file;
    ``--check`` reloads it and holds its waves to the in-process
    sampler's."""
    from gansynth_tpu_torch.synth.export import (
        PLATFORMS,
        load_sampler_artifact,
        save_sampler_artifact,
    )
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

    platforms = [p.strip().lower() for p in args.platforms.split(",")
                 if p.strip()]
    if not platforms or set(platforms) - set(PLATFORMS):
        print(f"error: --platforms {args.platforms!r}: the port's artifact "
              f"runs on {','.join(PLATFORMS)} only", file=sys.stderr)
        return 2
    sampler, step, stage, config = _restore_sampler(args, _build_config(args))
    out = args.output or os.path.join(args.model_dir, "sampler.gsx")
    t0 = time.perf_counter()
    save_sampler_artifact(out, config, sampler.generator, step, stage=stage,
                          platforms=platforms, batch=args.batch,
                          with_latent=args.with_latent)
    seconds = time.perf_counter() - t0
    size = os.path.getsize(out) / 2**20
    batch = "symbolic" if args.batch is None else str(args.batch)
    progs = "seeded+latent" if args.with_latent else "seeded"
    print(f"wrote {out} ({size:.1f} MiB, step {step}, stage {stage}, "
          f"platforms {','.join(platforms)}, batch {batch}, programs "
          f"{progs}) in {seconds:.2f} s", flush=True)
    if not args.check:
        return 0
    device = next(sampler.generator.parameters()).device
    loaded = load_sampler_artifact(out, device)
    n = args.batch or 4
    seeds = list(range(n))
    pitch = np.linspace(config.model.pitch_min, config.model.pitch_max,
                        n).astype(np.int32).tolist()
    direct = make_seeded_sampler(config, sampler.generator, stage)(
        seeds, pitch).float().cpu().numpy()
    got = loaded(seeds, pitch).float().cpu().numpy()
    rel = float(np.linalg.norm(direct - got)
                / (np.linalg.norm(direct) + 1e-30))
    # The reference's bounds (its export is another XLA specialization);
    # the port's program runs the same modules, so it sits far below them.
    bound = 0.15 if config.model.compute_dtype == "bfloat16" else 1e-3
    print(f"round-trip relative L2 err vs in-process sampler: {rel:.3g} "
          f"(bound {bound:g} for {config.model.compute_dtype})", flush=True)
    if rel > bound:
        print("ERROR: the artifact diverges from the in-process sampler",
              file=sys.stderr)
        return 1
    return 0


def cmd_supervise(args) -> int:
    """``train`` as a child process under a watchdog: restart from the
    latest checkpoint when its heartbeat stalls or it crashes."""
    from gansynth_tpu_torch.train.supervisor import (
        Supervisor,
        model_dir_from_argv,
    )

    train_argv = list(args.train_args)
    if train_argv and train_argv[0] == "--":
        train_argv = train_argv[1:]
    sup = Supervisor(
        train_argv, model_dir_from_argv(train_argv),
        min_stall_s=args.stall_timeout, stall_factor=args.stall_factor,
        startup_grace_s=args.startup_grace, max_restarts=args.max_restarts,
        stop_grace_s=args.stop_grace,
    )
    return sup.run()


def cmd_stop(args) -> int:
    """Write the one-shot STOP file the training loop polls; the run
    checkpoints at its next superstep boundary, consumes the file and
    exits 0 (under ``supervise``, a zero exit means done)."""
    stop_path = os.path.join(args.model_dir, "STOP")
    if not os.path.isdir(args.model_dir):
        print(f"model dir {args.model_dir} does not exist", flush=True)
        return 2
    with open(stop_path, "w") as f:
        f.write("requested by `gansynth_tpu_torch stop`\n")
    print(f"stop requested: wrote {stop_path}", flush=True)
    if not args.wait:
        return 0
    deadline = time.time() + args.wait
    while time.time() < deadline:
        if not os.path.exists(stop_path):
            print("stop honored (STOP file consumed by the run)")
            return 0
        time.sleep(1.0)
    print(f"STOP file still present after {args.wait:.0f}s: no live run is "
          "polling it (already stopped? wrong --model-dir?)")
    return 1


def cmd_fixtures(args) -> int:
    from gansynth_tpu_torch.data.fixtures import write_synthetic_tfrecords

    print(write_synthetic_tfrecords(args.output,
                                    num_examples=args.num_examples,
                                    seed=args.seed))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gansynth_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="progressive WGAN-GP training")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--data", nargs="*", help="NSynth TFRecord files")
    p.add_argument("--synthetic", action="store_true",
                   help="train on generated fixtures (smoke testing)")
    p.add_argument("--num-steps", type=int, default=None)
    p.add_argument("--data-parallel", action="store_true",
                   help="one process a card in a torch.distributed group "
                   "(NCCL), the global batch split over the ranks: starts "
                   "a worker per visible card, or joins a launcher's group")
    p.add_argument("--multihost", action="store_true",
                   help="join the group of a launcher (torchrun) on every "
                   "host; each process decodes its slice of the data")
    p.add_argument("--sample-every", type=int, default=0,
                   help="dump EMA-generator audio samples every N steps")
    p.add_argument("--ingest", default="native", choices=["tf", "native"],
                   help="TFRecord decode path: the native C++ reader (tf is "
                   "refused: no TensorFlow)")
    p.add_argument("--instrument-families", type=int, nargs="+",
                   default=None, metavar="ID",
                   help="keep only these NSynth instrument_family ids "
                   "(0..10)")
    p.add_argument("--mbstd", default="global",
                   choices=["global", "per-replica"],
                   help="minibatch-stddev batch semantics under data "
                   "parallelism: global-batch statistics (an all-gather "
                   "over the ranks) or each rank's own (no collective)")
    p.add_argument("--device-cache", action="store_true",
                   help="hold the whole decoded dataset on the device and "
                   "gather each step's batch there (stateless, resume-exact "
                   "data stream)")
    p.add_argument("--device-cache-layout", default="replicate",
                   choices=["replicate", "shard"],
                   help="placement of the --device-cache dataset across "
                   "ranks: a full copy each, or each rank N/W examples "
                   "(the batch gathered from their owners every step)")
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_train)

    _STAGE_HELP = ("generator stage to sample at; 'auto' takes the stage "
                   "in ema.npz, else the schedule's at the checkpoint step")

    p = sub.add_parser("generate", help="sample .wav files from a checkpoint")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--pitches", nargs="+", default=["60"],
                   help="MIDI pitches (24..84)")
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--stage", default="auto", help=_STAGE_HELP)
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_generate)

    p = sub.add_parser(
        "interpolate",
        help="render a latent morph (timbre) / pitch glide between two "
        "notes as per-step wavs + one crossfaded morph.wav")
    p.add_argument("--model-dir", default=None, help="run directory")
    p.add_argument("--from-exported", default=None, metavar="ART.gsx",
                   help="render from an artifact's latent program "
                   "(export-model --with-latent) instead of a run")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--pitch", type=int, default=60,
                   help="MIDI pitch (24..84) of the morph")
    p.add_argument("--pitch-b", type=int, default=None,
                   help="glide the conditioning to this pitch (default: "
                   "fixed --pitch; soft labels in between)")
    p.add_argument("--seed-a", type=int, default=0,
                   help="per-note seed of the starting latent")
    p.add_argument("--seed-b", type=int, default=1,
                   help="per-note seed of the ending latent")
    p.add_argument("--steps", type=int, default=9,
                   help="path length incl. endpoints")
    p.add_argument("--mode", choices=["slerp", "lerp"], default="slerp",
                   help="latent path: great circle (keeps shell-typical "
                   "norms) or straight chord")
    p.add_argument("--crossfade-ms", type=float, default=250.0,
                   help="equal-power crossfade between adjacent path notes "
                   "in morph.wav (0 = plain concatenation)")
    p.add_argument("--stage", default="auto", help=_STAGE_HELP)
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_interpolate)

    p = sub.add_parser("evaluate",
                       help="pitch-fidelity metrics from a checkpoint")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--pitches", nargs="+",
                   default=[str(p) for p in range(24, 85, 12)])
    p.add_argument("--samples-per-pitch", type=int, default=4)
    p.add_argument("--lsd-data", nargs="*", default=None,
                   help="TFRecords of real audio for the distribution "
                   "metrics' references (default: synthetic fixture notes; "
                   "the JSON's reference_set says which)")
    p.add_argument("--attribution", action="store_true",
                   help="add the per-note failure-attribution report: 95%% "
                   "CIs, detector-vs-model split, octave direction, "
                   "per-register and per-pitch tables")
    p.add_argument("--output", default=None,
                   help="also write the metrics JSON to this file")
    p.add_argument("--stage", default="auto", help=_STAGE_HELP)
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("serve", help="HTTP synthesis server (POST /synthesize)")
    p.add_argument("--model-dir", default=None,
                   help="run directory holding checkpoints/ or ema.npz, "
                   "and train_config.json (not needed with --from-exported)")
    p.add_argument("--from-exported", default=None, metavar="ART.gsx",
                   help="serve an export-model artifact (symbolic batch) "
                   "instead of a run: no checkpoint, no model flags")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--max-batch", type=int, default=16,
                   help="largest batch; with --data-parallel rounded up to "
                   "a multiple of the devices")
    p.add_argument("--data-parallel", action="store_true",
                   help="one EMA replica per visible card, each batch split "
                   "over them (every rung a multiple of the card count)")
    p.add_argument("--max-queue-notes", type=int, default=256,
                   help="queued notes beyond this get HTTP 429")
    p.add_argument("--request-timeout", type=float, default=30.0,
                   help="seconds before a request fails with HTTP 504")
    p.add_argument("--stage", default="auto", help=_STAGE_HELP)
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("roundtrip", help="wave -> mel-IF -> wave check")
    p.add_argument("--input", help="16 kHz mono wav (default: synthetic note)")
    p.add_argument("--pitch", type=int, default=60)
    p.add_argument("--output", help="write reconstructed wav here")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_roundtrip)

    p = sub.add_parser(
        "validate-data",
        help="real-data readiness gate: schema, pitch/family distributions, "
        "decode throughput against one card's demand, and one training "
        "superstep + spectral roundtrip on the files")
    p.add_argument("--data", nargs="+", required=True, metavar="TFRECORD")
    p.add_argument("--max-examples", type=int, default=2048,
                   help="examples to scan for schema/distribution checks")
    p.add_argument("--ingest", default="native",
                   choices=["tfdata", "native"],
                   help="decode path: the native reader (tfdata is refused: "
                   "no TensorFlow)")
    p.add_argument("--throughput-seconds", type=float, default=3.0,
                   help="sustained-decode measurement window")
    p.add_argument("--train-stage", type=int, default=2,
                   help="ladder stage of the one-superstep check")
    p.add_argument("--skip-train-check", action="store_true",
                   help="schema + throughput only (no device work)")
    p.add_argument("--output", default=None,
                   help="also write the report JSON to this file")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_validate_data)

    p = sub.add_parser("export-ema",
                       help="archive the EMA generator as a compact .npz")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--output", default=None,
                   help="output path (default: <model-dir>/ema.npz)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float16"],
                   help="storage dtype of the parameters (restore casts "
                   "back to float32)")
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_export_ema)

    p = sub.add_parser(
        "export-model",
        help="portable serving artifact: the EMA generator and the whole "
        "seeded synthesis as one torch.export file (.gsx)")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--output", default=None,
                   help="output path (default: <model-dir>/sampler.gsx)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="comma-separated devices the artifact may be loaded "
                   "on: cpu, cuda (the program is the same for both)")
    p.add_argument("--batch", type=int, default=None,
                   help="pin a static batch size (default: symbolic, any "
                   "batch size at call time)")
    p.add_argument("--with-latent", action="store_true",
                   help="also ship the latent program, for `interpolate "
                   "--from-exported` (~2x file size)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and hold its waves to the "
                   "in-process sampler's (relative L2 1e-3 in f32, 0.15 in "
                   "bf16)")
    p.add_argument("--stage", default="auto", help=_STAGE_HELP)
    _add_common_train_flags(p)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_export_model)

    p = sub.add_parser(
        "supervise",
        help="watchdog-wrapped training: restart from the latest "
        "checkpoint when the metrics heartbeat stalls or the child crashes")
    p.add_argument("--stall-timeout", type=float, default=300.0,
                   help="minimum seconds of heartbeat silence that count "
                   "as a stall")
    p.add_argument("--stall-factor", type=float, default=8.0,
                   help="stall limit = max(stall-timeout, factor x median "
                   "recent heartbeat interval)")
    p.add_argument("--startup-grace", type=float, default=1800.0,
                   help="seconds allowed before the first heartbeat")
    p.add_argument("--max-restarts", type=int, default=3)
    p.add_argument("--stop-grace", type=float, default=600.0,
                   help="on SIGTERM, seconds to wait for the child to "
                   "checkpoint and exit before killing it")
    p.add_argument("train_args", nargs=argparse.REMAINDER,
                   help="arguments forwarded to the train subcommand "
                   "(must include --model-dir); prefix with --")
    p.set_defaults(fn=cmd_supervise)

    p = sub.add_parser(
        "stop",
        help="gracefully stop a running train/supervise: checkpoint at "
        "the next superstep boundary, then exit 0 (no restart)")
    p.add_argument("--model-dir", required=True,
                   help="the running train's --model-dir")
    p.add_argument("--wait", type=float, default=0.0, metavar="SECONDS",
                   help="block until the run consumes the request "
                   "(0 = return immediately)")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("fixtures", help="write synthetic NSynth TFRecords")
    p.add_argument("--output", required=True)
    p.add_argument("--num-examples", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_fixtures)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    args.argv = argv   # what a spawned data-parallel worker runs again
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
