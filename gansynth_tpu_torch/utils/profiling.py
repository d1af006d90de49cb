"""Where a synthesis batch, or a training step, spends its time on the card.

    python -m gansynth_tpu_torch.utils.profiling --model-dir runs/flagship_r4
    python -m gansynth_tpu_torch.utils.profiling --train
    python -m gansynth_tpu_torch.utils.profiling --loop
    python -m gansynth_tpu_torch.utils.profiling --evaluate 8

Synthesis: loads the run's EMA generator on the card and, for each batch
size, times the stages of one seeded synthesis batch with CUDA events (the
host latent draw and its copy to the card, the generator, K1, the iSTFT,
the copy of the waves back), then traces a few batches with
``torch.profiler`` and prints the kernels that take the most device time
and the device's idle share over the traced window. One JSON object per
batch size is printed to standard output.

``--train``: one WGAN-GP step of the run at its archived stage (the
released config, batch ``stage_batch_sizes[stage]``, G and EMA from
``ema.npz``, D seeded, fixture notes), with K2 and K3 (``conv_kernel`` /
``dblock_kernel`` = ``"pallas"``), with the plain lowerings (``"xla"``),
and with the plain lowerings under ``torch.backends.cudnn.benchmark``
(cuDNN times its algorithms and keeps the fastest; set for that run only),
in one process: the time of each of 12 steps after a warm-up with CUDA
events (median, least and most), then a ``torch.profiler`` trace of a few
steps with the device time of the step's phases (``spectral_frontend``,
``discriminator_update``, ``generator_update``, ``ema_update``), the
kernels that take the most device time and the idle share. One JSON
object per run.

``--loop``: the same step (kernels on) taken two ways in one process, in
turns (single, superstep, superstep, single, ...): one step at a time
with a synchronize after each (as ``chip_smoke.py``'s phase 8 times it),
and the training loop's cached superstep of ``unroll`` steps over 256
fixture notes held on the card (``train/step.py:make_cached_superstep``).
For each, the CUDA-event ms a step (median, least and most over the
repeats); for the superstep also the host's time to return from the call
(what it takes to enqueue the steps, the noise and index draws included)
and, from a ``torch.profiler`` trace of one superstep, the device's idle
share and the host's CUDA runtime calls that take the most host time (a
``cudaStreamSynchronize`` or ``cudaHostAlloc`` there is a step waiting
for the device). One JSON object.

``--evaluate N``: ``cli evaluate`` on the run at its full width, the 61
pitches x ``N`` samples (seed 0, attribution, fixture references), in this
process: the command's wall seconds, its render's and its metrics' wall
seconds (the command's own line), notes rendered a second, the peak
device memory, and a ``torch.profiler`` trace of one round of the render
(61 notes: the device's busy time and idle share). Where
``tests/data/flagship_eval_ref.json`` holds the JAX package's metrics at
this ``N`` on the CPU, they and the relative differences ride along. One
JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict, List

import torch


def _event_ms(fn, iters: int) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``iters`` calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@torch.inference_mode()
def stage_times(config, generator, stage: int, batch: int,
                iters: int = 20) -> Dict[str, float]:
    """Milliseconds per batch of each stage of the seeded sampler."""
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum
    from gansynth_tpu_torch.ops.spectral import istft_rect
    from gansynth_tpu_torch.synth.random import seeded_latents
    from gansynth_tpu_torch.synth.sampler import (
        make_seeded_sampler,
        pitch_to_onehot,
    )

    device = next(generator.parameters()).device
    seeds, pitches = list(range(batch)), [60] * batch
    sample = make_seeded_sampler(config, generator, stage)
    for _ in range(3):
        sample(seeds, pitches)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(iters):
        z = torch.from_numpy(seeded_latents(seeds, config.model.latent_dim)
                             ).to(device)
    torch.cuda.synchronize()
    latent_ms = 1e3 * (time.perf_counter() - t0) / iters
    labels = pitch_to_onehot(torch.tensor(pitches, device=device), config)
    image = generator(z, labels, stage, 1.0).contiguous()
    re, im = synthesis_spectrum(image, config.audio)
    wave = istft_rect(re, im, config.audio)
    t0 = time.perf_counter()
    for _ in range(iters):
        wave.cpu()
    fetch_ms = 1e3 * (time.perf_counter() - t0) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        sample(seeds, pitches).cpu()
    total_ms = 1e3 * (time.perf_counter() - t0) / iters
    return {
        "host_latents_ms": latent_ms,
        "generator_ms": _event_ms(
            lambda: generator(z, labels, stage, 1.0), iters),
        "k1_ms": _event_ms(
            lambda: synthesis_spectrum(image, config.audio), iters),
        "istft_ms": _event_ms(lambda: istft_rect(re, im, config.audio), iters),
        "fetch_waves_ms": fetch_ms,
        "batch_end_to_end_ms": total_ms,
    }


@torch.inference_mode()
def top_kernels(config, generator, stage: int, batch: int, iters: int = 5,
                top: int = 12) -> Dict[str, object]:
    """Device time by kernel name per batch over ``iters`` traced batches,
    and the device's idle share of the traced window's wall time."""
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

    sample = make_seeded_sampler(config, generator, stage)
    seeds, pitches = list(range(batch)), [60] * batch
    sample(seeds, pitches).cpu()
    return _trace(lambda: sample(seeds, pitches).cpu(), iters, top)


PHASES = ("spectral_frontend", "discriminator_update", "generator_update",
          "ema_update")


def _trace(fn, iters: int, top: int) -> Dict[str, object]:
    """``fn`` run ``iters`` times under ``torch.profiler``: per call, the
    device time by kernel, the span of each step phase on the device's
    timeline (its ``record_function`` range), and the idle share of the
    traced window's wall time. Ranges on the device's timeline (the
    phases, ``Optimizer.step#...``) are spans, not kernels, and are kept
    out of the kernel sums."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels: List[Dict[str, object]] = []
    phases: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3 / iters
        if e.key in PHASES:
            phases[e.key] = ms
        elif not (getattr(e, "is_user_annotation", False)
                  or e.key.startswith("Optimizer.")):
            kernels.append({"name": e.key[:90], "ms_per_call": ms,
                            "launches_per_call": e.count / iters})
    kernels.sort(key=lambda k: -k["ms_per_call"])
    busy = sum(k["ms_per_call"] for k in kernels)
    return {
        "device_ms_per_call": busy,
        "wall_ms_per_call": wall_ms / iters,
        "idle_share": 1.0 - busy * iters / wall_ms if wall_ms else None,
        "phase_span_ms": phases,
        "top_kernels": kernels[:top],
    }


def train_step_profile(model_dir: str, kernels: str, device,
                       steps: int = 12, trace_steps: int = 2,
                       top: int = 15,
                       cudnn_benchmark: bool = False) -> Dict[str, object]:
    """One training step of the run with the given lowering of the 3x3
    convs and the stage-6 critic block: the CUDA-event ms of each of
    ``steps`` steps after two warm-up steps, and a trace of
    ``trace_steps``; ``cudnn_benchmark`` sets
    ``torch.backends.cudnn.benchmark`` for this run and restores it."""
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import state_from_ema
    from gansynth_tpu_torch.train.step import make_train_step

    config = run_config(model_dir).released().with_overrides(
        {"model": {"conv_kernel": kernels, "dblock_kernel": kernels}})
    state = state_from_ema(config, f"{model_dir}/ema.npz", device)
    stage, alpha = schedule_from_config(config).stage_and_alpha(state.step)
    m = config.model
    waves, pitches = note_batch(config.train.batch_for_stage(stage),
                                m.pitch_min, m.pitch_max)
    waves = torch.from_numpy(waves).to(device)
    pitches = torch.from_numpy(pitches).to(device)
    step_fn = make_train_step(config, stage)

    def one():
        step_fn(state, waves, pitches, alpha)

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = cudnn_benchmark
    try:
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = [_event_ms(one, 1) for _ in range(steps)]
        trace = _trace(one, trace_steps, top)
    finally:
        torch.backends.cudnn.benchmark = saved
    median = statistics.median(times)
    return {
        "kernels": kernels, "cudnn_benchmark": cudnn_benchmark,
        "stage": stage, "alpha": alpha,
        "batch": int(waves.shape[0]), "compute_dtype": m.compute_dtype,
        "step_ms_median": median, "step_ms_min": min(times),
        "step_ms_max": max(times), "step_ms": times,
        # the traced window's wall time carries the profiler's own host
        # cost; against the untraced step time the device's idle share is
        "idle_share_untraced": 1.0 - trace["device_ms_per_call"] / median,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "trace": trace,
    }


def loop_profile(model_dir: str, device, unroll: int = 10,
                 repeats: int = 4) -> Dict[str, object]:
    """Single steps against the cached superstep; see ``--loop``."""
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import state_from_ema
    from gansynth_tpu_torch.train.step import (
        make_cached_superstep,
        make_train_step,
    )

    config = run_config(model_dir).released().with_overrides(
        {"model": {"conv_kernel": "pallas", "dblock_kernel": "pallas"}})
    state = state_from_ema(config, f"{model_dir}/ema.npz", device)
    stage, alpha = schedule_from_config(config).stage_and_alpha(state.step)
    m = config.model
    batch = config.train.batch_for_stage(stage)
    waves, pitches = note_batch(256, m.pitch_min, m.pitch_max)
    all_waves = torch.from_numpy(waves).to(device)
    all_pitches = torch.from_numpy(pitches).to(device)
    step_fn = make_train_step(config, stage)
    superstep = make_cached_superstep(config, stage, 256)
    alphas = [alpha] * unroll

    def single():
        step_fn(state, all_waves[:batch], all_pitches[:batch], alpha)

    def fused():
        superstep(state, all_waves, all_pitches, alphas)

    for _ in range(2):
        single()
    fused()
    torch.cuda.synchronize()
    singles, fused_ms, enqueue_ms = [], [], []
    for r in range(repeats):
        for kind in (("single", "fused") if r % 2 == 0
                     else ("fused", "single")):
            if kind == "single":
                singles += [_event_ms(single, 1) for _ in range(unroll)]
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fused()
            enqueue_ms.append(1e3 * (time.perf_counter() - t0) / unroll)
            end.record()
            torch.cuda.synchronize()
            fused_ms.append(start.elapsed_time(end) / unroll)
    trace = _trace(fused, 1, 10)
    runtime = _runtime_calls(fused)

    def spread(xs):
        return {"median": statistics.median(xs), "min": min(xs),
                "max": max(xs), "all": xs}

    return {
        "stage": stage, "alpha": alpha, "batch": batch,
        "compute_dtype": m.compute_dtype, "unroll": unroll,
        "repeats": repeats,
        "single_step_ms": spread(singles),
        "superstep_ms_per_step": spread(fused_ms),
        "superstep_host_enqueue_ms_per_step": spread(enqueue_ms),
        "superstep_idle_share": 1.0 - trace["device_ms_per_call"] / (
            statistics.median(fused_ms) * unroll),
        "superstep_device_ms_per_step": trace["device_ms_per_call"] / unroll,
        "superstep_runtime_calls": runtime,
    }


def _runtime_calls(fn, top: int = 8) -> List[Dict[str, object]]:
    """The CUDA runtime and driver calls of one call of ``fn`` on the
    host, by host time: name, calls and ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = [{"name": e.key, "calls": e.count,
              "host_ms": e.self_cpu_time_total / 1e3}
             for e in prof.key_averages()
             if e.key.startswith(("cuda", "cu"))
             and e.device_type == torch.autograd.DeviceType.CPU]
    return sorted(calls, key=lambda c: -c["host_ms"])[:top]


EVAL_REF = "tests/data/flagship_eval_ref.json"
EVAL_COMPARED = ("pitch_accuracy", "pitch_accuracy_acf",
                 "pitch_accuracy_either", "rms", "log_spectral_distance_60db",
                 "frechet_mel_60db", "intra_pitch_diversity_60db",
                 "log_spectral_distance", "frechet_mel")


def evaluate_profile(model_dir: str, samples: int) -> Dict[str, object]:
    """``cli evaluate`` at the run's width with ``samples`` a pitch; see
    ``--evaluate`` in the module's docstring."""
    import contextlib
    import io
    import os
    import re

    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.synth.random import seed_to_key, split

    pitches = list(range(24, 85))
    out_dir = os.path.join("build", "profile_evaluate")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "eval.json")
    argv = ["evaluate", "--model-dir", model_dir, "--pitches",
            *map(str, pitches), "--samples-per-pitch", str(samples),
            "--seed", "0", "--attribution"]
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([*argv, "--output", out])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli evaluate exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = re.search(r"rendered (\d+) notes in ([0-9.]+) s, scored them in "
                  r"([0-9.]+) s", buf.getvalue())
    notes, render_s, score_s = int(m.group(1)), float(m.group(2)), \
        float(m.group(3))
    with open(out) as f:
        metrics = json.load(f)

    args = cli.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        sampler = cli._restore_sampler(args, cli._build_config(args))[0]
    _, sub = split(seed_to_key(0))
    sampler(sub, pitches)[0].cpu()
    trace = _trace(lambda: sampler(sub, pitches)[0].float().cpu(), 1, 8)
    result = {
        "samples_per_pitch": samples, "notes": notes,
        "command_wall_s": wall, "render_s": render_s,
        "metrics_s": score_s, "notes_per_s_render": notes / render_s,
        "render_share_of_command": render_s / wall,
        "peak_mem_gib": peak, "render_round_trace": trace,
        "metrics": {k: metrics[k] for k in EVAL_COMPARED},
    }
    if os.path.exists(EVAL_REF):
        with open(EVAL_REF) as f:
            ref = json.load(f)
        name = {ref["settings"]["samples_per_pitch"]: "metrics",
                ref["settings"]["samples_per_pitch_n8"]: "metrics_n8"}.get(
                    samples)
        if name:
            want = {k: ref[name][k] for k in EVAL_COMPARED}
            result["reference_cpu"] = want
            result["relative_diff"] = {
                k: abs(metrics[k] - v) / abs(v) if v else abs(metrics[k])
                for k, v in want.items()}
    return result


def main(argv=None) -> int:
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator
    from gansynth_tpu_torch.utils.device import (
        card_info,
        resolve_device,
        set_precision,
    )

    p = argparse.ArgumentParser(prog="gansynth_tpu_torch.utils.profiling")
    p.add_argument("--model-dir", default="runs/flagship_r4")
    p.add_argument("--batch", type=int, nargs="+", default=[1, 16])
    p.add_argument("--train", action="store_true",
                   help="profile one training step, with the kernels, "
                        "with the plain lowerings, and with the plain "
                        "lowerings under cudnn.benchmark")
    p.add_argument("--loop", action="store_true",
                   help="single steps against the training loop's cached "
                        "superstep, in turns")
    p.add_argument("--evaluate", type=int, default=None, metavar="N",
                   help="time cli evaluate at N samples a pitch")
    args = p.parse_args(argv)
    device = resolve_device("cuda")
    set_precision()
    if args.evaluate:
        print(json.dumps({"card": card_info(), "model_dir": args.model_dir,
                          **evaluate_profile(args.model_dir, args.evaluate)}),
              flush=True)
        return 0
    if args.loop:
        print(json.dumps({"card": card_info(), "model_dir": args.model_dir,
                          **loop_profile(args.model_dir, device)}),
              flush=True)
        return 0
    if args.train:
        card = card_info()
        for kernels, bench in (("pallas", False), ("xla", False),
                               ("xla", True)):
            print(json.dumps({"card": card, "model_dir": args.model_dir,
                              **train_step_profile(
                                  args.model_dir, kernels, device,
                                  cudnn_benchmark=bench)}), flush=True)
        return 0
    config = run_config(args.model_dir)
    generator, step, stage = load_ema_generator(
        f"{args.model_dir}/ema.npz", config.model, device)
    stage = config.model.num_stages - 1 if stage is None else stage
    card = card_info()
    for batch in args.batch:
        print(json.dumps({
            "card": card, "model_dir": args.model_dir, "step": step,
            "stage": stage, "compute_dtype": config.model.compute_dtype,
            "batch": batch,
            "stages": stage_times(config, generator, stage, batch),
            "trace": top_kernels(config, generator, stage, batch),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
