"""Where a synthesis batch, or a training step, spends its time on the card.

    python -m gansynth_tpu_torch.utils.profiling --batch 1 16
    python -m gansynth_tpu_torch.utils.profiling --train
    python -m gansynth_tpu_torch.utils.profiling --loop
    python -m gansynth_tpu_torch.utils.profiling --evaluate 8

Synthesis (``--batch B ...``): loads the run's EMA generator on the card
and, for each batch size, times the stages of one eager seeded synthesis
batch with CUDA events (the host latent draw and its copy to the card,
the generator, K1, the iSTFT, the copy of the waves back), traces a few
eager batches with ``torch.profiler`` (the kernels that take the most
device time, the device's idle share over the traced window), and then
holds the served form, the batch replayed from its CUDA graph, against
the eager batch in turns (eager, graph, graph, eager, ...): the host's
milliseconds per batch end to end (waves on the host), and from a trace
of each the device's busy milliseconds, its idle share and the CUDA API
launches a batch (``cudaLaunchKernel`` and the like, ``cudaGraphLaunch``).
One JSON object per batch size is printed to standard output.

``--train``: one WGAN-GP step of the run at its archived stage (the
released config, batch ``stage_batch_sizes[stage]``, G and EMA from
``ema.npz``, D seeded, fixture notes), with K2 and K3 (``conv_kernel`` /
``dblock_kernel`` = ``"pallas"``), with the plain lowerings (``"xla"``),
and with the plain lowerings under ``torch.backends.cudnn.benchmark``
(cuDNN times its algorithms and keeps the fastest; set for that run only),
in one process: the time of each of 12 steps after a warm-up with CUDA
events (median, least and most), then a ``torch.profiler`` trace of a few
steps with the device time of the step's phases (``frontend``,
``critic``, ``generator``, ``ema``, ``between``: from the starts of the
step's mark kernels, ``kernels/marks.py``), the kernels that take the
most device time and the idle share. One JSON object per run.

``--loop``: the training loop's cached superstep of ``unroll`` steps over
256 fixture notes held on the card (``train/step.py:
make_cached_superstep``, kernels on) taken two ways in one process, in
turns (eager, graph, graph, eager, ...): each step launched op by op,
and each step a replay of its CUDA graph. For each, the CUDA-event ms a
step and the host's time to return from the call (what it takes to
enqueue the steps, the noise and index draws included), median, least
and most over the repeats; from a ``torch.profiler`` trace of one
superstep, the device's busy ms a step and idle share, the CUDA API
launches a step and the host's CUDA runtime calls that take the most host
time (a ``cudaStreamSynchronize`` or ``cudaHostAlloc`` there is a step
waiting for the device); the graph's capture seconds and each form's
peak memory. One JSON object.

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
from typing import Callable, Dict, List

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
    """Milliseconds per batch of each stage of the eager seeded
    sampler."""
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum
    from gansynth_tpu_torch.ops.spectral import istft_rect
    from gansynth_tpu_torch.synth.random import seeded_latents
    from gansynth_tpu_torch.synth.sampler import (
        make_seeded_sampler,
        pitch_to_onehot,
    )

    device = next(generator.parameters()).device
    seeds, pitches = list(range(batch)), [60] * batch
    sample = make_seeded_sampler(config, generator, stage, graphs=False)
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
    """Device time by kernel name per eager batch over ``iters`` traced
    batches, and the device's idle share of the traced window's wall
    time."""
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

    sample = make_seeded_sampler(config, generator, stage, graphs=False)
    seeds, pitches = list(range(batch)), [60] * batch
    sample(seeds, pitches).cpu()
    return _trace(lambda: sample(seeds, pitches).cpu(), iters, top)


def spread(xs: List[float]) -> Dict[str, object]:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "all": xs}


def in_turns(fns: Dict[str, Callable], rounds: int,
             per: int = 1) -> Dict[str, Dict[str, List[float]]]:
    """Each of ``fns`` once a round, the order reversed every other round
    (a, b, b, a, ...): for every call, divided by the ``per`` units it
    runs, the CUDA-event ms from its first launch to the device's end
    (``ms``) and the host's ms until it returned (``host_ms``)."""
    names = list(fns)
    out = {k: {"ms": [], "host_ms": []} for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[k]()
            out[k]["host_ms"].append(1e3 * (time.perf_counter() - t0) / per)
            end.record()
            torch.cuda.synchronize()
            out[k]["ms"].append(start.elapsed_time(end) / per)
    return out


def busy(fn, per: int, wall_ms: float, calls: int = 1) -> Dict[str, object]:
    """From a trace of ``calls`` calls of ``fn``, each of ``per`` units:
    the device's busy ms a unit, its idle share against ``wall_ms`` (an
    untraced unit's time), the CUDA API launches a unit and the port's
    kernels that ran on the device a unit (:data:`PORT_KERNELS`)."""
    trace = _trace(fn, calls, 3)
    device_ms = trace["device_ms_per_call"] / per
    return {"device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
            "api_launches": {k: v / per for k, v in
                             trace["api_launches_per_call"].items()},
            "kernel_launches": {k: v / per for k, v in
                                trace["port_kernels_per_call"].items()}}


def kernel_launches(fn, calls: int = 1) -> Dict[str, float]:
    """The port's kernels that ran on the device a call of ``fn``, counted
    by name in a ``torch.profiler`` trace of ``calls`` calls (kernels that
    a CUDA graph replays included)."""
    return _trace(fn, calls, 0)["port_kernels_per_call"]


def graph_vs_eager(config, generator, stage: int, batch: int,
                   turns: int = 5, traced: int = 5) -> Dict[str, object]:
    """The seeded sampler's batch eager and replayed from its CUDA graph,
    ``turns`` rounds in turns: host ms a batch (waves on the host), and
    from ``traced`` traced batches of each the device's busy ms, idle
    share and API launches a batch."""
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

    seeds, pitches = list(range(batch)), [60] * batch
    forms = {"eager": make_seeded_sampler(config, generator, stage,
                                          graphs=False),
             "graph": make_seeded_sampler(config, generator, stage)}
    calls = {k: (lambda fn=fn: fn(seeds, pitches).cpu())
             for k, fn in forms.items()}
    for fn in calls.values():
        for _ in range(2):   # the graph's capture, then a warm replay
            fn()
    times = in_turns(calls, turns)
    return {k: {"host_ms": spread(times[k]["host_ms"]),
                **busy(fn, 1, statistics.median(times[k]["host_ms"]),
                       traced)}
            for k, fn in calls.items()}


# The port's kernels by the names of their device functions in
# kernels/csrc (each type and template instance): K1, K2, K3's forward,
# K4 (K4's forward, backward and the backward's bias sum: a backward that
# takes the bias's gradient runs two of them), and K3's backward kernels
# (the spread, the mask kernel and their bias sums: up to four a
# backward), apart from K3's forward, whose name its roofline counts; K5
# (its forward, contract, expand, and a contract's partials' sum).
PORT_KERNELS = {"synthesis_spectrum": "synthesis_spectrum_gather",
                "conv3x3": "conv3x3_nhwc_", "dblock": "dblock_nhwc_",
                "gen_epilogue": "gen_epilogue_",
                "dblock_grad": "dblock_grad_", "from_rgb": "from_rgb_",
                "conv1d_wgrad": "conv1d_wgrad_"}


def port_kernel(name: str):
    """The :data:`PORT_KERNELS` key of a traced kernel's ``name``, or
    None for any other kernel."""
    for key, function in PORT_KERNELS.items():
        if function in name:
            return key
    return None


def mark_spans(events) -> Dict[str, float]:
    """The training step's phases in a trace's ``events``, in its
    microseconds: for every two consecutive mark kernels
    (``kernels/marks.py``, device functions ``step_mark_<mark>``) in the
    marks' order, or an anchor and a mark, the time from the first one's
    start to the second's, added to the phase that the second ends
    (``between`` from an ``end`` to a ``start``)."""
    from gansynth_tpu_torch.kernels import marks

    cuda = torch.autograd.DeviceType.CUDA
    names = [*marks.MARKS, "anchor"]
    found = []
    for e in events:
        if e.device_type == cuda and "step_mark_" in e.name:
            for i, m in enumerate(names):
                if f"step_mark_{m}" in e.name:
                    found.append((e.time_range.start, i))
    found.sort()
    out = dict.fromkeys(marks.PHASES, 0.0)
    for (a, i), (b, j) in zip(found, found[1:]):
        if j < marks.ANCHOR and (i == marks.ANCHOR
                                 or j == (i + 1) % marks.ANCHOR):
            out[marks.PHASES[marks.phase_ended(j)]] += b - a
    return out


def _trace(fn, iters: int, top: int) -> Dict[str, object]:
    """``fn`` run ``iters`` times under ``torch.profiler``: per call, the
    device time by kernel, the device ms of each of the training step's
    phases (:func:`mark_spans`), the idle share of the traced window's
    wall time, and the host's CUDA API launch calls by name (kernel
    launches through the runtime or the driver, graph launches), and how
    often each of the port's kernels ran (by :func:`port_kernel`). Ranges
    on the device's timeline (``Optimizer.step#...``, user annotations)
    are spans, not kernels, and are kept out of the kernel sums."""
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
    launches: Dict[str, float] = {}
    port = dict.fromkeys(PORT_KERNELS, 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.key.startswith("cu") and ("LaunchKernel" in e.key
                                           or "GraphLaunch" in e.key):
                launches[e.key] = e.count / iters
            continue
        ms = e.device_time_total / 1e3 / iters
        if not (getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            kernels.append({"name": e.key[:90], "ms_per_call": ms,
                            "launches_per_call": e.count / iters})
            key = port_kernel(e.key)
            if key is not None:
                port[key] += e.count / iters
    kernels.sort(key=lambda k: -k["ms_per_call"])
    busy = sum(k["ms_per_call"] for k in kernels)
    return {
        "device_ms_per_call": busy,
        "wall_ms_per_call": wall_ms / iters,
        "idle_share": 1.0 - busy * iters / wall_ms if wall_ms else None,
        "phase_span_ms": {k: v / 1e3 / iters for k, v in
                          mark_spans(prof.events()).items()},
        "top_kernels": kernels[:top],
        "api_launches_per_call": launches,
        "port_kernels_per_call": port,
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
    """The cached superstep eager against its CUDA graph; see ``--loop``."""
    import copy

    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import state_from_ema
    from gansynth_tpu_torch.train.step import make_cached_superstep

    config = run_config(model_dir).released().with_overrides(
        {"model": {"conv_kernel": "pallas", "dblock_kernel": "pallas"},
         "train": {"unroll": unroll}})
    state = state_from_ema(config, f"{model_dir}/ema.npz", device)
    stage, alpha = schedule_from_config(config).stage_and_alpha(state.step)
    m = config.model
    batch = config.train.batch_for_stage(stage)
    waves, pitches = note_batch(256, m.pitch_min, m.pitch_max)
    all_waves = torch.from_numpy(waves).to(device)
    all_pitches = torch.from_numpy(pitches.astype("int32")).to(device)
    alphas = [alpha] * unroll
    states = {"eager": copy.deepcopy(state), "graph": state}
    steps = {"eager": make_cached_superstep(config, stage, 256,
                                            graphs=False),
             "graph": make_cached_superstep(config, stage, 256)}

    def run(kind):
        steps[kind](states[kind], all_waves, all_pitches, alphas)

    peak, first_s = {}, {}
    for kind in steps:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(kind)   # the graph's warm-up and capture, then its replays
        torch.cuda.synchronize()
        first_s[kind] = time.perf_counter() - t0
        peak[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
    times = in_turns({k: (lambda k=k: run(k)) for k in steps}, repeats,
                     unroll)
    out = {"stage": stage, "alpha": alpha, "batch": batch,
           "compute_dtype": m.compute_dtype, "unroll": unroll,
           "repeats": repeats}
    for kind in steps:
        ms = times[kind]["ms"]
        out[kind] = {
            "ms_per_step": spread(ms),
            "host_enqueue_ms_per_step": spread(times[kind]["host_ms"]),
            **busy(lambda: run(kind), unroll, statistics.median(ms)),
            "runtime_calls": _runtime_calls(lambda: run(kind)),
            "first_call_s": first_s[kind],
            "peak_mem_gib": peak[kind]}
    out["graph"]["capture_s"] = steps["graph"].program.graph.capture_seconds
    return out


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
                   help="the training loop's cached superstep eager "
                        "against its CUDA graph, in turns")
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
            "graph_vs_eager": graph_vs_eager(config, generator, stage,
                                             batch),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
