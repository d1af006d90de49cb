#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds (any failure
raises, so the exit code is non-zero):

1. the card's ``name, power.limit`` line from ``nvidia-smi``;
2. build the three kernels (K1 synthesis spectrum, K2 3x3 conv, K3 fused
   critic block) with plain ``nvcc``, one process each, all at once, and
   print their ``ptxas`` lines;
3. hold K1 to its plain PyTorch version on the card at every batch rung
   of the service, at the training loop's sample batch (``SAMPLE_BATCH``)
   and at the offline CLI's batches (``OFFLINE_BATCHES``: 8, 9, 61), and
   to its own bits over ``K1_REPEATS`` repeats; time
   the kernel, the plain version and the PyTorch library form with CUDA
   events: back-to-back eager calls (``ms``, as for K2 and K3) and the
   same calls replayed from a CUDA graph (``graph_ms``, the device's time
   with the host's cost of a call taken away);
4. hold K2 to ``F.conv2d`` (TF32 off) at every shape the stage-6 training
   step gives it, in bf16 and f32: the forward, and dx and dw through
   autograd; the forward at the generator's shapes in the training
   loop's sample dumps (``K2_SAMPLE_SHAPES``, timed too); a second-order
   (gradient-penalty) gradient at a small shape;
   time each shape in bf16; and, measured only, the C_in = 64 trunk conv
   of generator block 6 (``K2P_SHAPE``), which the routing gate keeps off
   the path as the reference's does;
5. hold K3 to the literal chain at the flagship shape [8, 128, 1024, 64]
   -> 128 in bf16 and f32, with first- and second-order gradients at
   batch 1, and time it in bf16;
6. render three flagship notes (``runs/flagship_r4``, bf16, stage 6)
   through the seeded sampler, and one note in float32 on the card
   against the same note on the CPU, ``F32_NOTE_RUNS`` times, each run
   also holding K1 to the plain version on its own image and that image
   to the CPU's; then the bf16 generator's image,
   with the convs on cuDNN and with K2, against the JAX package's image
   committed under ``tests/data``;
7. serving: the synthesis service with the flagship weights behind its
   HTTP server, answering 4 concurrent requests, then shut down (K1's
   launches are counted over this phase); each rung replays its CUDA
   graph, captured at the service's start;
8. training: the flagship config (``Config.released()``,
   ``conv_kernel="pallas"``, ``dblock_kernel="pallas"``) at stage 6,
   batch 8, G and EMA from ``ema.npz``, D from a seeded init, Adam fresh:
   one warm-up step (the step's CUDA graph is captured there), then 3
   steps (replays) timed with CUDA events, with K2's and K3's launches
   counted over the 3 steps, and one more step under ``torch.profiler``
   whose K2 and K3 kernels, counted by name on the device, must equal
   those counts a step; the metrics must be finite and both networks
   must move;
9. the same step in float32 from one state (so one drawn noise), once
   with the kernels and once with ``conv_kernel="xla"`` /
   ``dblock_kernel="xla"``, metric by metric;
10. the training entry point, ``cli train --synthetic --device-cache``,
    in this process, on a run directory under ``build/smoke_train/``:
    the flagship config with the kernels on and unroll, checkpoint, log
    and sample cadence 10, seeded with a port checkpoint of the
    flagship's state at step 415000 (stage 6, batch 8, bf16, released);
    each superstep replays the step's CUDA graph 10 times.
    Run A takes 20 steps with K1's, K2's and K3's launches counted (K1
    through the loop's sample dumps) and must write 2 checkpoints, an
    ``ema.npz`` at 415020, stage 6, and 3 wavs a dump; a repeat of run A
    and run B (the same 20 steps as two calls of 10, the second resuming
    at 415010) end in parameters whose distance B-vs-A is at most twice
    A-vs-repeat (0 and 0 where the step is deterministic); then ``cli
    train`` as a process of its own, with a STOP file present, must stop
    after one superstep with exit 0, consume the file and leave
    checkpoint 415010. One ``{"train_loop": ...}`` line: the loop's ms a
    step from ``steps_per_sec`` beside phase 8's mean, launches a step,
    peak memory and the card;
11. the offline CLI, through ``cli.main`` in this process on
    ``runs/flagship_r4``, writing only under ``build/smoke_offline/``,
    with K1's and K2's launches counted per command (every render replays
    its batch size's CUDA graph, the first at each size after the graph's
    warm-up): ``generate`` (3
    pitches x 2 samples: 6 wavs), ``interpolate`` (9 steps: 9 wavs and
    ``morph.wav``), ``evaluate`` (the 61 pitches x ``EVAL_SAMPLES``,
    attribution; held to the JAX package's ``evaluate_sampler`` on the
    CPU, committed in ``tests/data/flagship_eval_ref.json``: the pitch
    accuracies within ``EVAL_NOTES_BAR`` notes, the floored metrics and
    the RMS within ``EVAL_REL_BARS``; the render's and the metrics' wall
    seconds apart), ``roundtrip`` (its SNR within ``ROUNDTRIP_DB_BAR`` of
    the reference's) and ``validate-data`` on fixture TFRecords the port
    writes (``ok``, the superstep and the decode rate against one card's
    demand). One ``{"offline_cli": ...}`` line;
12. the portable serving artifact, under ``build/smoke_export/``: ``cli
    export-model --with-latent --check`` on the flagship (the check's
    relative L2 within its bf16 bound, 0.15; the file's MiB, seeded alone
    and with the latent program); the artifact loaded on the card with
    K1's count set to 0 just before, behind the HTTP server answering
    ``SERVE_REQUESTS`` (each reply within that bound of the in-process
    sampler's; the warm latency at rungs 1/4/16 beside an in-process
    service's; the same batches through the seeded program, the latent
    program fed the host's latents and the in-process sampler,
    ``EXPORT_TURNS`` calls in turns, their host-clock latency and their
    waves' gap); ``interpolate --from-exported`` (9 steps); the same
    artifact loaded on the CPU rendering one note within that bound of the
    card's; and a ``conv_kernel="pallas"`` export whose batch of 4 launches
    K2 and holds to the in-process sampler. One ``{"export": ...}`` line;
13. one JSON line with every kernel's launches on its path (and on the
    training loop's, the offline CLI's and the exported sampler's), error, times (K2 at every
    shape; the library call also under ``cudnn.benchmark``; the fraction
    of the bound reached) and its registers, spills and shared memory
    from ``ptxas``; the total seconds; and the result line;
14. data parallel, run before phase 13's line, which lists its launches
    (``dp_launches``, ``dp_graph_launches_traced_per_replay``,
    ``remat_launches``, ``remat_recompute_launches``):
    ``cli train --data-parallel --synthetic --device-cache`` on phase
    10's seed (the flagship at 415000, kernels on) for ``LOOP_CADENCE``
    steps, first as a process of its own (it starts one worker per card
    in an NCCL group), then with ``--device-cache-layout shard`` and with
    ``--mbstd per-replica`` through ``cli.main`` in an NCCL group of one
    rank set up here, K2's and K3's launches counted; every run replays
    the step's CUDA graph, collectives captured; each run's G, D and
    EMA at 415010 within twice phase 10's A-vs-repeat distance of run A
    there (0 where the step repeats to the bit). The card has one GPU, so
    the group has one rank; the multi-rank numerics are the CPU tests'
    (``tests/test_torch_parallel.py``, ``tests/test_torch_dp_graphs.py``).
    Then NCCL's version; a ``GRAPH_STEPS``-step cached superstep in the
    group under both cache layouts, graph against eager from one state (G,
    D and EMA at distance 0, the metrics equal); the stage-6 step in turns
    (``DP_TURNS``) as "no group, graph", "group, graph" and "group,
    eager", each with its peak memory and, from a trace of ``DP_TRACED``
    steps, the device's busy ms, its idle share, the API launches a step
    (one ``cudaGraphLaunch`` in the graphed forms) and K2 and K3 counted
    by name (69 and 4 a step); the all-reduces a step makes timed with
    CUDA events; the float32 stage-6 step with ``remat=True`` against
    ``remat=False`` from one state (eager):
    metric by metric (phase 9's bar), peak memory, ms a step and the
    recompute's launches; and ``serve --data-parallel`` on the flagship
    (``cli.make_service``): each request alone equal to the in-process
    service's reply, the 4 concurrent requests over HTTP within the bf16
    bound, K1 counted. One ``{"data_parallel": ...}`` line;
15. CUDA graphs, run before phase 13's line, which lists their launches
    (``graph_launches``, ``graph_launches_per_replay``): the flagship's
    seeded sampler in-process and from phase 12's artifact at rungs 1, 4
    and 16, each rung's graph against the same batch run eagerly (waves
    equal to the bit; the capture's seconds; K1's launches a replay, 1;
    host ms a batch, ``GRAPH_TURNS`` rounds in turns; at B=1 and B=16 the
    device's busy ms, its idle share, the CUDA API launches a batch and
    K1 counted by name on the device, once a batch in both forms, from
    ``torch.profiler``); the artifact is loaded once and its eager form
    runs the same loaded programs; the keyed sampler (the loop's dumps,
    ``generate``, ``interpolate``'s batch, ``evaluate``) at
    ``KEYED_RUNGS`` 3, 9 and 61 in the same way (wave and image equal to
    the bit, traced at 3 and 61); then a ``GRAPH_STEPS``-step cached
    superstep on the flagship's stage-6 state (bf16, K2 and K3 on,
    ``GRAPH_NOTES`` notes cached) as CUDA-graph replays and eagerly from
    one state: G, D and EMA at distance 0 and the metrics equal, K2's and
    K3's launches a step 69 and 4 in both, ms a step in
    ``GRAPH_TRAIN_TURNS`` rounds in turns of ``GRAPH_TURN_STEPS`` steps
    and the host's enqueue ms; from a trace of ``GRAPH_TRACED`` steps of
    each, the device's busy ms and idle share, the API launches a step
    (``cudaLaunchKernel``, ``cudaGraphLaunch``) and K2 and K3 counted by
    name on the device, 69 and 4 a step in both forms; peak memory and
    the capture's seconds. Each kernel's launches over the phase are
    counted for the graph and the eager form apart. One
    ``{"cuda_graphs": ...}`` line.

A replayed graph launches nothing through the wrappers: their counts add
what the capture counted at each replay (``kernels.add_launch_counts``).
Phases 8 and 15 hold those counts to the kernels that a
``torch.profiler`` trace of the replays shows ran on the device, by name
(``utils/profiling.py:PORT_KERNELS``): the step's graph (phase 8, and
the superstep's in phase 15, which phase 10's loop replays) and the
rungs' graphs at B=1 and 16 (phase 15, the in-process form that phase 7
serves and the artifact that phase 12 serves).

The script exits non-zero, printing no result, where CUDA is not
available or the port is not beside it. It writes nothing outside
``build/``.
"""

import concurrent.futures
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "runs", "flagship_r4")
F32_PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12   # H100 SXM, bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
MAX_BATCH = 16             # the service's top rung
KERNELS = ("synthesis_spectrum", "conv3x3", "dblock")
# (B, H, W, C_in, C_out) of every K2 launch in the stage-6 training step:
# the convs that pass conv3x3_eligible (critic blocks 5/4/3, generator
# conv1 of blocks 5/4/3) and, for 128 -> 256, its input gradient 256 -> 128.
K2_SHAPES = [
    (8, 64, 512, 128, 256),   # D block_5 conv1 (the headline shape)
    (8, 64, 512, 256, 128),   # its input gradient
    (8, 64, 512, 128, 128),   # D block_5 conv0, G block_5 conv1
    (8, 32, 256, 256, 256),   # D block_4 conv0/conv1, G block_4 conv1
    (8, 16, 128, 256, 256),   # D block_3 conv0/conv1, G block_3 conv1
]
# G block_6's trunk conv, C_in = 64: the reference's paired kernel
# (pallas_conv.py:_conv3x3_pallas_paired) computes it, and the gate keeps
# it off both packages' paths; K2 is checked and timed there, not counted.
K2P_SHAPE = (8, 128, 1024, 64, 64)
# The training loop's sample dumps render train.sample_pitches (three in
# the flagship's config) through the generator and K1, so K1 is checked at
# this batch too, and K2 at the generator convs it gates on at this batch
# (conv1 of blocks 5/4/3), forward only.
SAMPLE_BATCH = 3
K2_SAMPLE_SHAPES = [
    (SAMPLE_BATCH, 64, 512, 128, 128),   # G block_5 conv1
    (SAMPLE_BATCH, 32, 256, 256, 256),   # G block_4 conv1
    (SAMPLE_BATCH, 16, 128, 256, 256),   # G block_3 conv1
]
K3_SHAPE = (8, 128, 1024, 128)   # (B, H, W, C1): D block_6
# K1's batches on the offline CLI's path: validate-data's roundtrip (8),
# interpolate's 9-step path, evaluate's 61 pitches a round.
OFFLINE_BATCHES = (8, 9, 61)
OFFLINE_DIR = os.path.join(ROOT, "build", "smoke_offline")
EVAL_REF = os.path.join(ROOT, "tests", "data", "flagship_eval_ref.json")
EVAL_SAMPLES = 2   # samples a pitch of the offline phase's evaluate
TRAIN_STEPS = 3
LOOP_DIR = os.path.join(ROOT, "build", "smoke_train")
LOOP_STEPS = 20     # run A: two supersteps of LOOP_CADENCE
LOOP_CADENCE = 10   # unroll, checkpoint_every, log_every, sample_every
LOOP_NOTES = 256    # the fixture notes `cli train --synthetic` writes and
                    # caches (the flagship's cache held 2048)
F32_NOTE_RUNS = 4   # repeats of the f32 note, card vs CPU
K1_REPEATS = 10     # repeated K1 calls on one image, held to the same bits
T0 = time.perf_counter()


def phase(name: str, t_start: float, detail: str = "") -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {name}: "
          f"{time.perf_counter() - t_start:.2f}s {detail}".rstrip(),
          flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls,
    measured with CUDA events after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def autotuned_ms(fn, iters: int = 20) -> float:
    """``cuda_ms`` of ``fn`` with ``torch.backends.cudnn.benchmark`` on
    (cuDNN times its algorithms on the first calls and keeps the fastest),
    restored afterwards."""
    import torch

    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        return cuda_ms(fn, iters=iters, warmup=10)
    finally:
        torch.backends.cudnn.benchmark = saved


def wave_check(want, got, what: str):
    """The synthesis bar of the repo's kernel tests: max abs error below
    5e-3 and SNR above 40 dB. Returns (max_err, snr_db)."""
    err = (want - got).abs()
    max_err = float(err.max())
    noise = float((err.double() ** 2).sum())
    snr = 10 * math.log10(float((want.double() ** 2).sum()) / max(noise, 1e-30))
    if not (max_err < 5e-3 and snr > 40.0):
        raise AssertionError(f"{what}: wave max err {max_err:.3e}, "
                             f"SNR {snr:.1f} dB (bar 5e-3, 40 dB)")
    return max_err, snr


def library_spectrum(image, m2l, config):
    """The same function with PyTorch's library GEMM: both products in one
    batched ``torch.matmul`` (f32, TF32 off), the rest elementwise. Timed
    as a yardstick only; the port never calls it."""
    import torch

    a = (config.logmel_max - config.logmel_min) / 2.0
    b = (config.logmel_max + config.logmel_min) / 2.0
    e = torch.exp(image[..., 0] * a + b)
    p = torch.cumsum(image[..., 1] * math.pi, dim=-2)
    prod = torch.matmul(torch.stack((e, p)), m2l)
    mag = torch.sqrt(torch.clamp(prod[0], min=0.0) + config.logmel_eps)
    return mag * torch.cos(prod[1]), mag * torch.sin(prod[1])


def synthesis_bound(batch, m2l):
    """Least time for K1's function on these inputs: (bound_ms, bound_by).
    ``m2l`` is the banded mel pseudo-inverse, at most two nonzeros per
    column, so the function needs one FMA per nonzero and row in each of
    its two products, and reads m2l as its nonzeros (an f32 value and an
    int32 row index each)."""
    import torch

    rows, mel, freq = batch * 128, m2l.shape[0], m2l.shape[1]
    nnz = int(torch.count_nonzero(m2l))
    flops = 4.0 * rows * nnz             # two products, 2 operations per FMA
    nbytes = 4.0 * (rows * mel * 2 + 2 * rows * freq) + 8.0 * nnz
    t_ops, t_bytes = flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_synthesis_kernel(device, config, resources):
    """K1 against its plain version at every rung of the service's batch
    ladder (1, 4, 16), at the training loop's sample batch (SAMPLE_BATCH)
    and at the offline CLI's batches (OFFLINE_BATCHES); the B=16 times
    are the headline. ``resources`` (the kernel's ``ptxas`` report) goes
    into each rung's line."""
    import torch

    from gansynth_tpu_torch.kernels.synthesis import (
        synthesis_spectrum,
        synthesis_spectrum_plain,
    )
    from gansynth_tpu_torch.ops.spectral import istft_rect, mel_pinv
    from gansynth_tpu_torch.serve import batch_ladder
    from gansynth_tpu_torch.utils.kernel_ab import graph_ms

    m2l = mel_pinv(config, device)
    result = {"max_abs_err": 0.0, "rungs": []}
    for batch in sorted({*batch_ladder(MAX_BATCH), SAMPLE_BATCH,
                         *OFFLINE_BATCHES}):
        gen = torch.Generator(device=device).manual_seed(1000 + batch)
        image = torch.rand((batch, 128, 1024, 2), generator=gen,
                           device=device) * 2 - 1
        re, im = synthesis_spectrum(image, config)
        pre, pim = synthesis_spectrum_plain(image, config)
        torch.cuda.synchronize()
        err = max(float((re - pre).abs().max()), float((im - pim).abs().max()))
        if not err <= 2e-2:
            raise AssertionError(f"K1 B={batch}: spectrum max err {err:.3e} "
                                 "> 2e-2")
        # the kernel fixes every sum's order, so a repeat gives the same bits
        for _ in range(K1_REPEATS):
            re2, im2 = synthesis_spectrum(image, config)
            if not (torch.equal(re, re2) and torch.equal(im, im2)):
                raise AssertionError(f"K1 B={batch}: a repeated call on the "
                                     "same image gave other bits")
        wave_err, snr = wave_check(istft_rect(pre, pim, config),
                                   istft_rect(re, im, config),
                                   f"K1 B={batch}")
        lre, lim = library_spectrum(image, m2l, config)
        lib_err = max(float((lre - pre).abs().max()),
                      float((lim - pim).abs().max()))
        result["max_abs_err"] = max(result["max_abs_err"], err)
        # ms: back-to-back eager calls, as for K2 and K3 (where the device's
        # time is below the host's cost of a call, the host sets it);
        # graph_ms: the same calls replayed from a CUDA graph, the device's
        # time with the host's cost taken away
        times = {}
        for key, fn in (
                ("", lambda: synthesis_spectrum(image, config)),
                ("plain_", lambda: synthesis_spectrum_plain(image, config)),
                ("library_", lambda: library_spectrum(image, m2l, config))):
            times[f"{key}ms"] = cuda_ms(fn)
            times[f"{key}graph_ms"] = graph_ms(fn)
        bound_ms, bound_by = synthesis_bound(batch, m2l)
        times.update(bound_ms=bound_ms, bound_by=bound_by,
                     fraction_of_bound=bound_ms / times["ms"],
                     graph_fraction_of_bound=bound_ms / times["graph_ms"])
        row = {"batch": batch, "spectrum_max_abs_err": err,
               "wave_max_abs_err": wave_err, "wave_snr_db": snr,
               "library_max_abs_err": lib_err, **times}
        print(json.dumps({"k1_check": {**row, "resources": resources}}),
              flush=True)
        result["rungs"].append(row)
        if batch == MAX_BATCH:   # the headline
            result.update(times)
    return result


def close_err(got, want):
    """(max |got - want|, max(1, max |want|)): a check passes when the first
    is at most its bar times the second."""
    got, want = got.detach().float(), want.detach().float()
    err = float((got - want).abs().max())
    return err, max(1.0, float(want.abs().max()))


def require(err, ref, bar, what):
    if not err <= bar * ref:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {bar} * "
                             f"{ref:.3e}")


def randn(shape, device, seed, dtype, scale=1.0):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def bound(flops, nbytes, peak):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    and bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _demangle(mangled: str) -> str:
    """The function name (with an integer template argument, if any) of an
    Itanium-mangled kernel name such as ``_ZN..23conv3x3_nhwc_bf16_wgmmaILi
    256EEEv..``: the last length-prefixed component of its name."""
    import re

    rest = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = ""
    while True:
        m = re.match(r"(\d+)", rest)
        if not m:
            break
        n = int(m.group(1))
        name = rest[m.end():m.end() + n]
        rest = rest[m.end() + n:]
    t = re.match(r"ILi(\d+)E", rest)
    return f"{name}<{t.group(1)}>" if t else name


def ptxas_report(log: str):
    """Registers, spills and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": _demangle(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_store_bytes"] = int(m.group(1))
            cur["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(s.group(1)) if s else 0
    return out


# The times each kernel entry of the JSON line carries (K2: every shape).
TIMES = ("ms", "plain_ms", "library_ms", "library_ms_autotuned", "bound_ms",
         "bound_by", "fraction_of_bound")

# Bars: f32 within 1e-4 of the output's scale (tests/test_pallas_conv.py);
# bf16 within 3e-2, since both sides accumulate in f32 and round once to
# bf16 (an ulp is 2**-8 of the value) after sums taken in other orders.
# dw sums B*H*W products, so its f32 bar is 1e-3.
CONV_BARS = {"float32": (1e-4, 1e-4, 1e-3), "bfloat16": (3e-2, 3e-2, 3e-2)}


def conv_times(x, wt):
    """K2's bf16 times at x [B, H, W, C_in], wt [C_out, C_in, 3, 3]: the
    kernel, the plain version, ``F.conv2d`` (also under
    ``cudnn.benchmark``), the bound and the fraction of it reached."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_plain, conv3x3_same

    b, h, w, c_in = x.shape
    c_out = wt.shape[0]
    nbytes = 2.0 * (b * h * w * (c_in + c_out) + 9 * c_in * c_out)
    bound_ms, bound_by = bound(2.0 * b * h * w * 9 * c_in * c_out, nbytes,
                               BF16_PEAK_FLOPS)

    def library():
        return torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), wt,
                                          padding=1)

    out = {"ms": cuda_ms(lambda: conv3x3_same(x, wt), iters=20),
           "plain_ms": cuda_ms(lambda: conv3x3_plain(x, wt), iters=20),
           "library_ms": cuda_ms(library, iters=20),
           "library_ms_autotuned": autotuned_ms(library),
           "bound_ms": bound_ms, "bound_by": bound_by}
    out["fraction_of_bound"] = bound_ms / out["ms"]
    return out


def check_conv_kernel(device):
    """K2 against F.conv2d at every shape of the training step, both
    types; the forward at the sample dumps' shapes; the second order at a
    small shape; bf16 times at every shape."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_plain, conv3x3_same

    result = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "shapes": [],
              "sample_shapes": []}
    for shape in K2_SHAPES:
        b, h, w, c_in, c_out = shape
        row = {"shape": list(shape)}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            bars = CONV_BARS[name]
            x = randn((b, h, w, c_in), device, 1, dtype).requires_grad_()
            wt = randn((c_out, c_in, 3, 3), device, 2, dtype,
                       (9 * c_in) ** -0.5).requires_grad_()
            r = randn((b, h, w, c_out), device, 3, dtype)
            y = conv3x3_same(x, wt)
            gx, gw = torch.autograd.grad((y * r).sum(), (x, wt))
            y_p = conv3x3_plain(x, wt)
            gx_p, gw_p = torch.autograd.grad((y_p * r).sum(), (x, wt))
            torch.cuda.synchronize()
            errs = {}
            for what, got, want, bar in (("y", y, y_p, bars[0]),
                                         ("dx", gx, gx_p, bars[1]),
                                         ("dw", gw, gw_p, bars[2])):
                err, ref = close_err(got, want)
                require(err, ref, bar, f"K2 {name} {shape} {what}")
                errs[what] = err
            row[name] = errs
            key = "max_abs_err" if name == "bfloat16" else "max_abs_err_f32"
            result[key] = max(result[key], errs["y"])
            if dtype == torch.bfloat16:
                row.update(conv_times(x.detach(), wt.detach()))
            del x, wt, r, y, gx, gw, y_p, gx_p, gw_p
        print(json.dumps({"k2_check": row}), flush=True)
        result["shapes"].append(row)

    for shape in K2_SAMPLE_SHAPES:
        b, h, w, c_in, c_out = shape
        row = {"shape": list(shape)}
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x = randn((b, h, w, c_in), device, 7, dtype)
            wt = randn((c_out, c_in, 3, 3), device, 8, dtype,
                       (9 * c_in) ** -0.5)
            err, ref = close_err(conv3x3_same(x, wt), conv3x3_plain(x, wt))
            require(err, ref, CONV_BARS[name][0],
                    f"K2 {name} {shape} y (sample dumps)")
            row[name] = {"y": err}
            key = "max_abs_err" if name == "bfloat16" else "max_abs_err_f32"
            result[key] = max(result[key], err)
            if dtype == torch.bfloat16:
                row.update(conv_times(x, wt))
        print(json.dumps({"k2_check": row}), flush=True)
        result["sample_shapes"].append(row)

    # The WGAN-GP shape: d/dw of ||d(sum conv(x, w) r)/dx||^2 (f32, 1e-3).
    x = randn((2, 8, 16, 16), device, 4, torch.float32).requires_grad_()
    r = randn((2, 8, 16, 24), device, 5, torch.float32)
    wt = randn((24, 16, 3, 3), device, 6, torch.float32, 0.1)
    wt.requires_grad_()

    def gp(fn):
        gx = torch.autograd.grad((fn(x, wt) * r).sum(), x,
                                 create_graph=True)[0]
        return torch.autograd.grad((gx ** 2).sum(), wt)[0]

    err, ref = close_err(gp(conv3x3_same), gp(conv3x3_plain))
    require(err, ref, 1e-3, "K2 second order")
    result["second_order_err"] = err
    result["measured_only"] = check_conv_off_path(device, K2P_SHAPE)
    result.update({k: result["shapes"][0][k] for k in TIMES})
    result["shape"] = result["shapes"][0]["shape"]
    return result


def check_conv_off_path(device, shape):
    """K2 at a shape the gate keeps off the path: the forward against
    ``F.conv2d`` in bf16 and f32, and the bf16 times. Its launches are not
    counted anywhere."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_plain, conv3x3_same

    b, h, w, c_in, c_out = shape
    row = {"shape": list(shape)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = randn((b, h, w, c_in), device, 1, dtype)
        wt = randn((c_out, c_in, 3, 3), device, 2, dtype, (9 * c_in) ** -0.5)
        err, ref = close_err(conv3x3_same(x, wt), conv3x3_plain(x, wt))
        require(err, ref, CONV_BARS[name][0], f"K2 {name} {shape} y")
        row[name] = {"y": err}
    row.update(conv_times(x, wt))   # x, wt: the bf16 pair, made last
    print(json.dumps({"k2_check": {**row, "measured_only": True}}), flush=True)
    return row


def check_dblock_kernel(device):
    """K3 against the literal chain at the flagship shape, both types;
    first and second order at batch 1; bf16 times."""
    import torch

    from gansynth_tpu_torch.kernels.dblock import dblock_plain, fused_dblock

    b, h, w, c1 = K3_SHAPE
    result = {"shape": [b, h, w, 64, c1]}

    def inputs(batch, dtype, seed=10):
        return [randn((batch, h, w, 64), device, seed, dtype),
                randn((64, 64, 3, 3), device, seed + 1, torch.float32, 0.06),
                randn((64,), device, seed + 2, torch.float32, 0.1),
                randn((c1, 64, 3, 3), device, seed + 3, torch.float32, 0.06),
                randn((c1,), device, seed + 4, torch.float32, 0.1)]

    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        bar = 1e-5 if dtype == torch.float32 else 3e-2
        gbar = 1e-4 if dtype == torch.float32 else 3e-2
        args = inputs(b, dtype)
        err, ref = close_err(fused_dblock(*args, 0.2),
                             dblock_plain(*args, 0.2))
        require(err, ref, bar, f"K3 {name} forward")
        row = {"y": err}
        if dtype == torch.bfloat16:
            nbytes = 2.0 * (b * h * w * 64 + b * h * w // 4 * c1
                            + 9 * 64 * (64 + c1) + 64 + c1)
            bound_ms, bound_by = bound(
                2.0 * b * h * w * 9 * 64 * (64 + c1), nbytes, BF16_PEAK_FLOPS)
            result.update(
                ms=cuda_ms(lambda: fused_dblock(*args, 0.2), iters=20),
                plain_ms=cuda_ms(lambda: dblock_plain(*args, 0.2), iters=20),
                library_ms=cuda_ms(lambda: dblock_plain(*args, 0.2),
                                   iters=20),
                library_ms_autotuned=autotuned_ms(
                    lambda: dblock_plain(*args, 0.2)),
                bound_ms=bound_ms, bound_by=bound_by)
            result["fraction_of_bound"] = bound_ms / result["ms"]
        del args
        # first order (fixed cotangent) and the GP second order, batch 1
        small = [a.requires_grad_() for a in inputs(1, dtype, seed=30)]
        r = randn((1, h // 2, w // 2, c1), device, 40, dtype)
        g_k = torch.autograd.grad((fused_dblock(*small, 0.2) * r).sum(), small)
        g_p = torch.autograd.grad((dblock_plain(*small, 0.2) * r).sum(), small)
        row["grad"] = 0.0
        for i, (a, b_) in enumerate(zip(g_k, g_p)):
            err, ref = close_err(a, b_)
            require(err, ref, gbar, f"K3 {name} first order, input {i}")
            row["grad"] = max(row["grad"], err)

        def gp(fn):
            gx = torch.autograd.grad(fn(*small, 0.2).sum(), small[0],
                                     create_graph=True)[0]
            return torch.autograd.grad((gx.float() ** 2).sum(), small[1])[0]

        err, ref = close_err(gp(fused_dblock), gp(dblock_plain))
        require(err, ref, gbar, f"K3 {name} second order")
        row["second_order"] = err
        result[name] = row
    torch.cuda.synchronize()
    result["max_abs_err"] = result["bfloat16"]["y"]
    result["max_abs_err_f32"] = result["float32"]["y"]
    print(json.dumps({"k3_check": result}), flush=True)
    return result


def training_config(dtype=None, kernels="pallas"):
    """The flagship's config after the release step, with the kernels
    switched on (or off) and, optionally, another compute type."""
    from gansynth_tpu_torch.cli import run_config

    model = {"conv_kernel": kernels, "dblock_kernel": kernels}
    if dtype is not None:
        model["compute_dtype"] = dtype
    return run_config(FLAGSHIP).released().with_overrides({"model": model})


def training_setup(config, device):
    """The state (G and EMA from ``ema.npz``, D seeded, Adam fresh), the
    stage and alpha at the archive's step, and a batch of fixture notes."""
    import torch

    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.schedule import schedule_from_config
    from gansynth_tpu_torch.train.state import state_from_ema

    state = state_from_ema(config, os.path.join(FLAGSHIP, "ema.npz"), device)
    stage, alpha = schedule_from_config(config).stage_and_alpha(state.step)
    m = config.model
    waves, pitches = note_batch(config.train.batch_for_stage(stage),
                                m.pitch_min, m.pitch_max)
    return (state, stage, alpha, torch.from_numpy(waves).to(device),
            torch.from_numpy(pitches).to(device))


def flat_params(module):
    import torch

    return torch.cat([p.detach().float().reshape(-1)
                      for p in module.parameters()])


def train_steps(device):
    """The slice-2 path: 1 warm-up step, then TRAIN_STEPS timed steps with
    K2's and K3's launches counted, then one traced step whose kernels,
    counted by name, must agree."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock
    from gansynth_tpu_torch.train.step import make_train_step
    from gansynth_tpu_torch.utils.profiling import kernel_launches

    config = training_config()
    state, stage, alpha, waves, pitches = training_setup(config, device)
    step_fn = make_train_step(config, stage)
    step_fn(state, waves, pitches, alpha)
    torch.cuda.synchronize()
    g0, d0 = flat_params(state.g), flat_params(state.d)

    conv3x3_same.launches.update(forward=0, input_grad=0)
    fused_dblock.launches = 0
    times, metrics = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        _, m = step_fn(state, waves, pitches, alpha)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        metrics.append({k: float(v) for k, v in m.items()})
    launches = {"conv3x3_forward": conv3x3_same.launches["forward"],
                "conv3x3_input_grad": conv3x3_same.launches["input_grad"],
                "dblock": fused_dblock.launches}
    bad = [k for k, v in launches.items() if v == 0]
    if bad:
        raise AssertionError(f"the training step never launched {bad}")
    # The counts above add a capture's counts at each replay; one more
    # replay under torch.profiler counts the kernels that ran by name.
    traced = kernel_launches(lambda: step_fn(state, waves, pitches, alpha))
    counted = {"conv3x3": (launches["conv3x3_forward"]
                           + launches["conv3x3_input_grad"]) / TRAIN_STEPS,
               "dblock": launches["dblock"] / TRAIN_STEPS}
    if any(traced[k] != v for k, v in counted.items()):
        raise AssertionError(f"kernels a step: traced {traced}, counted "
                             f"{counted}")
    for m in metrics:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite metrics: {m}")
    g_move = float((flat_params(state.g) - g0).abs().max())
    d_move = float((flat_params(state.d) - d0).abs().max())
    if not (g_move > 0 and d_move > 0):
        raise AssertionError(f"parameters did not move: G {g_move}, "
                             f"D {d_move}")
    out = {"stage": stage, "alpha": alpha, "batch": int(waves.shape[0]),
           "compute_dtype": config.model.compute_dtype,
           "step_ms": times, "mean_step_ms": sum(times) / len(times),
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS
                                 for k, v in launches.items()},
           "launches_traced_per_step": {k: traced[k] for k in counted},
           "g_max_move": g_move, "d_max_move": d_move,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "metrics": metrics}
    print(json.dumps({"train": out}), flush=True)
    return out


def loop_seed():
    """``build/smoke_train/seed``: ``train_config.json`` (the flagship's,
    kernels on, cadence LOOP_CADENCE), the fixture TFRecords ``cli train
    --synthetic`` would write, and a port checkpoint of
    ``state_from_ema(ema.npz)`` at step 415000."""
    import dataclasses

    import torch

    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.data.fixtures import write_synthetic_tfrecords
    from gansynth_tpu_torch.train.state import state_from_ema
    from gansynth_tpu_torch.utils.checkpoint import Checkpointer

    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    seed = os.path.join(LOOP_DIR, "seed")
    os.makedirs(seed)
    config = run_config(FLAGSHIP).with_overrides({
        "model": {"conv_kernel": "pallas", "dblock_kernel": "pallas"},
        "train": {k: LOOP_CADENCE for k in ("unroll", "checkpoint_every",
                                            "log_every", "sample_every")}})
    with open(os.path.join(seed, "train_config.json"), "w") as f:
        json.dump(dataclasses.asdict(config), f, indent=2, sort_keys=True)
    write_synthetic_tfrecords(os.path.join(seed, "fixtures.tfrecord"),
                              num_examples=LOOP_NOTES,
                              seed=config.train.seed)
    state = state_from_ema(config, os.path.join(FLAGSHIP, "ema.npz"), "cuda")
    if state.step != 415000:
        raise AssertionError(f"the seed state is at step {state.step}")
    Checkpointer(os.path.join(seed, "checkpoints")).save(state.step, state)
    del state
    torch.cuda.empty_cache()
    return config


def loop_dir(name):
    """A fresh copy of the seed run directory."""
    path = os.path.join(LOOP_DIR, name)
    shutil.copytree(os.path.join(LOOP_DIR, "seed"), path)
    return path


def loop_argv(run, steps):
    return ["train", "--model-dir", run, "--synthetic", "--device-cache",
            "--num-steps", str(steps), "--config",
            os.path.join(run, "train_config.json")]


def loop_params(run, step):
    """G, D and EMA of checkpoint ``step`` as three flat float32 vectors."""
    import torch

    payload = torch.load(os.path.join(run, "checkpoints", str(step),
                                      "state.pt"),
                         map_location="cuda", weights_only=True)
    return {net: torch.cat([v.float().reshape(-1)
                            for v in payload[net].values()])
            for net in ("g", "d", "ema")}


def loop_metrics(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def train_loop(card, single_step_ms):
    """The flagship's training entry point, ``cli train --synthetic
    --device-cache``, through ``cli.main`` in this process and as a
    process of its own; see phase 10 in the docstring."""
    import numpy as np
    import torch

    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum

    config = loop_seed()
    if len(config.train.sample_pitches) != SAMPLE_BATCH:
        raise AssertionError("K1 and K2 were checked at the sample batch "
                             f"{SAMPLE_BATCH}, the loop renders "
                             f"{len(config.train.sample_pitches)} pitches")
    start, end = 415000, 415000 + LOOP_STEPS
    mid = start + LOOP_CADENCE

    run_a = loop_dir("a")
    torch.cuda.reset_peak_memory_stats()
    synthesis_spectrum.launches = 0
    conv3x3_same.launches.update(forward=0, input_grad=0)
    fused_dblock.launches = 0
    t = time.perf_counter()
    if cli.main(loop_argv(run_a, LOOP_STEPS)) != 0:
        raise AssertionError("cli train (run A) failed")
    torch.cuda.synchronize()
    run_a_s = time.perf_counter() - t
    launches = {"synthesis_spectrum": synthesis_spectrum.launches,
                "conv3x3_forward": conv3x3_same.launches["forward"],
                "conv3x3_input_grad": conv3x3_same.launches["input_grad"],
                "dblock": fused_dblock.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    bad = [k for k, v in launches.items() if v == 0]
    if bad:
        raise AssertionError(f"the training loop never launched {bad}")

    ckpts = sorted(int(p) for p in os.listdir(os.path.join(run_a,
                                                           "checkpoints"))
                   if p.isdigit())
    if ckpts != [start, mid, end]:
        raise AssertionError(f"run A's checkpoints: {ckpts}")
    with np.load(os.path.join(run_a, "ema.npz")) as z:
        ema_meta = (int(z["__step__"]), int(z["__stage__"]))
    if ema_meta != (end, 6):
        raise AssertionError(f"run A's ema.npz is (step, stage) {ema_meta}")
    wavs = sorted(os.listdir(os.path.join(run_a, "samples")))
    for step in (mid, end):
        got = [w for w in wavs if w.startswith(f"step{step:08d}_")]
        if len(got) != len(config.train.sample_pitches):
            raise AssertionError(f"samples at {step}: {got}")
    records = loop_metrics(run_a)
    if [r["step"] for r in records] != [mid, end]:
        raise AssertionError(f"run A logged {records}")
    for r in records:
        if r["stage"] != 6 or not all(math.isfinite(v) for v in r.values()):
            raise AssertionError(f"run A's metrics: {r}")

    run_r = loop_dir("a_repeat")
    if cli.main(loop_argv(run_r, LOOP_STEPS)) != 0:
        raise AssertionError("cli train (repeat of run A) failed")
    run_b = loop_dir("b")
    for _ in range(2):
        if cli.main(loop_argv(run_b, LOOP_CADENCE)) != 0:
            raise AssertionError("cli train (run B) failed")
    records_b = loop_metrics(run_b)
    if [r["step"] for r in records_b] != [mid, end]:
        raise AssertionError(f"run B logged {records_b}")
    a, rep, b = (loop_params(r, end) for r in (run_a, run_r, run_b))
    a_vs_repeat = {k: float((a[k] - rep[k]).abs().max()) for k in a}
    b_vs_a = {k: float((b[k] - a[k]).abs().max()) for k in a}
    for k in a:
        if not b_vs_a[k] <= 2 * a_vs_repeat[k]:
            raise AssertionError(
                f"resumed run B differs from run A by {b_vs_a} (max abs), "
                f"more than twice the repeat's {a_vs_repeat}")
    del a, rep, b
    # what phase 14's data-parallel runs are held to: run A at `mid`, and
    # how far a repeat of it lands there
    a_mid = {k: v.cpu() for k, v in loop_params(run_a, mid).items()}
    rep_mid = loop_params(run_r, mid)
    a_vs_repeat_mid = {k: float((a_mid[k] - rep_mid[k].cpu()).abs().max())
                       for k in a_mid}
    del rep_mid
    torch.cuda.empty_cache()

    run_s = loop_dir("stop")
    with open(os.path.join(run_s, "STOP"), "w") as f:
        f.write("requested by chip_smoke.py\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gansynth_tpu_torch.cli",
         *loop_argv(run_s, 2 * LOOP_STEPS)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    stop_s = time.perf_counter() - t
    ckpts = sorted(int(p) for p in os.listdir(os.path.join(run_s,
                                                           "checkpoints"))
                   if p.isdigit())
    if (proc.returncode != 0 or os.path.exists(os.path.join(run_s, "STOP"))
            or ckpts != [start, mid]
            or "graceful stop" not in proc.stdout):
        raise AssertionError(
            f"STOP run: exit {proc.returncode}, checkpoints {ckpts}\n"
            f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")

    # the host's share of an inner step: its noise and its batch indices
    # (threefry in numpy), 100 steps each
    from gansynth_tpu_torch.train.state import train_key
    from gansynth_tpu_torch.train.step import cached_batch_indices, step_noise

    rng, batch = train_key(config.train.seed), config.train.batch_for_stage(6)
    t = time.perf_counter()
    for i in range(100):
        step_noise(rng, start + i, batch, config.model.latent_dim)
    noise_ms = (time.perf_counter() - t) * 10
    t = time.perf_counter()
    for i in range(100):
        cached_batch_indices(rng, start + i, batch, LOOP_NOTES)
    indices_ms = (time.perf_counter() - t) * 10

    per_step = {k: v / LOOP_STEPS for k, v in launches.items()}
    out = {
        "steps": LOOP_STEPS, "unroll": LOOP_CADENCE,
        "batch": config.train.batch_for_stage(6),
        "compute_dtype": config.model.compute_dtype,
        "run_a_seconds": run_a_s,
        "steps_per_sec": [r["steps_per_sec"] for r in records],
        "ms_per_step": [1000.0 / r["steps_per_sec"] for r in records],
        "ms_per_step_resumed_call": 1000.0 / records_b[1]["steps_per_sec"],
        "single_step_mean_ms": single_step_ms,
        "host_noise_ms_per_step": noise_ms,
        "host_indices_ms_per_step": indices_ms,
        "launches": launches, "launches_per_step": per_step,
        "b_vs_a_max_abs": b_vs_a, "a_vs_repeat_max_abs": a_vs_repeat,
        "ema_npz": {"step": ema_meta[0], "stage": ema_meta[1]},
        "stop_process_seconds": stop_s,
        "peak_mem_gib": peak_gib, "cached_notes": LOOP_NOTES, "card": card,
    }
    print(json.dumps({"train_loop": out}), flush=True)
    for name in ("a", "a_repeat", "b", "stop"):   # phase 14 takes the seed
        shutil.rmtree(os.path.join(LOOP_DIR, name))
    return out, {"params_mid": a_mid, "a_vs_repeat_mid": a_vs_repeat_mid}


# The offline phase's evaluate against the JAX package's on the CPU
# (EVAL_REF): the pitch accuracies within EVAL_NOTES_BAR notes of the
# 122, and these metrics within their relative bars. The port's own CPU
# run of the same 122 notes (the file's port_cpu_metrics) differs from
# the reference's by 8.9e-4 (rms), 6.2e-4 (lsd 60 dB), 7.3e-4 (Frechet
# 60 dB) and 1.37e-3 (diversity 60 dB), and by 0 notes in the three
# accuracies. On the card (cuDNN's bf16 convs, K1) the first run read
# 2.8e-4, 3.7e-3, 9.5e-3 and 6.8e-3 (NVIDIA H100 80GB HBM3, 700.00 W):
# 0.3-13x the CPU's. The bars were set at 5-8x the CPU's differences
# before that run; three of them hold. The Frechet
# distance does not: 122 notes in 128 feature dimensions leave its
# covariances rank-deficient, and the square root of their near-zero
# eigenvalues magnifies small changes (at 488 notes the card reads
# 5.5e-4, `utils/profiling.py --evaluate 8`), so its bar is 3e-2, 3x the
# card's reading. The reference's own 122 and 488 notes (other latents)
# differ by 14 % in Frechet and 5 % in diversity, above their bars; the
# render repeats to the bit across calls on the card.
EVAL_NOTES_BAR = 2
EVAL_ACCURACIES = ("pitch_accuracy", "pitch_accuracy_acf",
                   "pitch_accuracy_either")
EVAL_REL_BARS = {"rms": 5e-3, "log_spectral_distance_60db": 5e-3,
                 "frechet_mel_60db": 3e-2, "intra_pitch_diversity_60db": 1e-2}
# The raw (unfloored) distances are printed, not barred: the silence
# floor dominates them (DESIGN.md section 4c).
EVAL_UNBARRED = ("log_spectral_distance", "frechet_mel")
ROUNDTRIP_DB_BAR = 0.5


def offline_cli(card):
    """The offline render-and-score tools through ``cli.main`` in this
    process on ``runs/flagship_r4``, writing under ``build/smoke_offline/``;
    see phase 11 in the docstring."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum
    from gansynth_tpu_torch.utils.audio_io import read_wav

    with open(EVAL_REF) as f:
        ref = json.load(f)
    pitches = list(range(24, 85))
    want = {"model_dir": "runs/flagship_r4", "pitches": pitches, "seed": 0,
            "samples_per_pitch": EVAL_SAMPLES, "reference_set": "fixture",
            "attribution": True}
    got = {k: ref["settings"][k] for k in want}
    if got != want:
        raise AssertionError(f"{EVAL_REF} was made with {got}, not {want}")
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    os.makedirs(OFFLINE_DIR)
    out = {k: os.path.join(OFFLINE_DIR, k)
           for k in ("generate", "interpolate")}
    eval_json = os.path.join(OFFLINE_DIR, "eval.json")
    report_json = os.path.join(OFFLINE_DIR, "validate.json")
    notes = os.path.join(OFFLINE_DIR, "fixtures.tfrecord")
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["fixtures", "--output", notes, "--num-examples", "64",
                     "--seed", "0"]) != 0:
            raise AssertionError("cli fixtures failed")
    runs = {
        "generate": ["generate", "--model-dir", FLAGSHIP, "--output-dir",
                     out["generate"], "--pitches", "24", "60", "84",
                     "--num-samples", "2"],
        "interpolate": ["interpolate", "--model-dir", FLAGSHIP,
                        "--output-dir", out["interpolate"], "--pitch", "60",
                        "--pitch-b", "67", "--steps", "9"],
        "evaluate": ["evaluate", "--model-dir", FLAGSHIP, "--pitches",
                     *map(str, pitches), "--samples-per-pitch",
                     str(EVAL_SAMPLES), "--seed", "0", "--attribution",
                     "--output", eval_json],
        "roundtrip": ["roundtrip", "--pitch", "60"],
        "validate-data": ["validate-data", "--data", notes,
                          "--throughput-seconds", "1", "--output",
                          report_json],
    }
    # K1 a render, each replaying its batch size's CUDA graph; a command's
    # first render at a batch size is its graph's warm-up and a replay
    # (two launches): generate 2 + 1 (two samples at B=3), interpolate 2,
    # evaluate 2 + 1 a later round, roundtrip 2, validate-data's
    # roundtrip 2
    k1_want = {"generate": 3, "interpolate": 2, "evaluate": EVAL_SAMPLES + 1,
               "roundtrip": 2, "validate-data": 2}
    launches, seconds, printed = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()
    for name, argv in runs.items():
        synthesis_spectrum.launches = 0
        conv3x3_same.launches.update(forward=0, input_grad=0)
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = {"synthesis_spectrum": synthesis_spectrum.launches,
                          "conv3x3": sum(conv3x3_same.launches.values())}
        printed[name] = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"cli {name} exited {rc}:\n"
                                 f"{printed[name][-3000:]}")
        if launches[name]["synthesis_spectrum"] != k1_want[name]:
            raise AssertionError(f"cli {name}: K1 launched "
                                 f"{launches[name]['synthesis_spectrum']} "
                                 f"times, not {k1_want[name]}")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    def wavs(d, names):
        got = sorted(os.listdir(d))
        if got != sorted(names):
            raise AssertionError(f"{d}: {got}")
        for n in names:
            w, sr = read_wav(os.path.join(d, n))
            rms = float(np.sqrt(np.mean(w ** 2)))
            if sr != 16000 or not np.isfinite(w).all() or rms < 1e-3:
                raise AssertionError(f"{n}: sr {sr}, rms {rms}")
        return len(names)

    wavs(out["generate"], [f"sample_{i}_pitch{p}.wav" for i in range(2)
                           for p in (24, 60, 84)])
    wavs(out["interpolate"],
         [f"interp_{i:02d}_t{t:.2f}.wav"
          for i, t in enumerate(np.linspace(0.0, 1.0, 9))] + ["morph.wav"])

    with open(eval_json) as f:
        metrics = json.load(f)
    r = ref["metrics"]
    n = len(pitches) * EVAL_SAMPLES
    if (metrics["num_samples"], metrics["reference_set"]) != (n, "fixture"):
        raise AssertionError(f"evaluate: {metrics['num_samples']} notes, "
                             f"references {metrics['reference_set']}")
    notes_off = {k: abs(metrics[k] - r[k]) * n for k in EVAL_ACCURACIES}
    rel = {k: abs(metrics[k] - r[k]) / abs(r[k]) for k in EVAL_REL_BARS}
    bad = [k for k, v in notes_off.items() if not v <= EVAL_NOTES_BAR + 1e-6]
    bad += [k for k, v in rel.items() if not v <= EVAL_REL_BARS[k]]
    if bad:
        raise AssertionError(f"evaluate against the reference: {bad}; notes "
                             f"off {notes_off}, relative {rel}")
    m = re.search(r"rendered (\d+) notes in ([0-9.]+) s, scored them in "
                  r"([0-9.]+) s", printed["evaluate"])
    snr = float(re.search(r"roundtrip SNR: (-?[0-9.]+) dB",
                          printed["roundtrip"]).group(1))
    snr_ref = ref["roundtrip"]["snr_db"]
    if not abs(snr - snr_ref) <= ROUNDTRIP_DB_BAR:
        raise AssertionError(f"roundtrip SNR {snr} dB, the reference's "
                             f"{snr_ref} dB (bar {ROUNDTRIP_DB_BAR} dB)")
    with open(report_json) as f:
        report = json.load(f)
    if not (report["ok"] and report["train_check_ok"]
            and report["decode_ok"]):
        raise AssertionError(f"validate-data: {report}")

    keys = (*EVAL_ACCURACIES, *EVAL_REL_BARS, *EVAL_UNBARRED)
    result = {
        "launches": launches, "seconds": seconds,
        "launches_total": {k: sum(v[k] for v in launches.values())
                           for k in ("synthesis_spectrum", "conv3x3")},
        "evaluate": {
            "notes": int(m.group(1)), "render_seconds": float(m.group(2)),
            "metrics_seconds": float(m.group(3)),
            "metrics": {k: metrics[k] for k in keys},
            "reference": {k: r[k] for k in keys},
            "accuracy_notes_off": notes_off, "relative_diff": rel,
            "bars": {"notes": EVAL_NOTES_BAR, **EVAL_REL_BARS},
            "unbarred": list(EVAL_UNBARRED),
        },
        "roundtrip_snr_db": snr, "roundtrip_reference_snr_db": snr_ref,
        "validate_data": {k: report[k] for k in (
            "ok", "schema_ok", "decode_ok", "train_check_ok",
            "decode_examples_per_sec", "decode_headroom_vs_chip",
            "train_check_stage", "roundtrip_snr_db_median")},
        "peak_mem_gib": peak_gib, "card": card,
    }
    print(json.dumps({"offline_cli": result}), flush=True)
    shutil.rmtree(OFFLINE_DIR, ignore_errors=True)
    return result


STEP_BAR = 1e-3   # |kernels - plain| <= STEP_BAR * max(1, |plain|) per metric


def kernels_vs_plain_step(device):
    """One float32 step from one state (and so one noise), with the
    kernels and with the plain lowerings; every metric within STEP_BAR."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock
    from gansynth_tpu_torch.train.step import make_train_step

    results = {}
    for kernels in ("pallas", "xla"):
        config = training_config("float32", kernels)
        # one seed and step, so both draw the same noise
        state, stage, alpha, waves, pitches = training_setup(config, device)
        before = (sum(conv3x3_same.launches.values()), fused_dblock.launches)
        _, m = make_train_step(config, stage)(state, waves, pitches, alpha)
        torch.cuda.synchronize()
        after = (sum(conv3x3_same.launches.values()), fused_dblock.launches)
        launched = after[0] > before[0] and after[1] > before[1]
        if launched != (kernels == "pallas"):
            raise AssertionError(f"{kernels} step: kernel launches "
                                 f"{before} -> {after}")
        results[kernels] = ({k: float(v) for k, v in m.items()},
                            flat_params(state.d), flat_params(state.g))
        del state
    (mk, dk, gk), (mx, dx, gx) = results["pallas"], results["xla"]
    errs = {k: abs(mk[k] - mx[k]) for k in mx}
    worst = max(errs[k] / max(1.0, abs(mx[k])) for k in mx)
    if not worst <= STEP_BAR:
        raise AssertionError(f"kernels vs plain step: {errs} (bar {STEP_BAR})")
    out = {"metrics_kernels": mk, "metrics_plain": mx, "abs_err": errs,
           "worst_scaled_err": worst, "bar": STEP_BAR,
           "d_param_max_diff": float((dk - dx).abs().max()),
           "g_param_max_diff": float((gk - gx).abs().max())}
    print(json.dumps({"step_kernels_vs_plain": out}), flush=True)
    return out


def render_flagship(device, config, generator, stage):
    import dataclasses

    import torch

    from gansynth_tpu_torch.kernels.synthesis import (
        synthesis_spectrum,
        synthesis_spectrum_plain,
    )
    from gansynth_tpu_torch.ops.spectral import istft_rect
    from gansynth_tpu_torch.synth.random import seeded_latents
    from gansynth_tpu_torch.synth.sampler import (
        make_latent_sampler,
        make_seeded_sampler,
        pitch_to_onehot,
    )
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    before = synthesis_spectrum.launches
    waves = make_seeded_sampler(config, generator, stage)([0, 1, 2],
                                                          [36, 60, 84])
    torch.cuda.synchronize()
    if tuple(waves.shape) != (3, 64000):
        raise AssertionError(f"flagship waves have shape {tuple(waves.shape)}")
    if not bool(torch.isfinite(waves).all()):
        raise AssertionError("flagship waves are not finite")
    rms = waves.float().pow(2).mean(dim=1).sqrt()
    if not bool((rms > 1e-3).all()):
        raise AssertionError(f"flagship notes are silent: rms {rms.tolist()}")
    if synthesis_spectrum.launches <= before:
        raise AssertionError("flagship render did not launch K1")

    # One float32 note on the card (K1, cuDNN) against the same note on the
    # CPU (the plain path), F32_NOTE_RUNS times. Each run also holds K1 to
    # the plain version on the card on that run's own image, and that image
    # to the CPU's, which tells a deviation of K1 from one of the generator.
    cfg32 = dataclasses.replace(
        config, model=dataclasses.replace(config.model,
                                          compute_dtype="float32"))
    npz = os.path.join(FLAGSHIP, "ema.npz")
    z = seeded_latents([7], cfg32.model.latent_dim)
    labels = pitch_to_onehot(torch.tensor([60]), cfg32).numpy()
    want, want_image = make_latent_sampler(
        cfg32, load_ema_generator(npz, cfg32.model, "cpu")[0], stage)(z, labels)
    on_card = make_latent_sampler(
        cfg32, load_ema_generator(npz, cfg32.model, device)[0], stage)
    runs, first_image = [], None
    for run in range(F32_NOTE_RUNS):
        got, image = on_card(z, labels)
        with torch.inference_mode():
            re, im = synthesis_spectrum(image, cfg32.audio)
            pre, pim = synthesis_spectrum_plain(image, cfg32.audio)
            k1_wave = istft_rect(re, im, cfg32.audio).cpu()
            plain_wave = istft_rect(pre, pim, cfg32.audio).cpu()
        image = image.cpu()
        first_image = image if first_image is None else first_image
        err, snr = wave_check(want, got.cpu(), f"f32 note run {run}, card vs CPU")
        k1_err, k1_snr = wave_check(plain_wave, k1_wave,
                                    f"f32 note run {run}, K1 vs plain")
        gen_err, gen_snr = wave_check(want, plain_wave,
                                      f"f32 note run {run}, plain on the card "
                                      "vs CPU")
        runs.append({
            "run": run, "wave_max_abs_err": err, "wave_snr_db": snr,
            "k1_spectrum_max_abs_err": max(float((re - pre).abs().max()),
                                           float((im - pim).abs().max())),
            "k1_wave_max_abs_err": k1_err, "k1_wave_snr_db": k1_snr,
            "plain_wave_max_abs_err": gen_err, "plain_wave_snr_db": gen_snr,
            "image_max_abs_err": float((image - want_image).abs().max()),
            "image_vs_run0_max_abs_diff":
                float((image - first_image).abs().max()),
        })
    print(json.dumps({"f32_note_runs": runs}), flush=True)
    worst = max(runs, key=lambda r: r["wave_max_abs_err"])
    return rms.tolist(), worst["wave_max_abs_err"], worst["wave_snr_db"]


def bf16_vs_reference(device, config):
    """The flagship generator in bf16 on the card against the reference's
    output committed under ``tests/data`` (made on the CPU by the JAX
    package), with the convs on cuDNN (``"xla"``) and with K2 in the loop
    (``"pallas"``), at the bar of ``tests/torch_reference_data.py``."""
    import dataclasses

    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_reference_data as ref

    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    d = ref.load()
    out = {}
    for conv_kernel in ("xla", "pallas"):
        model = dataclasses.replace(config.model, conv_kernel=conv_kernel)
        g = load_ema_generator(os.path.join(FLAGSHIP, "ema.npz"), model,
                               device)[0]
        before = conv3x3_same.launches["forward"]
        with torch.no_grad():
            image = g(torch.from_numpy(d["z"]).to(device),
                      torch.from_numpy(d["labels"]).to(device),
                      int(d["stage"]), 1.0)
        torch.cuda.synchronize()
        launched = conv3x3_same.launches["forward"] - before
        if launched != (3 if conv_kernel == "pallas" else 0):
            raise AssertionError(f"{conv_kernel}: {launched} K2 launches")
        out[conv_kernel] = ref.check(image.cpu().numpy(), d["image"])
        del g
    print(json.dumps({"bf16_vs_reference": out}), flush=True)
    return out


SERVE_REQUESTS = [[36], [48, 60], [72], [84, 60, 36]]   # request i: seed i


def serve_requests(service):
    """The main path: ``service`` behind the HTTP server, the 4 concurrent
    requests of ``SERVE_REQUESTS``; returns the ``/healthz`` body and the
    WAV bodies. Closes the service."""
    from gansynth_tpu_torch.serve import make_server

    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="http")
    thread.start()
    url = "http://%s:%d" % server.server_address
    requests = SERVE_REQUESTS
    replies = [None] * len(requests)
    errors = []
    barrier = threading.Barrier(len(requests))

    def post(i):
        try:
            body = json.dumps({"pitches": requests[i], "seed": i}).encode()
            req = urllib.request.Request(
                url + "/synthesize", data=body,
                headers={"Content-Type": "application/json"})
            barrier.wait(30)
            with urllib.request.urlopen(req, timeout=120) as resp:
                replies[i] = (resp.status, resp.headers["Content-Type"],
                              resp.read())
        except Exception as e:  # reported on the main thread below
            errors.append(f"request {i}: {e!r}")

    try:
        clients = [threading.Thread(target=post, args=(i,), daemon=True)
                   for i in range(len(requests))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(180)
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"requests failed: {errors}")
        for (status, ctype, body), pitches in zip(replies, requests):
            if status != 200 or ctype != "audio/wav":
                raise AssertionError(f"reply {status} {ctype}")
            if body[:4] != b"RIFF" or body[8:12] != b"WAVE":
                raise AssertionError("reply is not a WAV file")
            if len(body) != 44 + 2 * 64000 * len(pitches):
                raise AssertionError(f"WAV of {len(body)} bytes for "
                                     f"{len(pitches)} notes")
        with urllib.request.urlopen(url + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        if health["requests_served"] != len(requests):
            raise AssertionError(f"healthz: {health}")
        if not 1 <= health["device_batches"] <= len(requests):
            raise AssertionError(f"healthz: {health}")
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(30)
    alive = [t.name for t in threading.enumerate()
             if t is not threading.main_thread() and not t.daemon]
    if thread.is_alive() or service._batcher.is_alive() or alive:
        raise AssertionError(f"threads still running: {alive}")
    return health, [body for _, _, body in replies]


EXPORT_DIR = os.path.join(ROOT, "build", "smoke_export")
EXPORT_RUNGS = ("1", "4", "16")
EXPORT_NOTE = (5, 60)    # (seed, pitch) of the note rendered on both devices
EXPORT_TURNS = 12        # in-turns calls a rung of each of the three paths


def _pcm(wav: bytes):
    import numpy as np

    return np.frombuffer(wav[44:], dtype="<i2").astype(np.float64)


def _rel(want, got) -> float:
    import numpy as np

    return float(np.linalg.norm(want - got) / (np.linalg.norm(want) + 1e-30))


def export_phase(card, config):
    """Phase 12, the portable serving artifact on the flagship: ``cli
    export-model --with-latent --check``; the artifact loaded on the card
    behind the HTTP server beside the in-process service (K1 counted from
    the load to the last reply); ``interpolate --from-exported``; the same
    artifact on the CPU; a ``conv_kernel="pallas"`` export with K2 counted.
    Writes only under ``build/smoke_export/``."""
    import contextlib
    import dataclasses
    import io
    import re

    import torch

    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum
    from gansynth_tpu_torch.serve import SynthesisService
    from gansynth_tpu_torch.synth.export import (
        load_sampler_artifact,
        save_sampler_artifact,
    )
    from gansynth_tpu_torch.synth.random import seeded_latents
    from gansynth_tpu_torch.synth.sampler import (
        make_seeded_sampler,
        pitch_to_onehot,
    )
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator

    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    art = os.path.join(EXPORT_DIR, "sampler.gsx")
    out = {"card": card}

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["export-model", "--model-dir", FLAGSHIP, "--output",
                       art, "--with-latent", "--check"])
    out["export_model_seconds"] = time.perf_counter() - t
    printed = buf.getvalue()
    if rc != 0:
        raise AssertionError(f"export-model exited {rc}:\n{printed[-3000:]}")
    out["save_seconds"] = float(re.search(r"\) in ([0-9.]+) s",
                                          printed).group(1))
    out["check_rel_l2"] = float(re.search(
        r"in-process sampler: ([0-9.e+-]+) \(bound", printed).group(1))
    # export-model --check's bound for the flagship's type
    out["check_bound"] = 0.15 if config.model.compute_dtype == "bfloat16" \
        else 1e-3
    with open(art, "rb") as f:
        f.seek(8)
        hlen = int.from_bytes(f.read(4), "big")
        meta = json.loads(f.read(hlen))
    seeded = 12 + hlen + meta["programs"][0]["bytes"]
    out["mib"] = {"seeded": seeded / 2 ** 20,
                  "seeded_latent": os.path.getsize(art) / 2 ** 20}

    generator, _, stage = load_ema_generator(
        os.path.join(FLAGSHIP, "ema.npz"), config.model, "cuda")
    sample = make_seeded_sampler(config, generator, stage)
    in_process = SynthesisService(config, generator, stage=stage,
                                  max_batch=MAX_BATCH)
    in_process.close()

    synthesis_spectrum.launches = 0
    t = time.perf_counter()
    loaded = load_sampler_artifact(art, "cuda")
    out["load_seconds"] = time.perf_counter() - t
    service = SynthesisService(loaded.config(), None, exported=loaded,
                               max_batch=MAX_BATCH, request_timeout_s=120.0)
    health, replies = serve_requests(service)
    out["launches"] = synthesis_spectrum.launches
    if out["launches"] == 0:
        raise AssertionError("the exported sampler never launched K1")
    if not health["exported_artifact"]:
        raise AssertionError(f"healthz: {health}")
    out["warm_latency_s"] = {
        r: {"exported": health["warm_latency_s"][r],
            "in_process": in_process.warm_latency_s[int(r)]}
        for r in EXPORT_RUNGS}
    out["device_batches"] = health["device_batches"]
    served = []
    for i, (pitches, wav) in enumerate(zip(SERVE_REQUESTS, replies)):
        seeds = [(i * 1000003 + j) & 0x7FFFFFFF for j in range(len(pitches))]
        want = service.wav_bytes(sample(seeds, pitches).cpu().numpy())
        served.append(_rel(_pcm(want), _pcm(wav)))
    out["served_rel_l2"] = served
    if not max(served) <= out["check_bound"]:
        raise AssertionError(f"served waves vs the in-process sampler: "
                             f"{served} (bound {out['check_bound']})")

    # The same batches through the artifact's seeded program, its latent
    # program fed the host's latents (what the in-graph draw costs), and
    # the in-process sampler, in turns: host-clock latency to the fetched
    # wave, and the waves' gap.
    def latent_program(seeds, pitches):
        labels = pitch_to_onehot(torch.tensor(pitches), config).numpy()
        return loaded.latent(
            seeded_latents(seeds, config.model.latent_dim), labels)

    contenders = [("exported", loaded), ("latent_program", latent_program),
                  ("in_process", sample)]
    latency, same = {}, {}
    for r in EXPORT_RUNGS:
        seeds = list(range(int(r)))
        pitches = [24 + 7 * i % 61 for i in seeds]
        ms = {name: [] for name, _ in contenders}
        for turn in range(EXPORT_TURNS):
            k = turn % len(contenders)
            for name, fn in contenders[k:] + contenders[:k]:
                t = time.perf_counter()
                fn(seeds, pitches).cpu()
                ms[name].append((time.perf_counter() - t) * 1e3)
        latency[r] = {k: {"median": statistics.median(v), "min": min(v),
                          "max": max(v)} for k, v in ms.items()}
        want = sample(seeds, pitches).cpu().numpy()
        same[r] = {name: _rel(want, fn(seeds, pitches).cpu().numpy())
                   for name, fn in contenders[:2]}
    out["latency_ms_in_turns"] = latency
    out["same_batch_rel_l2"] = same

    interp = os.path.join(EXPORT_DIR, "interpolate")
    synthesis_spectrum.launches = 0
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["interpolate", "--from-exported", art, "--output-dir",
                       interp, "--pitch", "60", "--pitch-b", "67",
                       "--steps", "9"])
    if rc != 0 or len(os.listdir(interp)) != 10:
        raise AssertionError(f"interpolate --from-exported: rc {rc}")
    out["interpolate_launches"] = synthesis_spectrum.launches

    seed, pitch = EXPORT_NOTE
    card_wave = loaded([seed], [pitch]).cpu().numpy()
    t = time.perf_counter()
    on_cpu = load_sampler_artifact(art, "cpu")
    cpu_wave = on_cpu([seed], [pitch]).numpy()
    out["cpu_seconds"] = time.perf_counter() - t
    out["cpu_vs_card_rel_l2"] = _rel(card_wave, cpu_wave)
    if not out["cpu_vs_card_rel_l2"] <= out["check_bound"]:
        raise AssertionError(f"the artifact on the CPU vs the card: "
                             f"{out['cpu_vs_card_rel_l2']}")
    del on_cpu, loaded, service

    pallas = dataclasses.replace(config, model=dataclasses.replace(
        config.model, conv_kernel="pallas"))
    gen_k2, step, _ = load_ema_generator(
        os.path.join(FLAGSHIP, "ema.npz"), pallas.model, "cuda")
    art_k2 = os.path.join(EXPORT_DIR, "pallas.gsx")
    t = time.perf_counter()
    save_sampler_artifact(art_k2, pallas, gen_k2, step, stage=stage)
    out["pallas_save_seconds"] = time.perf_counter() - t
    loaded = load_sampler_artifact(art_k2, "cuda")
    seeds, pitches = [0, 1, 2, 3], [36, 48, 60, 72]
    synthesis_spectrum.launches = 0
    conv3x3_same.launches.update(forward=0, input_grad=0)
    got = loaded(seeds, pitches).cpu().numpy()
    torch.cuda.synchronize()
    out["pallas_launches"] = {"synthesis_spectrum": synthesis_spectrum.launches,
                              "conv3x3": conv3x3_same.launches["forward"]}
    want = make_seeded_sampler(pallas, gen_k2, stage)(
        seeds, pitches).cpu().numpy()
    out["pallas_rel_l2"] = _rel(want, got)
    # the batch's first call: a warm-up batch and the replay of the graph
    # it captured, one K1 launch each
    if not (out["pallas_launches"]["conv3x3"] > 0
            and out["pallas_launches"]["synthesis_spectrum"] == 2
            and out["pallas_rel_l2"] <= out["check_bound"]):
        raise AssertionError(f"conv_kernel=pallas export: {out}")
    print(json.dumps({"export": out}), flush=True)
    os.remove(art_k2)   # phase 15 serves sampler.gsx again, then removes it
    shutil.rmtree(interp, ignore_errors=True)
    return out


# Phase 14: `cli train --data-parallel` runs of one superstep from phase
# 10's seed, held to phase 10's run A at its first checkpoint.
DP_RUNS = {"replicate": [],
           "shard": ["--device-cache-layout", "shard"],
           "per_replica": ["--mbstd", "per-replica"]}
DP_TURNS = 3   # in-turns rounds of the step timing, DP_TURN_STEPS steps each
DP_TURN_STEPS = 3
DP_TRACED = 2  # steps of each form under torch.profiler


def _kernel_counts():
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock

    return {"conv3x3_forward": conv3x3_same.launches["forward"],
            "conv3x3_input_grad": conv3x3_same.launches["input_grad"],
            "conv3x3_recompute": conv3x3_same.launches["recompute"],
            "dblock": fused_dblock.launches,
            "dblock_recompute": fused_dblock.recompute_launches}


def _zero_kernel_counts():
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock

    conv3x3_same.launches.update(forward=0, input_grad=0, recompute=0)
    fused_dblock.launches = fused_dblock.recompute_launches = 0


def dp_step_timing(device, mesh):
    """The flagship's stage-6 step (bf16, kernels on) in three forms from
    one state: without the group as a CUDA graph, in the group as a CUDA
    graph (its collectives captured) and in the group eagerly; DP_TURNS
    rounds in turns of DP_TURN_STEPS steps each (CUDA events), each form's
    peak memory, and from a trace of DP_TRACED steps of each the device's
    busy ms and idle share, the API launches a step and K2 and K3 counted
    by name (69 and 4 a step in every form, one ``cudaGraphLaunch`` a step
    in the graphed ones); then the all-reduces a DP step makes (G's and
    D's gradient buckets and the metrics) timed with CUDA events, 20
    repeats."""
    import torch

    from gansynth_tpu_torch.train.step import make_train_step
    from gansynth_tpu_torch.utils.profiling import busy, in_turns, spread

    config = training_config()
    state, stage, alpha, waves, pitches = training_setup(config, device)
    fns = {"no_group_graph": make_train_step(config, stage),
           "group_graph": make_train_step(config, stage, mesh),
           "group_eager": make_train_step(config, stage, mesh,
                                          graphs=False)}
    for fn in fns.values():   # the graphs' captures
        fn(state, waves, pitches, alpha)
    peak = dict.fromkeys(fns, 0.0)

    def steps(name, n):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            fns[name](state, waves, pitches, alpha)
        peak[name] = max(peak[name],
                         torch.cuda.max_memory_allocated() / 2 ** 30)

    times = in_turns({k: (lambda k=k: steps(k, DP_TURN_STEPS)) for k in fns},
                     DP_TURNS, DP_TURN_STEPS)
    forms = {}
    for name in fns:
        ms = statistics.median(times[name]["ms"])
        forms[name] = {
            "ms_per_step": spread(times[name]["ms"]),
            "host_enqueue_ms_per_step": statistics.median(
                times[name]["host_ms"]),
            **busy(lambda name=name: steps(name, DP_TRACED), DP_TRACED, ms),
            "peak_mem_gib": peak[name]}
        traced = forms[name]["kernel_launches"]
        want = {"conv3x3": GRAPH_K2_PER_STEP, "dblock": GRAPH_K3_PER_STEP}
        if any(traced[k] != v for k, v in want.items()):
            raise AssertionError(f"DP step {name}: kernels a step on the "
                                 f"device {traced}, want {want}")
        graph_launches = forms[name]["api_launches"].get("cudaGraphLaunch",
                                                         0)
        if name.endswith("graph") and graph_launches != 1:
            raise AssertionError(f"DP step {name}: {graph_launches} "
                                 "cudaGraphLaunch a step")
    buckets = [torch.zeros(sum(p.numel() for p in net.parameters()),
                           device=device) for net in (state.g, state.d)]
    buckets.append(torch.zeros(16, device=device))
    for b in buckets:
        mesh.all_reduce_mean(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        for b in buckets:
            mesh.all_reduce_mean(b)
    end.record()
    torch.cuda.synchronize()
    del state, fns
    torch.cuda.empty_cache()
    return {"forms": forms,
            "median_step_ms": {k: v["ms_per_step"]["median"]
                               for k, v in forms.items()},
            "all_reduce_ms_per_step": start.elapsed_time(end) / 20,
            "all_reduce_bucket_elements": [b.numel() for b in buckets]}


def dp_cached_graph(device, mesh):
    """GRAPH_STEPS steps of the mesh's cached superstep on the flagship's
    stage-6 state (bf16, K2 and K3 on, GRAPH_NOTES notes cached) in the
    group, under both cache layouts: the CUDA graph against the eager run
    from one state, G, D and EMA at distance 0 and the metrics equal; the
    graph's first call (warm-up, capture, replays) and an eager call's
    seconds and peak memory (the graph's private pool is allocated
    there)."""
    import copy

    import torch

    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.step import make_cached_superstep

    out = {}
    for layout in ("replicate", "shard"):
        config = training_config().with_overrides(
            {"train": {"device_cache_layout": layout}})
        state, stage, alpha, _, _ = training_setup(config, device)
        m = config.model
        waves, pitches = note_batch(GRAPH_NOTES, m.pitch_min, m.pitch_max)
        all_waves = torch.from_numpy(waves).to(device)
        all_pitches = torch.from_numpy(pitches.astype("int32")).to(device)
        states = {"eager": copy.deepcopy(state), "graph": state}
        metrics, seconds, peak = {}, {}, {}
        for kind in ("eager", "graph"):
            step = make_cached_superstep(config, stage, GRAPH_NOTES, mesh,
                                         graphs=kind == "graph")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            _, got = step(states[kind], all_waves, all_pitches,
                          [alpha] * GRAPH_STEPS)
            metrics[kind] = {k: float(v) for k, v in got.items()}
            torch.cuda.synchronize()
            seconds[kind] = time.perf_counter() - t
            peak[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
        distance = {net: float((flat_params(getattr(states["graph"], net))
                                - flat_params(getattr(states["eager"], net))
                                ).abs().max()) for net in ("g", "d", "ema")}
        if any(distance.values()) or metrics["graph"] != metrics["eager"]:
            raise AssertionError(f"DP {layout} graph vs eager superstep: "
                                 f"distance {distance}, metrics {metrics}")
        out[layout] = {"distance_max_abs": distance, "seconds": seconds,
                       "peak_mem_gib": peak,
                       "d_loss": metrics["graph"]["d_loss"]}
        del states, state
        torch.cuda.empty_cache()
    return out


def remat_step(device):
    """The stage-6 step in float32 (kernels on) with ``remat=False`` and
    ``remat=True`` from one state: metric by metric (phase 9's bar), the
    step's peak memory, ms a step over 3 steps (CUDA events), and the
    kernels' launches (the recompute's apart)."""
    import torch

    from gansynth_tpu_torch.train.step import make_train_step

    out = {}
    for remat in (False, True):
        config = training_config("float32").with_overrides(
            {"model": {"remat": remat}})
        state, stage, alpha, waves, pitches = training_setup(config, device)
        step = make_train_step(config, stage, graphs=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_kernel_counts()
        _, m = step(state, waves, pitches, alpha)
        torch.cuda.synchronize()
        launches = _kernel_counts()
        peak = torch.cuda.max_memory_allocated()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            step(state, waves, pitches, alpha)
        end.record()
        torch.cuda.synchronize()
        out["remat" if remat else "plain"] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "peak_mem_gib": peak / 2 ** 30,
            "step_peak_over_state_gib": (peak - base) / 2 ** 30,
            "ms_per_step": start.elapsed_time(end) / 3,
            "launches": launches}
        del state
        torch.cuda.empty_cache()
    plain, remat = out["plain"]["metrics"], out["remat"]["metrics"]
    errs = {k: abs(remat[k] - plain[k]) for k in plain}
    out["abs_err"] = errs
    out["worst_scaled_err"] = max(errs[k] / max(1.0, abs(plain[k]))
                                  for k in plain)
    if not out["worst_scaled_err"] <= STEP_BAR:
        raise AssertionError(f"remat vs plain step: {errs} (bar {STEP_BAR})")
    rc = out["remat"]["launches"]
    if not (rc["conv3x3_recompute"] and rc["dblock_recompute"]):
        raise AssertionError(f"remat recomputed no kernel: {rc}")
    if out["remat"]["peak_mem_gib"] >= out["plain"]["peak_mem_gib"]:
        raise AssertionError(f"remat's peak is not lower: {out}")
    return out


def serve_data_parallel(config, generator, stage):
    """``serve --data-parallel`` on the flagship (``cli.make_service``: a
    replica per visible card): each request once alone, equal to the
    in-process service's reply at the same rung, then the 4 concurrent
    requests over HTTP, each within the bf16 bound of the in-process
    sampler's waves; K1 counted from the service's warm-up to the last
    reply."""
    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum
    from gansynth_tpu_torch.serve import SynthesisService
    from gansynth_tpu_torch.synth.sampler import make_seeded_sampler

    args = cli.build_parser().parse_args(
        ["serve", "--model-dir", FLAGSHIP, "--data-parallel", "--max-batch",
         str(MAX_BATCH)])
    # each request alone, through a service of its own
    services = [cli.make_service(args)[0],
                SynthesisService(config, generator, stage=stage,
                                 max_batch=MAX_BATCH)]
    try:
        alone = []
        for i, pitches in enumerate(SERVE_REQUESTS):
            a, b = (svc.synthesize(pitches, seed=i) for svc in services)
            alone.append(float(abs(a - b).max()))
    finally:
        for svc in services:
            svc.close()
    if max(alone) != 0.0:
        raise AssertionError(f"data-parallel replies alone differ from the "
                             f"in-process service's: {alone}")
    synthesis_spectrum.launches = 0
    service, message = cli.make_service(args)
    if service is None:
        raise AssertionError(message)
    health, replies = serve_requests(service)
    launches = synthesis_spectrum.launches
    if launches == 0:
        raise AssertionError("serve --data-parallel never launched K1")
    sample = make_seeded_sampler(config, generator, stage)
    served = []
    for i, (pitches, wav) in enumerate(zip(SERVE_REQUESTS, replies)):
        seeds = [(i * 1000003 + j) & 0x7FFFFFFF for j in range(len(pitches))]
        want = service.wav_bytes(sample(seeds, pitches).cpu().numpy())
        served.append(_rel(_pcm(want), _pcm(wav)))
    if not max(served) <= 0.15:
        raise AssertionError(f"served waves vs the in-process sampler: "
                             f"{served} (bound 0.15)")
    return {"message": message, "mesh_devices": health["mesh_devices"],
            "batch_ladder": health["batch_ladder"],
            "determinism": health["determinism"],
            "device_batches": health["device_batches"],
            "alone_max_abs_diff": alone, "served_rel_l2": served,
            "launches": launches}


def data_parallel(card, loop_ref, config, generator, stage):
    """Phase 14; see the docstring."""
    import torch
    import torch.distributed as dist

    from gansynth_tpu_torch import cli
    from gansynth_tpu_torch.parallel import sharding

    mid = 415000 + LOOP_CADENCE
    want, repeat = loop_ref["params_mid"], loop_ref["a_vs_repeat_mid"]

    def distance(run):
        got = loop_params(run, mid)
        return {k: float((got[k].cpu() - want[k]).abs().max()) for k in want}

    out = {"card": card, "steps": LOOP_CADENCE,
           "a_vs_repeat_max_abs": repeat, "distance_max_abs": {}}
    # `cli train --data-parallel` in a process of its own: it starts one
    # worker per visible card, which joins an NCCL group
    run = loop_dir("dp_replicate")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gansynth_tpu_torch.cli",
         *loop_argv(run, LOOP_CADENCE), "--data-parallel"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    out["process_seconds"] = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli train --data-parallel: exit "
                             f"{proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    out["distance_max_abs"]["replicate"] = distance(run)
    shutil.rmtree(run)

    # the other two in this process, in an NCCL group of one rank set up
    # here (cli train joins it), with the kernels' launches counted
    sharding.initialize_multihost(torch.device("cuda"),
                                  f"tcp://127.0.0.1:{cli._free_port()}", 0, 1)
    out["launches"] = {}
    try:
        mesh = sharding.make_mesh()
        out["backend"] = dist.get_backend()
        out["nccl_version"] = ".".join(map(str, torch.cuda.nccl.version()))
        print(f"NCCL {out['nccl_version']}", flush=True)
        for name, flags in DP_RUNS.items():
            if name == "replicate":
                continue
            run = loop_dir(f"dp_{name}")
            _zero_kernel_counts()
            if cli.main([*loop_argv(run, LOOP_CADENCE), "--data-parallel",
                         *flags]) != 0:
                raise AssertionError(f"cli train --data-parallel {flags}")
            torch.cuda.synchronize()
            out["launches"][name] = _kernel_counts()
            bad = [k for k in ("conv3x3_forward", "conv3x3_input_grad",
                               "dblock") if out["launches"][name][k] == 0]
            if bad:
                raise AssertionError(f"the DP {name} run never launched "
                                     f"{bad}")
            out["distance_max_abs"][name] = distance(run)
            shutil.rmtree(run)
        t = time.perf_counter()
        out["cached_graph"] = dp_cached_graph(torch.device("cuda"), mesh)
        out["cached_graph_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["timing"] = dp_step_timing(torch.device("cuda"), mesh)
        out["timing_s"] = time.perf_counter() - t
    finally:
        dist.destroy_process_group()
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    for name, dists in out["distance_max_abs"].items():
        for k, v in dists.items():
            if not v <= 2 * repeat[k]:
                raise AssertionError(
                    f"DP {name} run vs phase 10's run A at {mid}: "
                    f"{dists} (bar twice the repeat's {repeat})")
    out["remat"] = remat_step(torch.device("cuda"))
    out["serve"] = serve_data_parallel(config, generator, stage)
    print(json.dumps({"data_parallel": out}), flush=True)
    return out


# Phase 15: the CUDA graphs of the serving rungs and of the training
# superstep, each held against the same work run eagerly.
GRAPH_RUNGS = (1, 4, 16)
KEYED_RUNGS = (3, 9, 61)   # the loop's dumps, interpolate, evaluate
GRAPH_TURNS = 5         # in-turns rounds (eager, graph) of each served rung
GRAPH_STEPS = 10        # the cached superstep held graph against eager
GRAPH_TRAIN_TURNS = 3   # in-turns rounds of it, GRAPH_TURN_STEPS steps each
GRAPH_TURN_STEPS = 5
GRAPH_TRACED = 2        # steps of each form under torch.profiler
GRAPH_NOTES = 64        # notes cached on the card for that superstep
GRAPH_K2_PER_STEP = 69  # K2's launches a stage-6 step (phases 8 and 10)
GRAPH_K3_PER_STEP = 4


def _counting(fn, counts):
    """``fn`` that adds the kernel launches each call makes
    (``kernels.launch_counts``) to the dict ``counts``."""
    from gansynth_tpu_torch.kernels import launch_counts

    def call(*args):
        before = launch_counts()
        try:
            return fn(*args)
        finally:
            for k, v in launch_counts().items():
                counts[k] = counts.get(k, 0) + v - before[k]
    return call


def _seeded_inputs(b):
    return ([(7919 * i + b) & 0x7FFFFFFF for i in range(b)],
            [24 + (7 * i) % 61 for i in range(b)])


def _keyed_inputs(b):
    from gansynth_tpu_torch.synth.random import seed_to_key

    return seed_to_key(b), [24 + (7 * i) % 61 for i in range(b)]


def _outputs(out):
    """A sampler's outputs as a tuple: the wave, and a keyed sampler's
    image."""
    return out if isinstance(out, tuple) else (out,)


def _graph_serving(eager, graphed, name, rungs=GRAPH_RUNGS,
                   inputs=_seeded_inputs, traced_rungs=(1, 16)):
    """One sampler at ``rungs`` (``inputs(b)`` its arguments at batch b):
    the graph's outputs against the eager batch's (to the bit), the
    capture's seconds, K1's launches a replay, the host ms a batch in
    turns, and at ``traced_rungs`` a trace of each form (device busy ms,
    idle share, API launches a batch, and K1 counted by name on the
    device: once a batch in both forms). Returns the rows and each form's
    K1 launches over the phase."""
    import torch

    from gansynth_tpu_torch.utils.profiling import busy, in_turns, spread

    launched = {"eager": {}, "graph": {}}
    eager = _counting(eager, launched["eager"])
    graphed = _counting(graphed, launched["graph"])
    out = {}
    for b in rungs:
        args = inputs(b)
        want = _outputs(eager(*args))
        torch.cuda.synchronize()
        t = time.perf_counter()
        graphed(*args)      # the rung's warm-up and capture
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t
        before = launched["graph"]["synthesis_spectrum"]
        got = _outputs(graphed(*args))
        torch.cuda.synchronize()
        k1 = launched["graph"]["synthesis_spectrum"] - before
        for x, y in zip(got, want):
            if not torch.equal(x, y):
                raise AssertionError(
                    f"{name} B={b}: the graph's outputs differ from the "
                    f"eager batch's by {float((x - y).abs().max()):.3e}")
        if k1 != 1:
            raise AssertionError(f"{name} B={b}: {k1} K1 launches a replay")
        calls = {k: (lambda fn=fn: _outputs(fn(*args))[0].cpu())
                 for k, fn in (("eager", eager), ("graph", graphed))}
        times = in_turns(calls, GRAPH_TURNS)
        row = {"equal": True, "capture_s": capture_s,
               "k1_launches_per_replay": k1}
        for k, fn in calls.items():
            host = times[k]["host_ms"]
            row[k] = {"host_ms": spread(host)}
            if b in traced_rungs:
                row[k].update(busy(fn, 1, statistics.median(host), 3))
                traced = row[k]["kernel_launches"]["synthesis_spectrum"]
                if traced != 1:
                    raise AssertionError(f"{name} B={b} {k}: K1 ran "
                                         f"{traced} times a batch")
        out[str(b)] = row
    return out, {k: v["synthesis_spectrum"] for k, v in launched.items()}


def _graph_training(device):
    """GRAPH_STEPS steps of the cached superstep on the flagship's stage-6
    state (bf16, K2 and K3 on) graph against eager from one state; see
    phase 15 in the module's docstring. Returns the results and each
    form's K2 and K3 launches over the phase."""
    import copy

    import torch

    from gansynth_tpu_torch.data.fixtures import note_batch
    from gansynth_tpu_torch.train.step import make_cached_superstep
    from gansynth_tpu_torch.utils.profiling import busy, in_turns, spread

    config = training_config()
    state, stage, alpha, _, _ = training_setup(config, device)
    m = config.model
    waves, pitches = note_batch(GRAPH_NOTES, m.pitch_min, m.pitch_max)
    all_waves = torch.from_numpy(waves).to(device)
    all_pitches = torch.from_numpy(pitches.astype("int32")).to(device)
    states = {"eager": copy.deepcopy(state), "graph": state}
    supersteps = {"eager": make_cached_superstep(config, stage, GRAPH_NOTES,
                                                 graphs=False),
                  "graph": make_cached_superstep(config, stage, GRAPH_NOTES)}
    launched = {"eager": {}, "graph": {}}
    steps = {kind: _counting(fn, launched[kind])
             for kind, fn in supersteps.items()}

    def run(kind, k=GRAPH_STEPS):
        return steps[kind](states[kind], all_waves, all_pitches,
                           [alpha] * k)[1]

    out, metrics, peak = {}, {}, {}
    for kind in ("eager", "graph"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        metrics[kind] = {k: float(v) for k, v in run(kind).items()}
        torch.cuda.synchronize()
        out[f"{kind}_first_call_s"] = time.perf_counter() - t
        peak[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["capture_s"] = supersteps["graph"].program.graph.capture_seconds
    distance = {net: float((flat_params(getattr(states["graph"], net))
                            - flat_params(getattr(states["eager"], net))
                            ).abs().max()) for net in ("g", "d", "ema")}
    out["distance_max_abs"] = distance
    out["metrics"] = metrics["graph"]
    if any(distance.values()) or metrics["graph"] != metrics["eager"]:
        raise AssertionError(f"graph vs eager superstep: distance "
                             f"{distance}, metrics {metrics}")

    # ms a step in turns (GRAPH_TURN_STEPS steps a call); each form's
    # first timed call also counts its kernel launches a step
    per_step = {}

    def counted(kind):
        before = _kernel_counts()
        run(kind, GRAPH_TURN_STEPS)
        per_step.setdefault(kind, {k: (v - before[k]) / GRAPH_TURN_STEPS
                                   for k, v in _kernel_counts().items()})

    times = in_turns({k: (lambda k=k: counted(k)) for k in steps},
                     GRAPH_TRAIN_TURNS, GRAPH_TURN_STEPS)
    launches = per_step["graph"]
    k2 = launches["conv3x3_forward"] + launches["conv3x3_input_grad"]
    if (per_step["graph"] != per_step["eager"] or k2 != GRAPH_K2_PER_STEP
            or launches["dblock"] != GRAPH_K3_PER_STEP):
        raise AssertionError(f"kernel launches a step: {per_step}")
    out["launches_per_step"] = launches
    want = {"conv3x3": GRAPH_K2_PER_STEP, "dblock": GRAPH_K3_PER_STEP}
    for kind in ("eager", "graph"):
        ms = times[kind]["ms"]
        out[kind] = {
            "ms_per_step": spread(ms),
            "host_enqueue_ms_per_step": statistics.median(
                times[kind]["host_ms"]),
            **busy(lambda: run(kind, GRAPH_TRACED), GRAPH_TRACED,
                   statistics.median(ms)),
            "peak_mem_gib": peak[kind]}
        # the kernels that ran on the device, counted by name in the trace
        traced = out[kind]["kernel_launches"]
        if any(traced[k] != v for k, v in want.items()):
            raise AssertionError(f"{kind} superstep: kernels a step on the "
                                 f"device {traced}, want {want}")
    del states, steps, supersteps
    torch.cuda.empty_cache()
    return out, launched


def cuda_graphs_phase(card, config, generator, stage, device):
    """Phase 15: the served rungs (in-process and from phase 12's
    artifact) and the training superstep, each CUDA graph against the
    same work run eagerly; K1 counted over the serving, K2 and K3 over the
    training, each form apart. One ``{"cuda_graphs": ...}`` line."""
    from gansynth_tpu_torch.synth.export import (
        ExportedSampler,
        load_sampler_artifact,
    )
    from gansynth_tpu_torch.synth.sampler import (
        make_sampler,
        make_seeded_sampler,
    )

    art = os.path.join(EXPORT_DIR, "sampler.gsx")
    out = {"card": card}
    t = time.perf_counter()
    exported = load_sampler_artifact(art, "cuda")
    # the eager form runs the same loaded programs
    exported_eager = ExportedSampler(exported.programs, exported.meta,
                                     exported.device, graphs=False)
    serving, k1 = {}, {}
    for path, eager, graphed in (
            ("in_process",
             make_seeded_sampler(config, generator, stage, graphs=False),
             make_seeded_sampler(config, generator, stage)),
            ("exported", exported_eager, exported)):
        serving[path], k1[path] = _graph_serving(eager, graphed, path)
    out["serving_s"] = time.perf_counter() - t
    # the keyed sampler of the loop's dumps (B=3), interpolate's batch (9)
    # and evaluate's (61): the host's latents a static input
    t = time.perf_counter()
    serving["keyed"], k1["keyed"] = _graph_serving(
        make_sampler(config, generator, stage, graphs=False),
        make_sampler(config, generator, stage), "keyed", KEYED_RUNGS,
        _keyed_inputs, (3, 61))
    out["keyed_s"] = time.perf_counter() - t
    out["serving"] = serving
    out["k1_launches"] = {kind: sum(v[kind] for v in k1.values())
                          for kind in ("eager", "graph")}
    t = time.perf_counter()
    out["training"], launched = _graph_training(device)
    out["training_s"] = time.perf_counter() - t
    out["k2_launches"] = {
        kind: c["conv3x3_forward"] + c["conv3x3_input_grad"]
        for kind, c in launched.items()}
    out["k3_launches"] = {kind: c["dblock"] for kind, c in launched.items()}
    print(json.dumps({"cuda_graphs": out}), flush=True)
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a "
              "card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gansynth_tpu_torch.cli import run_config
    from gansynth_tpu_torch.kernels import _build
    from gansynth_tpu_torch.kernels.synthesis import (
        _device_taps,
        synthesis_spectrum,
    )
    from gansynth_tpu_torch.serve import SynthesisService
    from gansynth_tpu_torch.utils.checkpoint import load_ema_generator
    from gansynth_tpu_torch.utils.device import (
        card_info,
        resolve_device,
        set_precision,
    )

    device = resolve_device("cuda")
    set_precision()

    t = time.perf_counter()
    card = card_info()
    print(card, flush=True)
    phase("card", t, f"{torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    config = run_config(FLAGSHIP)
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = list(pool.map(_build.load_library, KERNELS))
    resources = {}
    for lib in libs:
        print(f"built {lib.name}: {lib.build_seconds:.2f}s -> "
              f"{os.path.relpath(lib.path, ROOT)}", flush=True)
        resources[lib.name] = ptxas_report(lib.log)
        for entry in resources[lib.name]:
            print(f"  {json.dumps(entry)}", flush=True)
    # dynamic shared memory of the bf16 (wgmma) kernels, from the sources
    lib_of = {lib.name: lib.lib for lib in libs}
    for entry in resources["conv3x3"]:
        if entry["function"].startswith("conv3x3_nhwc_bf16_wgmma<"):
            n = int(entry["function"].split("<")[1].rstrip(">"))
            entry["dynamic_smem_bytes"] = \
                lib_of["conv3x3"].conv3x3_nhwc_bf16_smem_bytes(n)
    for entry in resources["dblock"]:
        if entry["function"] == "dblock_nhwc_bf16_wgmma":
            entry["dynamic_smem_bytes"] = \
                lib_of["dblock"].dblock_nhwc_bf16_smem_bytes()
    k1_span_max = _device_taps(config.audio, device)[3]
    for entry in resources["synthesis_spectrum"]:
        entry["dynamic_smem_bytes"] = \
            lib_of["synthesis_spectrum"].synthesis_spectrum_smem_bytes(
                k1_span_max)
    phase("build", t, ", ".join(KERNELS))

    t = time.perf_counter()
    k1 = check_synthesis_kernel(device, config.audio,
                                resources["synthesis_spectrum"])
    phase("K1 vs plain", t, f"max abs err {k1['max_abs_err']:.3e} "
          "(bar 2e-2; waves 5e-3, 40 dB); "
          f"B=16 kernel {k1['ms']:.4f} ms (graph {k1['graph_ms']:.4f} ms), "
          f"plain {k1['plain_ms']:.4f} ms (graph {k1['plain_graph_ms']:.4f}), "
          f"library {k1['library_ms']:.4f} ms (graph "
          f"{k1['library_graph_ms']:.4f}), bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}) ({card})")

    t = time.perf_counter()
    k2 = check_conv_kernel(device)
    phase("K2 vs plain", t, f"bf16 max abs err {k2['max_abs_err']:.3e}, "
          f"f32 {k2['max_abs_err_f32']:.3e}, second order "
          f"{k2['second_order_err']:.3e} (bars in CONV_BARS); "
          f"{k2['shape']} kernel {k2['ms']:.4f} ms, plain "
          f"{k2['plain_ms']:.4f} ms, library {k2['library_ms']:.4f} ms, "
          f"bound {k2['bound_ms']:.4f} ms ({k2['bound_by']}) ({card})")

    t = time.perf_counter()
    k3 = check_dblock_kernel(device)
    phase("K3 vs plain", t, f"bf16 max abs err {k3['max_abs_err']:.3e}, "
          f"f32 {k3['max_abs_err_f32']:.3e}; {k3['shape']} kernel "
          f"{k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, library "
          f"{k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms "
          f"({k3['bound_by']}) ({card})")

    t = time.perf_counter()
    generator, step, stage = load_ema_generator(
        os.path.join(FLAGSHIP, "ema.npz"), config.model, device)
    rms, err, snr = render_flagship(device, config, generator, stage)
    phase("flagship render", t, f"step {step} stage {stage} "
          f"{config.model.compute_dtype}; rms {[round(r, 4) for r in rms]}; "
          f"f32 card vs CPU, worst of {F32_NOTE_RUNS} runs, max err "
          f"{err:.3e}, SNR {snr:.1f} dB (bar 5e-3, 40 dB)")

    t = time.perf_counter()
    gaps = bf16_vs_reference(device, config)
    phase("bf16 vs reference", t, "mean |diff| " + ", ".join(
        f"{k} {v['mean_abs']:.3e}" for k, v in gaps.items())
        + " (bar in tests/torch_reference_data.py)")

    t = time.perf_counter()
    synthesis_spectrum.launches = 0
    health, _ = serve_requests(SynthesisService(
        config, generator, stage=stage, max_batch=MAX_BATCH,
        request_timeout_s=120.0))
    launches = synthesis_spectrum.launches
    if launches == 0:
        raise AssertionError("the main path never launched K1")
    phase("serve", t, f"served {health['requests_served']} requests in "
          f"{health['device_batches']} batches "
          f"({health['coalesced_batches']} coalesced); warm latency "
          f"{health['warm_latency_s']}; K1 launches {launches}")

    del generator
    torch.cuda.empty_cache()
    t = time.perf_counter()
    train = train_steps(device)
    phase("train", t, f"stage {train['stage']} alpha {train['alpha']} batch "
          f"{train['batch']} {train['compute_dtype']}: {TRAIN_STEPS} steps, "
          f"mean {train['mean_step_ms']:.1f} ms/step; launches per step "
          f"{train['launches_per_step']}, traced on the device "
          f"{train['launches_traced_per_step']} ({card})")

    t = time.perf_counter()
    cmp = kernels_vs_plain_step(device)
    phase("f32 step, kernels vs plain", t, f"worst metric error "
          f"{cmp['worst_scaled_err']:.3e} of max(1, |metric|) (bar "
          f"{STEP_BAR})")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    loop, loop_ref = train_loop(card, train["mean_step_ms"])
    phase("train loop", t, f"cli train --device-cache, {loop['steps']} "
          f"steps at stage 6, unroll {loop['unroll']}: "
          f"{[round(v, 1) for v in loop['ms_per_step']]} ms/step by "
          f"steps_per_sec (a resumed call's "
          f"{loop['ms_per_step_resumed_call']:.1f}), single step "
          f"{loop['single_step_mean_ms']:.1f} ms; launches per step "
          f"{loop['launches_per_step']}; B vs A {loop['b_vs_a_max_abs']}, "
          f"A vs repeat {loop['a_vs_repeat_max_abs']}; STOP process "
          f"{loop['stop_process_seconds']:.1f}s; peak "
          f"{loop['peak_mem_gib']:.2f} GiB with {loop['cached_notes']} "
          f"notes cached ({card})")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    offline = offline_cli(card)
    ev = offline["evaluate"]
    phase("offline CLI", t, "generate, interpolate, evaluate, roundtrip, "
          f"validate-data; evaluate: {ev['notes']} notes rendered in "
          f"{ev['render_seconds']:.2f}s, scored in "
          f"{ev['metrics_seconds']:.2f}s, accuracies off by "
          f"{max(ev['accuracy_notes_off'].values()):.0f} notes (bar "
          f"{EVAL_NOTES_BAR}), worst relative "
          f"{max(ev['relative_diff'].values()):.3e}; roundtrip SNR "
          f"{offline['roundtrip_snr_db']:.2f} dB (reference "
          f"{offline['roundtrip_reference_snr_db']:.2f}); K1 launches "
          f"{offline['launches_total']['synthesis_spectrum']}; peak "
          f"{offline['peak_mem_gib']:.2f} GiB ({card})")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    exp = export_phase(card, config)
    phase("export", t, f"export-model --with-latent --check "
          f"{exp['export_model_seconds']:.2f}s (save {exp['save_seconds']:.2f}s)"
          f", {exp['mib']['seeded']:.1f} MiB seeded, "
          f"{exp['mib']['seeded_latent']:.1f} MiB with latent; check rel L2 "
          f"{exp['check_rel_l2']:.3g} (bound {exp['check_bound']}); load "
          f"{exp['load_seconds']:.2f}s; warm latency s exported/in-process "
          + ", ".join(f"B={r} {v['exported']}/{v['in_process']}"
                      for r, v in exp["warm_latency_s"].items())
          + "; in turns, median ms exported/latent program/in-process "
          + ", ".join(
              f"B={r} {v['exported']['median']:.2f}/"
              f"{v['latent_program']['median']:.2f}/"
              f"{v['in_process']['median']:.2f}"
              for r, v in exp["latency_ms_in_turns"].items())
          + "; same batch rel L2 " + str(max(
              g for v in exp["same_batch_rel_l2"].values()
              for g in v.values()))
          + f"; served vs in-process worst {max(exp['served_rel_l2']):.3g}; "
          f"K1 launches {exp['launches']} (interpolate "
          f"{exp['interpolate_launches']}); CPU vs card "
          f"{exp['cpu_vs_card_rel_l2']:.3g} ({exp['cpu_seconds']:.1f}s); "
          f"pallas export K2 launches {exp['pallas_launches']['conv3x3']}, "
          f"rel {exp['pallas_rel_l2']:.3g} ({card})")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    generator, _, stage = load_ema_generator(
        os.path.join(FLAGSHIP, "ema.npz"), config.model, device)
    dp = data_parallel(card, loop_ref, config, generator, stage)
    del generator
    tm = dp["timing"]
    rm = dp["remat"]
    phase("data parallel", t, f"cli train --data-parallel "
          f"{LOOP_CADENCE} steps ({dp['backend']}, 1 rank): distance to "
          f"phase 10's run A " + ", ".join(
              f"{k} {v}" for k, v in dp["distance_max_abs"].items())
          + f" (bar 2x {dp['a_vs_repeat_max_abs']}); launches "
          f"{dp['launches']}; NCCL {dp['nccl_version']}; cached superstep "
          f"graph vs eager in the group, {GRAPH_STEPS} steps, distance "
          + ", ".join(f"{k} {v['distance_max_abs']}"
                      for k, v in dp["cached_graph"].items())
          + f" ({dp['cached_graph_s']:.1f}s); step ms median in turns "
          + ", ".join(
              f"{k} {v['ms_per_step']['median']:.2f} (idle "
              f"{v['idle_share']:.3f}, API launches {v['api_launches']}, "
              f"K2/K3 traced {v['kernel_launches']['conv3x3']:.0f}/"
              f"{v['kernel_launches']['dblock']:.0f}, peak "
              f"{v['peak_mem_gib']:.2f} GiB)"
              for k, v in tm["forms"].items())
          + f" ({dp['timing_s']:.1f}s); all-reduce "
          f"{tm['all_reduce_ms_per_step']:.3f} ms a step; remat f32 peak "
          f"{rm['remat']['peak_mem_gib']:.2f} GiB vs "
          f"{rm['plain']['peak_mem_gib']:.2f}, "
          f"{rm['remat']['ms_per_step']:.1f} vs "
          f"{rm['plain']['ms_per_step']:.1f} ms/step, worst metric "
          f"{rm['worst_scaled_err']:.3e}; serve --data-parallel "
          f"{dp['serve']['mesh_devices']} card(s), K1 launches "
          f"{dp['serve']['launches']}, served vs in-process worst "
          f"{max(dp['serve']['served_rel_l2']):.3g} ({card})")

    torch.cuda.empty_cache()
    t = time.perf_counter()
    generator, _, stage = load_ema_generator(
        os.path.join(FLAGSHIP, "ema.npz"), config.model, device)
    cg = cuda_graphs_phase(card, config, generator, stage, device)
    del generator
    sv, tr = cg["serving"], cg["training"]
    phase("CUDA graphs", t, "graph vs eager, host ms median in turns: "
          + "; ".join(
              f"{path} " + ", ".join(
                  f"B={b} {row['graph']['host_ms']['median']:.3f}/"
                  f"{row['eager']['host_ms']['median']:.3f}"
                  for b, row in rows.items())
              for path, rows in sv.items())
          + "; idle share graph/eager in-process B=1 "
          f"{sv['in_process']['1']['graph']['idle_share']:.3f}/"
          f"{sv['in_process']['1']['eager']['idle_share']:.3f}, B=16 "
          f"{sv['in_process']['16']['graph']['idle_share']:.3f}/"
          f"{sv['in_process']['16']['eager']['idle_share']:.3f}; waves "
          f"equal at every rung; training {GRAPH_STEPS}-step superstep "
          f"distance {tr['distance_max_abs']}, ms/step median "
          f"{tr['graph']['ms_per_step']['median']:.2f} graph / "
          f"{tr['eager']['ms_per_step']['median']:.2f} eager, idle "
          f"{tr['graph']['idle_share']:.3f}/{tr['eager']['idle_share']:.3f},"
          f" API launches a step graph {tr['graph']['api_launches']}"
          f" eager {tr['eager']['api_launches']}; capture "
          f"{tr['capture_s']:.2f}s; peak {tr['graph']['peak_mem_gib']:.2f}/"
          f"{tr['eager']['peak_mem_gib']:.2f} GiB; launches a step "
          f"{tr['launches_per_step']}, on the device (traced) graph "
          f"{tr['graph']['kernel_launches']} eager "
          f"{tr['eager']['kernel_launches']} ({card})")

    def dp_count(name):
        return sum(launches[name] for launches in dp["launches"].values())

    conv_launches = (train["launches"]["conv3x3_forward"]
                     + train["launches"]["conv3x3_input_grad"])
    loop_launches = loop["launches"]
    kernels = [{
        "name": "synthesis_spectrum",
        "route": "cuda",
        "source": "gansynth_tpu_torch/kernels/csrc/synthesis_spectrum.cu",
        "replaces": "gansynth_tpu/kernels/pallas_synthesis.py:72",
        "launches": launches,
        "loop_launches": loop_launches["synthesis_spectrum"],
        "offline_launches": offline["launches_total"]["synthesis_spectrum"],
        "export_launches": exp["launches"],
        "dp_launches": dp["serve"]["launches"],
        "graph_launches": cg["k1_launches"]["graph"],
        "graph_eager_launches": cg["k1_launches"]["eager"],
        "graph_launches_per_replay": max(
            row["k1_launches_per_replay"] for rows in sv.values()
            for row in rows.values()),
        "graph_launches_traced_per_replay": max(
            row["graph"]["kernel_launches"]["synthesis_spectrum"]
            for rows in sv.values() for row in rows.values()
            if "kernel_launches" in row["graph"]),
        "max_abs_err": k1["max_abs_err"],
        **{k: k1[k] for k in ("ms", "graph_ms", "plain_ms", "plain_graph_ms",
                              "bound_ms", "bound_by", "fraction_of_bound",
                              "graph_fraction_of_bound", "library_ms",
                              "library_graph_ms")},
        "rungs": k1["rungs"],
        "resources": resources["synthesis_spectrum"],
    }, {
        "name": "conv3x3_same",
        "route": "cuda",
        "source": "gansynth_tpu_torch/kernels/csrc/conv3x3.cu",
        "replaces": "gansynth_tpu/kernels/pallas_conv.py:208",
        "launches": conv_launches,
        "launches_forward": train["launches"]["conv3x3_forward"],
        "launches_input_grad": train["launches"]["conv3x3_input_grad"],
        "loop_launches": (loop_launches["conv3x3_forward"]
                          + loop_launches["conv3x3_input_grad"]),
        "max_abs_err": k2["max_abs_err"],
        "max_abs_err_f32": k2["max_abs_err_f32"],
        "shape": k2["shape"],
        **{k: k2[k] for k in TIMES},
        "shapes": [{"shape": row["shape"], **{k: row[k] for k in TIMES}}
                   for row in k2["shapes"]],
        "sample_shapes": [{"shape": row["shape"],
                           **{k: row[k] for k in TIMES}}
                          for row in k2["sample_shapes"]],
        "offline_launches": offline["launches_total"]["conv3x3"],
        "export_launches": exp["pallas_launches"]["conv3x3"],
        "dp_launches": dp_count("conv3x3_forward")
        + dp_count("conv3x3_input_grad"),
        "dp_graph_launches_traced_per_replay":
            tm["forms"]["group_graph"]["kernel_launches"]["conv3x3"],
        "remat_launches": rm["remat"]["launches"]["conv3x3_forward"]
        + rm["remat"]["launches"]["conv3x3_input_grad"],
        "remat_recompute_launches":
            rm["remat"]["launches"]["conv3x3_recompute"],
        "launches_traced_per_step":
            train["launches_traced_per_step"]["conv3x3"],
        "graph_launches": cg["k2_launches"]["graph"],
        "graph_eager_launches": cg["k2_launches"]["eager"],
        "graph_launches_per_replay":
            tr["launches_per_step"]["conv3x3_forward"]
            + tr["launches_per_step"]["conv3x3_input_grad"],
        "graph_launches_traced_per_replay":
            tr["graph"]["kernel_launches"]["conv3x3"],
        "measured_only": k2["measured_only"],
        "resources": resources["conv3x3"],
    }, {
        "name": "fused_dblock",
        "route": "cuda",
        "source": "gansynth_tpu_torch/kernels/csrc/dblock.cu",
        "replaces": "gansynth_tpu/kernels/pallas_dblock.py:198",
        "launches": train["launches"]["dblock"],
        "loop_launches": loop_launches["dblock"],
        "dp_launches": dp_count("dblock"),
        "dp_graph_launches_traced_per_replay":
            tm["forms"]["group_graph"]["kernel_launches"]["dblock"],
        "remat_launches": rm["remat"]["launches"]["dblock"],
        "remat_recompute_launches":
            rm["remat"]["launches"]["dblock_recompute"],
        "launches_traced_per_step":
            train["launches_traced_per_step"]["dblock"],
        "graph_launches": cg["k3_launches"]["graph"],
        "graph_eager_launches": cg["k3_launches"]["eager"],
        "graph_launches_per_replay": tr["launches_per_step"]["dblock"],
        "graph_launches_traced_per_replay":
            tr["graph"]["kernel_launches"]["dblock"],
        "max_abs_err": k3["max_abs_err"],
        "max_abs_err_f32": k3["max_abs_err_f32"],
        "shape": k3["shape"],
        **{k: k3[k] for k in TIMES},
        "resources": resources["dblock"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total seconds: {time.perf_counter() - T0:.2f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
