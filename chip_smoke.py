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
   of the service, and to its own bits over ``K1_REPEATS`` repeats; time
   the kernel, the plain version and the PyTorch library form with CUDA
   events: back-to-back eager calls (``ms``, as for K2 and K3) and the
   same calls replayed from a CUDA graph (``graph_ms``, the device's time
   with the host's cost of a call taken away);
4. hold K2 to ``F.conv2d`` (TF32 off) at every shape the stage-6 training
   step gives it, in bf16 and f32: the forward, and dx and dw through
   autograd; a second-order (gradient-penalty) gradient at a small shape;
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
   launches are counted over this phase);
8. training: the flagship config (``Config.released()``,
   ``conv_kernel="pallas"``, ``dblock_kernel="pallas"``) at stage 6,
   batch 8, G and EMA from ``ema.npz``, D from a seeded init, Adam fresh:
   one warm-up step, then 3 steps timed with CUDA events, with K2's and
   K3's launches counted over the 3 steps; the metrics must be finite and
   both networks must move;
9. the same step in float32 from one state (so one drawn noise), once
   with the kernels and once with ``conv_kernel="xla"`` /
   ``dblock_kernel="xla"``, metric by metric;
10. one JSON line with every kernel's launches on its path, error,
    times (K2 at every shape; the library call also under
    ``cudnn.benchmark``; the fraction of the bound reached) and its
    registers, spills and shared memory from ``ptxas``; the total
    seconds; and the result line.

The script exits non-zero, printing no result, where CUDA is not
available or the port is not beside it. It writes nothing outside
``build/``.
"""

import concurrent.futures
import json
import math
import os
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
K3_SHAPE = (8, 128, 1024, 128)   # (B, H, W, C1): D block_6
TRAIN_STEPS = 3
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
    ladder (1, 4, 16); the B=16 times are the headline. ``resources`` (the
    kernel's ``ptxas`` report) goes into each rung's line."""
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
    for batch in batch_ladder(MAX_BATCH):
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
        result.update(times)   # the last rung's, B=16, are kept
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
    types; the second order at a small shape; bf16 times."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_plain, conv3x3_same

    result = {"max_abs_err": 0.0, "max_abs_err_f32": 0.0, "shapes": []}
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
    K2's and K3's launches counted."""
    import torch

    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock
    from gansynth_tpu_torch.train.step import make_train_step

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
           "g_max_move": g_move, "d_max_move": d_move,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "metrics": metrics}
    print(json.dumps({"train": out}), flush=True)
    return out


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


def serve_requests(config, generator, stage):
    """The main path: service + HTTP server, 4 concurrent requests."""
    from gansynth_tpu_torch.serve import SynthesisService, make_server

    service = SynthesisService(config, generator, stage=stage,
                               max_batch=MAX_BATCH,
                               request_timeout_s=120.0)
    server = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="http")
    thread.start()
    url = "http://%s:%d" % server.server_address
    requests = [[36], [48, 60], [72], [84, 60, 36]]
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
    return health


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
    health = serve_requests(config, generator, stage)
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
          f"{train['launches_per_step']} ({card})")

    t = time.perf_counter()
    cmp = kernels_vs_plain_step(device)
    phase("f32 step, kernels vs plain", t, f"worst metric error "
          f"{cmp['worst_scaled_err']:.3e} of max(1, |metric|) (bar "
          f"{STEP_BAR})")

    conv_launches = (train["launches"]["conv3x3_forward"]
                     + train["launches"]["conv3x3_input_grad"])
    kernels = [{
        "name": "synthesis_spectrum",
        "route": "cuda",
        "source": "gansynth_tpu_torch/kernels/csrc/synthesis_spectrum.cu",
        "replaces": "gansynth_tpu/kernels/pallas_synthesis.py:72",
        "launches": launches,
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
        "max_abs_err": k2["max_abs_err"],
        "max_abs_err_f32": k2["max_abs_err_f32"],
        "shape": k2["shape"],
        **{k: k2[k] for k in TIMES},
        "shapes": [{"shape": row["shape"], **{k: row[k] for k in TIMES}}
                   for row in k2["shapes"]],
        "measured_only": k2["measured_only"],
        "resources": resources["conv3x3"],
    }, {
        "name": "fused_dblock",
        "route": "cuda",
        "source": "gansynth_tpu_torch/kernels/csrc/dblock.cu",
        "replaces": "gansynth_tpu/kernels/pallas_dblock.py:198",
        "launches": train["launches"]["dblock"],
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
