"""A/B timing of other sources of a kernel library against the package's.

    python -m gansynth_tpu_torch.utils.kernel_ab conv3x3 OTHER.cu [...]
    python -m gansynth_tpu_torch.utils.kernel_ab dblock OTHER.cu [...]
    python -m gansynth_tpu_torch.utils.kernel_ab synthesis OTHER.cu [...]

Each ``OTHER.cu`` is a variant of ``kernels/csrc/<name>.cu`` (for
``synthesis``, of ``synthesis_spectrum.cu``) with the same ``extern "C"``
entries (its quoted includes resolve next to it, so an older design with
another interface can be timed through a small adapter file that includes
it). Every source is built with plain ``nvcc`` and the package's flags
into ``build/kernel_ab/``; then, at each shape of the kernel's path on the
card (K2: the five bf16 shapes of the stage-6 step and a ragged one; K3:
the flagship shape and two ragged ones; K1: the service's batch rungs 1,
4 and 16), every build's output is held to the plain version (K2, K3: the
bf16 output within 3e-2 of its scale, the card tests' bar; K1: Re and Im
within 2e-2) and timed with CUDA events, in turns: the package, each
variant, then the same in reverse, so that two readings of each bracket
the others (K1, whose device time is below the host's cost of a call, is
also timed from a CUDA graph of 20 calls, ``graph_ms``). One JSON line per
shape; a variant whose output misses the bar is reported with
``"ok": false`` and still timed. Nothing of this runs on
the training or serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from gansynth_tpu_torch.kernels import _build
from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import synthesis as K1
from gansynth_tpu_torch.utils.config import AudioConfig

SHAPES = {
    # (B, H, W, C_in, C_out)
    "conv3x3": [(8, 64, 512, 128, 256), (8, 64, 512, 256, 128),
                (8, 64, 512, 128, 128), (8, 32, 256, 256, 256),
                (8, 16, 128, 256, 256), (1, 5, 37, 24, 40)],
    # (B, H, W, C1)
    "dblock": [(8, 128, 1024, 128), (1, 12, 20, 72), (1, 20, 40, 72)],
    # (B, T, M): the service's batch rungs
    "synthesis": [(1, 128, 1024), (4, 128, 1024), (16, 128, 1024)],
}
MODULES = {"conv3x3": K2, "dblock": K3, "synthesis": K1}
# (bar, whether it is taken of the output's scale)
BARS = {"conv3x3": (3e-2, True), "dblock": (3e-2, True),
        "synthesis": (2e-2, False)}


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def graph_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Mean milliseconds of one call of ``fn`` when ``calls`` calls are
    captured in a CUDA graph and the graph is replayed ``replays`` times:
    the device's time with the host's launch cost taken away."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def _randn(shape, seed, dtype, scale=1.0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def build_variant(name: str, source: Path, out_dir: Path) -> ctypes.CDLL:
    """``source`` built like the package's ``csrc/<name>.cu``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(str(source.resolve()).encode()).hexdigest()[:12]
    lib = out_dir / f"lib{name}_{tag}.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
           str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    return ctypes.CDLL(str(lib))


def _cases(name: str, shape):
    """(run, plain) closures of the module's wrapper at ``shape``."""
    if name == "synthesis":
        b, t, m = shape
        config = AudioConfig()
        gen = torch.Generator(device="cuda").manual_seed(1000 + b)
        image = torch.rand((b, t, m, 2), generator=gen, device="cuda") * 2 - 1
        return (lambda: K1.synthesis_spectrum(image, config),
                lambda: K1.synthesis_spectrum_plain(image, config))
    if name == "conv3x3":
        b, h, w, c_in, c_out = shape
        x = _randn((b, h, w, c_in), 1, torch.bfloat16)
        wt = _randn((c_out, c_in, 3, 3), 2, torch.bfloat16,
                    (9 * c_in) ** -0.5)
        return (lambda: K2.conv3x3_same(x, wt),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), wt,
                                 padding=1).permute(0, 2, 3, 1))
    b, h, w, c1 = shape
    args = [_randn((b, h, w, 64), 10, torch.bfloat16),
            _randn((64, 64, 3, 3), 11, torch.float32, 0.06),
            _randn((64,), 12, torch.float32, 0.1),
            _randn((c1, 64, 3, 3), 13, torch.float32, 0.06),
            _randn((c1,), 14, torch.float32, 0.1)]
    return (lambda: K3.fused_dblock(*args, 0.2),
            lambda: K3.dblock_plain(*args, 0.2))


def _parts(out):
    return [t.float() for t in (out if isinstance(out, tuple) else (out,))]


def _max_err(got, want) -> float:
    return max(float((g - w).abs().max())
               for g, w in zip(_parts(got), want))


def main(argv=None) -> int:
    from gansynth_tpu_torch.utils.device import card_info, set_precision

    p = argparse.ArgumentParser(prog="gansynth_tpu_torch.utils.kernel_ab")
    p.add_argument("name", choices=sorted(SHAPES))
    p.add_argument("sources", nargs="+", type=Path)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    set_precision()
    module = MODULES[args.name]
    bar, scaled = BARS[args.name]
    package_kernel = module._kernel
    out_dir = _build.PACKAGE_ROOT / "build" / "kernel_ab"
    kernels = {"package": package_kernel}
    for source in args.sources:
        lib = build_variant(args.name, source, out_dir)

        def variant(dtype, lib=lib):
            fn = getattr(lib, module._SYMBOLS[dtype])
            fn.argtypes = package_kernel(dtype).argtypes
            fn.restype = ctypes.c_int
            return fn

        kernels[str(source)] = variant
    order = list(kernels) + list(reversed(list(kernels)))
    card = card_info()
    try:
        for shape in SHAPES[args.name]:
            run, plain = _cases(args.name, shape)
            want = _parts(plain())
            scale = max(1.0, max(float(w.abs().max()) for w in want)) \
                if scaled else 1.0
            rows = {k: {"ms": [], "graph_ms": []} for k in kernels}
            for label in order:
                module._kernel = kernels[label]
                err = _max_err(run(), want)
                rows[label].update(max_abs_err=err, ok=err <= bar * scale)
                rows[label]["ms"].append(_time_ms(run))
                if args.name == "synthesis":   # launch-bound when eager
                    rows[label]["graph_ms"].append(graph_ms(run))
            print(json.dumps({"card": card, "kernel": args.name,
                              "shape": list(shape), "scale": scale,
                              "plain_ms": _time_ms(plain), **rows}),
                  flush=True)
    finally:
        module._kernel = package_kernel
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
