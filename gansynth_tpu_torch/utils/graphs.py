"""CUDA graphs: the port's counterpart of the reference's compiled programs.

The JAX package never dispatches its hot paths op by op from Python. It
compiles one program per serving rung (``jax.jit`` of
``gansynth_tpu/synth/sampler.py:_seeded_body``, warmed per rung by
``gansynth_tpu/serve.py``) and fuses ``unroll`` training steps into one
``lax.scan`` program (``gansynth_tpu/train/step.py:make_superstep``). On a
card the port captures the same work once into a CUDA graph and replays
it: one ``cudaGraphLaunch`` where Python would dispatch a serving batch's
hundreds, or a training step's thousands, of kernel launches.

:class:`Graph` captures ``fn()``. A warm-up call on a side stream comes
first: cuDNN's, cuBLAS's and cuFFT's plans, the constant caches
(``ops/spectral.py:constant_cache``), the kernels' builds and first-use
allocations are settled there, since none of them may happen inside a
capture. The capture then records ``fn`` into a private memory pool, whose
tensors keep their addresses from replay to replay. Whatever ``fn`` reads
must be a tensor at a fixed address (a static input that the caller
copies into before a replay); a Python value that it reads is frozen at
the capture. Kernel launches that the wrappers counted during the capture
are taken back (a capture launches nothing) and added again at every
replay (``kernels.launch_counts``); the warm-up's launches are real and
stay counted.

:class:`GraphedCall` is ``fn(*tensors) -> tensor or tuple of tensors``
with one graph per input shape (a serving rung), all in one pool: the
host copies the inputs into the graph's static buffers, replays it and
gets a copy of each output. Given a module to ``watch``, it captures
anew when that module's parameters or buffers move to other addresses
(a graph holds the addresses it read). :func:`on_device` picks it on a
card and the eager call of the same ``fn`` elsewhere.

A capture's error mode (``capture_error_mode`` of ``torch.cuda.graph``)
is ``"global"`` unless the caller asks for another: a data-parallel step
captures ``"thread_local"``, because NCCL's watchdog thread may query
CUDA events while the step is captured, and in the global mode such a
call from another thread fails the capture.

A capture or a replay that fails raises; nothing falls back to eager
execution. Only CUDA has graphs: a caller on the CPU calls its function
directly.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, Optional

import torch

from gansynth_tpu_torch.kernels import add_launch_counts, launch_counts


def available(device) -> bool:
    """Whether ``device`` has CUDA graphs (a card; not the CPU)."""
    return torch.device(device).type == "cuda"


def _delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _warm_up(fn: Callable, device: torch.device, calls: int) -> None:
    """``fn()`` ``calls`` times on a side stream, ordered after the current
    stream's work and before its next."""
    with torch.cuda.device(device):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(calls):
                fn()
        current.wait_stream(side)


def _capture(fn: Callable, device: torch.device, pool, mode: str):
    """``(graph, outputs)``: ``fn()`` captured on ``device`` into ``pool``
    (a fresh private pool when None) in the error mode ``mode``."""
    with torch.cuda.device(device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool, capture_error_mode=mode):
            outputs = fn()
    return graph, outputs


class Graph:
    """``fn()`` captured once on ``device``; :meth:`replay` runs it again
    on the current stream and returns the outputs of the capture (static
    tensors, overwritten by the next replay).

    ``warmup`` calls of ``fn`` run first, for real; ``before_capture``
    runs between them and the capture (to undo what the warm-up changed).
    :attr:`capture_seconds` is the capture's host time, the device's
    synchronisation at its start included.
    ``pool`` shares another graph's memory pool (:meth:`pool`): safe
    where the graphs never run at once, as on one stream. ``mode`` is the
    capture's error mode (see the module's docstring)."""

    def __init__(self, fn: Callable, device, *, warmup: int = 1, pool=None,
                 before_capture: Optional[Callable[[], None]] = None,
                 mode: str = "global"):
        self.device = torch.device(device)
        _warm_up(fn, self.device, warmup)
        if before_capture is not None:
            before_capture()
        before = launch_counts()
        t0 = time.perf_counter()
        try:
            self._graph, self.outputs = _capture(fn, self.device, pool,
                                                 mode)
            self.capture_seconds = time.perf_counter() - t0
        finally:
            after = launch_counts()
            self.launches = _delta(after, before)
            add_launch_counts(_delta(before, after))

    def pool(self):
        return self._graph.pool()

    def replay(self):
        self._graph.replay()
        add_launch_counts(self.launches)
        return self.outputs


def on_device(fn: Callable, device, graphs: bool = True,
              watch: Optional[torch.nn.Module] = None) -> Callable:
    """``fn(*tensors)`` on ``device``, the inputs on any device: a
    :class:`GraphedCall` on a card (unless ``graphs`` is False), else
    ``fn`` run eagerly on the inputs moved to ``device``. Either way the
    same ``fn`` runs."""
    device = torch.device(device)
    if graphs and available(device):
        return GraphedCall(fn, device, watch=watch)

    def call(*args: torch.Tensor):
        return fn(*(a.to(device) for a in args))

    return call


class GraphedCall:
    """``fn(*tensors) -> tensor or tuple of tensors`` on ``device`` with one
    :class:`Graph` per input signature (shapes and types), captured on its
    first call; the graphs share one pool. The inputs may live on any
    device; the results are fresh tensors on ``device``. With ``watch``,
    every graph is dropped (and captured again at its next call) when the
    module's parameters or buffers are no longer where the graphs read
    them."""

    def __init__(self, fn: Callable, device, warmup: int = 1,
                 watch: Optional[torch.nn.Module] = None):
        self.fn = fn
        self.device = torch.device(device)
        self.warmup = warmup
        self.watch = watch
        self.graphs: Dict[tuple, tuple] = {}
        self._pool = None
        self._addresses = self._watched()

    def _watched(self) -> tuple:
        if self.watch is None:
            return ()
        return tuple(t.data_ptr() for t in itertools.chain(
            self.watch.parameters(), self.watch.buffers()))

    def __call__(self, *args: torch.Tensor):
        addresses = self._watched()
        if addresses != self._addresses:
            self.graphs.clear()   # frees their pool before the next capture
            self._pool = None
            self._addresses = addresses
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self.graphs.get(key)
        if entry is None:
            static = [a.to(self.device, copy=True) for a in args]
            graph = Graph(lambda: self.fn(*static), self.device,
                          warmup=self.warmup, pool=self._pool)
            if self._pool is None:
                self._pool = graph.pool()
            entry = self.graphs[key] = (static, graph)
        static, graph = entry
        for buf, a in zip(static, args):
            buf.copy_(a, non_blocking=True)
        out = graph.replay()
        if torch.is_tensor(out):
            return out.clone()
        return tuple(t.clone() for t in out)
