"""CUDA graphs simulated on the CPU, for the port's graph tests
(``test_torch_graphs.py``) and the data-parallel ranks that
``torch_dp_worker.py`` spawns (``test_torch_dp_graphs.py``).

Imports torch and the port, never JAX. :func:`install` replaces
``gansynth_tpu_torch/utils/graphs``' ``available``, ``_warm_up`` and
``_capture``: the warm-up runs ``fn``; the capture runs its Python (the
wrappers count, as they do in a real capture) and a replay runs it again.
With ``info["dry"]`` the capture runs nothing, as on a card, so what the
captured function reads from the host is read again at each replay: a
function that froze a host value at its capture shows it there. With
``info["fail"]`` the capture raises that message.
"""

import torch

from gansynth_tpu_torch.kernels import conv as K2
from gansynth_tpu_torch.kernels import dblock as K3
from gansynth_tpu_torch.kernels import gen_epilogue as K4
from gansynth_tpu_torch.kernels import (
    gen_epilogue_shapes,
    launch_counts,
    launch_shapes,
)
from gansynth_tpu_torch.kernels import synthesis as K1
from gansynth_tpu_torch.utils import graphs


def _set_count(name, value):
    if name.startswith("conv3x3_"):
        K2.conv3x3_same.launches[name[len("conv3x3_"):]] = value
    elif name.startswith("gen_epilogue_"):
        K4.gen_epilogue.launches[name[len("gen_epilogue_"):]] = value
    elif name == "dblock":
        K3.fused_dblock.launches = value
    elif name == "dblock_recompute":
        K3.fused_dblock.recompute_launches = value
    elif name == "dblock_backward":
        K3.fused_dblock.backwards["kernel"] = value
    elif name == "dblock_backward_plain":
        K3.fused_dblock.backwards["plain"] = value
    else:
        K1.synthesis_spectrum.launches = value


class FakeGraph:
    """A captured ``fn``: a replay reruns it with its launches' counting,
    by wrapper and by K2's and K4's shape, left to the bookkeeping (``replays``
    counts them) and copies what it returns into the capture's outputs (a
    tensor or a tuple of them)."""

    def __init__(self, fn, outputs=None):
        self.fn, self.outputs, self.replays = fn, outputs, 0

    def replay(self):
        self.replays += 1
        saved, shapes = launch_counts(), launch_shapes()
        epilogue_shapes = gen_epilogue_shapes()
        out = self.fn()
        for k, v in saved.items():   # a replay's counts are the Graph's
            _set_count(k, v)
        for record, kept in ((K2.conv3x3_same.shapes, shapes),
                             (K4.gen_epilogue.shapes, epilogue_shapes)):
            record.clear()
            record.update(kept)
        if torch.is_tensor(self.outputs):
            self.outputs.copy_(out)
        elif isinstance(self.outputs, tuple):
            for dst, src in zip(self.outputs, out):
                dst.copy_(src)

    def pool(self):
        return "pool"


def install(setattr) -> dict:
    """Simulate the graphs through ``setattr`` (pytest's
    ``monkeypatch.setattr``, or the builtin in a process of its own).
    Returns the switches and counters: ``captures``, ``modes`` (each
    capture's error mode), ``dry``, ``fail``."""
    info = {"captures": 0, "modes": [], "dry": False, "fail": None}

    def capture(fn, device, pool, mode):
        info["captures"] += 1
        info["modes"].append(mode)
        if info["fail"]:
            if not info["dry"]:
                fn()
            raise RuntimeError(info["fail"])
        if info["dry"]:
            return FakeGraph(fn), None
        out = fn()
        return FakeGraph(fn, out), out

    setattr(graphs, "available", lambda device: True)
    setattr(graphs, "_warm_up",
            lambda fn, device, calls: [fn() for _ in range(calls)])
    setattr(graphs, "_capture", capture)
    return info
