"""Hand-written CUDA kernels, their builder and their plain versions.

Nothing is built at import time: ``_build.load_library`` runs ``nvcc`` on
the first launch of a kernel.

:func:`recomputing` marks a rematerialised forward pass
(``models.layers.remat_call``): a wrapper launching its kernel inside it
counts the launch apart from the model's own.

:func:`launch_counts` and :func:`add_launch_counts` read and move every
wrapper's launch counters at once, :func:`launch_shapes` and
:func:`add_launch_shapes` K2's launches by shape, and
:func:`gen_epilogue_shapes` and :func:`add_gen_epilogue_shapes` K4's, so
that a CUDA graph (``utils/graphs.py``) can take back what its capture
counted (a capture launches nothing) and add it at every replay.
"""

import contextlib
import threading
from typing import Dict

_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """Inside: kernel launches are a rematerialisation's (thread-local, as
    the backward pass runs on the autograd engine's thread)."""
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = False


def is_recomputing() -> bool:
    return getattr(_RECOMPUTE, "on", False)


def _counted():
    from gansynth_tpu_torch.kernels.conv import conv3x3_same
    from gansynth_tpu_torch.kernels.dblock import fused_dblock
    from gansynth_tpu_torch.kernels.gen_epilogue import gen_epilogue
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum

    return conv3x3_same, fused_dblock, synthesis_spectrum, gen_epilogue


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by name: ``conv3x3_forward``,
    ``conv3x3_input_grad``, ``conv3x3_recompute``, ``dblock``,
    ``dblock_recompute``, ``dblock_backward`` (K3's backwards through its
    kernels), ``dblock_backward_plain`` (through the plain adjoints, on a
    card), ``synthesis_spectrum``, ``gen_epilogue_forward``,
    ``gen_epilogue_backward``, ``gen_epilogue_recompute``."""
    conv, dblock, synthesis, epilogue = _counted()
    return {**{f"conv3x3_{k}": v for k, v in conv.launches.items()},
            "dblock": dblock.launches,
            "dblock_recompute": dblock.recompute_launches,
            "dblock_backward": dblock.backwards["kernel"],
            "dblock_backward_plain": dblock.backwards["plain"],
            "synthesis_spectrum": synthesis.launches,
            **{f"gen_epilogue_{k}": v for k, v in epilogue.launches.items()}}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`) to the counters."""
    conv, dblock, synthesis, epilogue = _counted()
    for k, v in delta.items():
        if k.startswith("conv3x3_"):
            conv.launches[k[len("conv3x3_"):]] += v
        elif k.startswith("gen_epilogue_"):
            epilogue.launches[k[len("gen_epilogue_"):]] += v
        elif k == "dblock":
            dblock.launches += v
        elif k == "dblock_recompute":
            dblock.recompute_launches += v
        elif k == "dblock_backward":
            dblock.backwards["kernel"] += v
        elif k == "dblock_backward_plain":
            dblock.backwards["plain"] += v
        elif k == "synthesis_spectrum":
            synthesis.launches += v
        else:
            raise KeyError(k)


def launch_shapes() -> Dict[tuple, int]:
    """K2's launches by ``(role, B, H, W, C_in, C_out)``, ``role`` as in
    :func:`launch_counts` (``"forward"``, ``"input_grad"``,
    ``"recompute"``)."""
    return dict(_counted()[0].shapes)


def _add_shapes(shapes: Dict[tuple, int], delta: Dict[tuple, int]) -> None:
    for k, v in delta.items():
        n = shapes.get(k, 0) + v
        if n:
            shapes[k] = n
        else:
            shapes.pop(k, None)


def add_launch_shapes(delta: Dict[tuple, int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_shapes`) to K2's record; a
    shape whose count comes to 0 leaves it."""
    _add_shapes(_counted()[0].shapes, delta)


def gen_epilogue_shapes() -> Dict[tuple, int]:
    """K4's launches by ``(role, B, H, W, C)``, ``role`` ``"forward"``,
    ``"backward"`` or ``"recompute"``."""
    return dict(_counted()[3].shapes)


def add_gen_epilogue_shapes(delta: Dict[tuple, int]) -> None:
    """Add ``delta`` (keyed as :func:`gen_epilogue_shapes`) to K4's
    record; a shape whose count comes to 0 leaves it."""
    _add_shapes(_counted()[3].shapes, delta)
