"""Hand-written CUDA kernels, their builder and their plain versions.

Nothing is built at import time: ``_build.load_library`` runs ``nvcc`` on
the first launch of a kernel.

:func:`recomputing` marks a rematerialised forward pass
(``models.layers.remat_call``): a wrapper launching its kernel inside it
counts the launch apart from the model's own.

:func:`launch_counts` and :func:`add_launch_counts` read and move every
wrapper's launch counters at once, so that a CUDA graph
(``utils/graphs.py``) can take back what its capture counted (a capture
launches nothing) and add it at every replay.
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
    from gansynth_tpu_torch.kernels.synthesis import synthesis_spectrum

    return conv3x3_same, fused_dblock, synthesis_spectrum


def launch_counts() -> Dict[str, int]:
    """Every kernel wrapper's launch counter, by name: ``conv3x3_forward``,
    ``conv3x3_input_grad``, ``conv3x3_recompute``, ``dblock``,
    ``dblock_recompute``, ``synthesis_spectrum``."""
    conv, dblock, synthesis = _counted()
    return {**{f"conv3x3_{k}": v for k, v in conv.launches.items()},
            "dblock": dblock.launches,
            "dblock_recompute": dblock.recompute_launches,
            "synthesis_spectrum": synthesis.launches}


def add_launch_counts(delta: Dict[str, int]) -> None:
    """Add ``delta`` (keyed as :func:`launch_counts`) to the counters."""
    conv, dblock, synthesis = _counted()
    for k, v in delta.items():
        if k.startswith("conv3x3_"):
            conv.launches[k[len("conv3x3_"):]] += v
        elif k == "dblock":
            dblock.launches += v
        elif k == "dblock_recompute":
            dblock.recompute_launches += v
        elif k == "synthesis_spectrum":
            synthesis.launches += v
        else:
            raise KeyError(k)
