"""Hand-written CUDA kernels, their builder and their plain versions.

Nothing is built at import time: ``_build.load_library`` runs ``nvcc`` on
the first launch of a kernel.

:func:`recomputing` marks a rematerialised forward pass
(``models.layers.remat_call``): a wrapper launching its kernel inside it
counts the launch apart from the model's own.
"""

import contextlib
import threading

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
