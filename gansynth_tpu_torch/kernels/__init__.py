"""Hand-written CUDA kernels, their builder, their plain versions and the
record of their launches.

Nothing is built at import time: ``_build.load_library`` runs ``nvcc`` on
the first launch of a kernel; ``_build.symbol`` binds a C entry and
``_build.launch`` calls it.

Every wrapper files each launch with :func:`count` in one record, keyed
by ``(kernel, role, *shape)``. :func:`recomputing` marks a rematerialised
forward pass (``models.layers.remat_call``): a launch inside it is filed
under the role ``"recompute"``. :func:`record` copies the record and
:func:`add` moves it, so that a CUDA graph (``utils/graphs.py``) can take
back what its capture counted (a capture launches nothing) and add it at
every replay. :func:`launch_counts`, :func:`launch_shapes` and
:func:`gen_epilogue_shapes` are read-only views of it.
"""

import contextlib
import threading
from collections import Counter
from typing import Dict, Mapping

_RECOMPUTE = threading.local()
_RECORD: Counter = Counter()
_LOCK = threading.Lock()   # the serving, autograd and capture threads count

# launch_counts()'s names by (kernel, role), in its order.
_NAMES = {
    ("conv3x3", "forward"): "conv3x3_forward",
    ("conv3x3", "input_grad"): "conv3x3_input_grad",
    ("conv3x3", "recompute"): "conv3x3_recompute",
    ("dblock", "forward"): "dblock",
    ("dblock", "recompute"): "dblock_recompute",
    ("dblock", "backward"): "dblock_backward",
    ("dblock", "backward_plain"): "dblock_backward_plain",
    ("synthesis_spectrum", "forward"): "synthesis_spectrum",
    ("gen_epilogue", "forward"): "gen_epilogue_forward",
    ("gen_epilogue", "backward"): "gen_epilogue_backward",
    ("gen_epilogue", "recompute"): "gen_epilogue_recompute",
    ("from_rgb", "forward"): "from_rgb_forward",
    ("from_rgb", "contract"): "from_rgb_contract",
    ("from_rgb", "expand"): "from_rgb_expand",
    ("from_rgb", "recompute"): "from_rgb_recompute",
    ("conv1d_wgrad", "conv"): "conv1d_wgrad_conv",
    ("conv1d_wgrad", "transpose"): "conv1d_wgrad_transpose",
}


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


def count(kernel: str, role: str, *shape: int) -> None:
    """One launch of ``kernel`` (``"conv3x3"``, ``"dblock"``,
    ``"synthesis_spectrum"``, ``"gen_epilogue"``, ``"from_rgb"``,
    ``"conv1d_wgrad"``) in ``role`` (``"forward"``, ``"input_grad"``,
    ``"backward"``, ``"backward_plain"``, ``"contract"``, ``"expand"``,
    ``"conv"``, ``"transpose"``; ``"recompute"`` inside
    :func:`recomputing`) at ``shape``: K2 ``(B, H, W, C_in, C_out)``, K3
    ``(B, H, W, C1)``, K4 ``(B, H, W, C)``, K5 ``(B, H, W, C_out)``, K6
    ``(B, L, C_in, C_out)``, K1 ``(B,)``."""
    key = (kernel, "recompute" if is_recomputing() else role, *shape)
    with _LOCK:
        _RECORD[key] += 1


def record() -> Counter:
    """A copy of the record: launches by ``(kernel, role, *shape)``."""
    with _LOCK:
        return Counter(_RECORD)


def add(delta: Mapping[tuple, int]) -> None:
    """Add ``delta`` (keyed as :func:`record`) to the record; a key whose
    count comes to 0 leaves it."""
    with _LOCK:
        for key, n in delta.items():
            total = _RECORD[key] + n
            if total:
                _RECORD[key] = total
            else:
                _RECORD.pop(key, None)


def launch_counts() -> Dict[str, int]:
    """Launches by name, over every shape: ``conv3x3_forward``,
    ``conv3x3_input_grad``, ``conv3x3_recompute``, ``dblock``,
    ``dblock_recompute``, ``dblock_backward`` (K3's backwards through its
    kernels), ``dblock_backward_plain`` (through the plain adjoints, on a
    card), ``synthesis_spectrum``, ``gen_epilogue_forward``,
    ``gen_epilogue_backward``, ``gen_epilogue_recompute``,
    ``from_rgb_forward``, ``from_rgb_contract``, ``from_rgb_expand``,
    ``from_rgb_recompute`` (K5's calls, a contract with its partial sums
    one), ``conv1d_wgrad_conv``, ``conv1d_wgrad_transpose`` (K6's calls
    for a conv's weight gradient and for the weight term of its input
    gradient's gradient, the split sum one); a launch that none of them
    names (K1's inside :func:`recomputing`) under ``<kernel>_<role>``."""
    counts = dict.fromkeys(_NAMES.values(), 0)
    for (kernel, role, *_), n in record().items():
        name = _NAMES.get((kernel, role), f"{kernel}_{role}")
        counts[name] = counts.get(name, 0) + n
    return counts


def _by_shape(kernel: str) -> Dict[tuple, int]:
    return {(role, *shape): n
            for (k, role, *shape), n in record().items() if k == kernel}


def launch_shapes() -> Dict[tuple, int]:
    """K2's launches by ``(role, B, H, W, C_in, C_out)``, ``role``
    ``"forward"``, ``"input_grad"`` or ``"recompute"``."""
    return _by_shape("conv3x3")


def gen_epilogue_shapes() -> Dict[tuple, int]:
    """K4's launches by ``(role, B, H, W, C)``, ``role`` ``"forward"``,
    ``"backward"`` or ``"recompute"``."""
    return _by_shape("gen_epilogue")
