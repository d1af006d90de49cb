"""Weights of the reference carried into the port.

``gansynth_tpu``'s ``save_ema_npz`` writes one array per parameter under
its flax path (``"['params']['block_0']['conv0']['kernel']"``), plus
``__step__`` and ``__stage__``. :func:`from_jax_params` maps those arrays,
or a flax parameter tree, of either network onto the port's state dict:
the generator's ``latent_dense``, ``block_i`` and ``to_rgb_i``; the
critic's ``from_rgb_i``, ``block_i.conv0/conv1``, ``final_conv``,
``final_dense``, ``critic_head`` and ``pitch_head``. Conv kernels go from
HWIO to OIHW, dense kernels from [in, out] to [out, in].
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_FLAX_KEY = re.compile(r"\['([^']+)'\]")


def load_ema_npz(path: str) -> Tuple[Dict[str, np.ndarray], int, Optional[int]]:
    """``(params, step, stage-or-None)``; ``params`` maps the reference's
    keys to numpy arrays."""
    with np.load(path) as data:
        params = {k: data[k] for k in data.files if not k.startswith("__")}
        step = int(data["__step__"])
        stage = int(data["__stage__"]) if "__stage__" in data.files else None
    return params, step, stage


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def _port_name(path: Tuple[str, ...]) -> str:
    """('block_3', 'conv1', 'kernel') -> 'blocks.3.conv1.weight'."""
    *mods, leaf = path
    names = []
    for m in mods:
        for prefix, port in (("block_", "blocks."), ("to_rgb_", "to_rgb."),
                             ("from_rgb_", "from_rgb.")):
            if m.startswith(prefix):
                m = port + m[len(prefix):]
                break
        names.append(m)
    return ".".join(names + ["weight" if leaf == "kernel" else leaf])


def from_jax_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """Parameters of the reference (generator or critic) -> the port's
    state dict.

    ``params`` is either a flax tree (``{'params': {...}}`` or its inner
    dict) or the flat mapping :func:`load_ema_npz` returns.
    """
    if any(isinstance(v, Mapping) for v in params.values()):
        flat = _flatten(params)
    else:
        flat = {k: np.asarray(v) for k, v in params.items()}
    state = {}
    for key, arr in flat.items():
        path = tuple(_FLAX_KEY.findall(key))
        if path and path[0] == "params":
            path = path[1:]
        if not path or path[-1].startswith("__"):
            continue
        arr = arr.astype(np.float32)
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        state[_port_name(path)] = torch.from_numpy(np.ascontiguousarray(arr))
    return state


def load_ema_generator(path: str, model_config, device="cuda"):
    """Build the port's generator from an ``ema.npz``:
    ``(generator in eval mode on device, step, stage-or-None)``."""
    from gansynth_tpu_torch.models.generator import Generator
    from gansynth_tpu_torch.utils.device import resolve_device

    params, step, stage = load_ema_npz(path)
    g = Generator(model_config)
    g.load_state_dict(from_jax_params(params))
    return g.to(resolve_device(device)).eval(), step, stage
