"""Weights of the reference carried into the port, the EMA export and
the training checkpoints.

``gansynth_tpu``'s ``save_ema_npz`` writes one array per parameter under
its flax path (``"['params']['block_0']['conv0']['kernel']"``), plus
``__step__`` and ``__stage__``. :func:`from_jax_params` maps those arrays,
or a flax parameter tree, of either network onto the port's state dict:
the generator's ``latent_dense``, ``block_i`` and ``to_rgb_i``; the
critic's ``from_rgb_i``, ``block_i.conv0/conv1``, ``final_conv``,
``final_dense``, ``critic_head`` and ``pitch_head``; WaveGAN's
``z_project``, ``upconv_i`` and ``downconv_i`` too. Conv kernels go from
HWIO to OIHW, 1-D kernels from TF's [k, in, out] (a transposed conv's [k,
out, in]) to PyTorch's, dense kernels from [in, out] to [out, in];
:func:`to_jax_params` maps them back, and :func:`save_ema_npz` writes the
EMA generator in the reference's format, which ``cli serve`` of either
package reads.

:class:`Checkpointer` (``gansynth_tpu/utils/checkpoint.py``'s, without
orbax) keeps the whole training state, written with ``torch.save``, in
``<dir>/<step>/state.pt``: a directory named by the step's digits, which
``cli train`` lists to find the resume step and the supervisor watches as
a heartbeat. A step directory without ``state.pt`` is the reference's
(orbax: ``_CHECKPOINT_METADATA`` and ``default/``); the port does not
read it (:func:`orbax_steps` lists them), and a run that has only such
steps restores its EMA from ``ema.npz``.
"""

from __future__ import annotations

import os
import re
import shutil
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
            arr = arr.T if arr.ndim <= 3 else arr.transpose(3, 2, 0, 1)
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


_PORT_MODULES = {"blocks": "block_", "to_rgb": "to_rgb_",
                 "from_rgb": "from_rgb_"}


def _jax_path(name: str) -> Tuple[str, ...]:
    """'blocks.3.conv1.weight' -> ('block_3', 'conv1', 'kernel')."""
    parts, path = name.split("."), []
    while parts:
        part = parts.pop(0)
        if part in _PORT_MODULES and parts and parts[0].isdigit():
            part = _PORT_MODULES[part] + parts.pop(0)
        path.append(part)
    if path[-1] == "weight":
        path[-1] = "kernel"
    return tuple(path)


def to_jax_params(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_params`: the port's state dict ->
    the reference's flat parameters, keyed as ``jax.tree_util.keystr``
    writes them (``"['params']['block_0']['conv0']['kernel']"``), conv
    kernels OIHW -> HWIO, dense kernels [out, in] -> [in, out]."""
    flat = {}
    for name, value in state_dict.items():
        arr = value.detach().cpu().float().numpy()
        path = _jax_path(name)
        if path[-1] == "kernel":
            arr = arr.T if arr.ndim <= 3 else arr.transpose(2, 3, 1, 0)
        key = "".join(f"['{p}']" for p in ("params",) + path)
        flat[key] = np.ascontiguousarray(arr)
    return flat


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_ema_npz(path: str, ema: torch.nn.Module, step: int,
                 stage: Optional[int] = None,
                 dtype: Optional[str] = None) -> str:
    """The EMA generator alone as one ``.npz`` in the reference's format:
    every stage's parameters under their flax keys, ``__step__`` and, when
    given, ``__stage__`` (int64). ``dtype`` (e.g. ``"float16"``) casts
    the parameters on export. The file is replaced atomically (a temporary
    file, fsynced, then ``os.replace``): the loop rewrites it at every
    checkpoint and a crash must not leave a truncated archive."""
    arrays = to_jax_params(dict(ema.named_parameters()))
    if dtype is not None:
        arrays = {k: v.astype(dtype) for k, v in arrays.items()}
    arrays["__step__"] = np.asarray(step, np.int64)
    if stage is not None:
        arrays["__stage__"] = np.asarray(stage, np.int64)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def orbax_steps(directory: str):
    """The steps under ``directory`` that only the reference saved: step
    directories without the port's ``state.pt``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(p) for p in os.listdir(directory) if p.isdigit()
                  and not os.path.exists(os.path.join(directory, p,
                                                      Checkpointer.FILE)))


def refuse_orbax(directory: str) -> None:
    """Raises ``ValueError`` when the newest step under ``directory`` is
    one that only the reference saved (orbax): the port cannot read it,
    so a resumed run or an export from it would silently start from an
    older state."""
    foreign = orbax_steps(directory)
    if not foreign:
        return
    ours = [s for s in os.listdir(directory) if s.isdigit()
            and int(s) not in foreign]
    if max(foreign) > max((int(s) for s in ours), default=-1):
        raise ValueError(
            f"{directory}/{max(foreign)} is the reference's orbax checkpoint "
            "(no state.pt); the port cannot read it. Serve, generate or "
            "evaluate the run from its ema.npz, or train on in a fresh "
            "--model-dir")


class Checkpointer:
    """The full training state under ``directory/<step>/state.pt``: the
    three networks' and both Adams' state dicts (Adam's shared ``count``
    included), the key and the step. A save writes a temporary directory
    and renames it into place, so a listed step is always whole; the
    newest ``max_to_keep`` are kept. Saves are synchronous: :meth:`wait`
    and :meth:`close` have nothing to wait for."""

    FILE = "state.pt"

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self):
        """The saved steps, ascending: the step directories that hold
        ``state.pt``."""
        return sorted(int(p) for p in os.listdir(self.directory) if p.isdigit()
                      and os.path.exists(os.path.join(self.directory, p,
                                                      self.FILE)))

    def latest_step(self) -> Optional[int]:
        return max(self.steps(), default=None)

    def save(self, step: int, state) -> None:
        payload = {
            "g": state.g.state_dict(), "d": state.d.state_dict(),
            "ema": state.ema.state_dict(),
            "g_opt": state.g_opt.state_dict(),
            "d_opt": state.d_opt.state_dict(),
            "rng": [int(w) for w in state.rng], "step": int(state.step),
        }
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, self.FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):   # the same step saved again
            old = f"{tmp}-old"
            os.rename(final, old)
            os.rename(tmp, final)
            shutil.rmtree(old)
        else:
            os.rename(tmp, final)
        _fsync_dir(self.directory)
        for old_step in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old_step)))

    def restore(self, template, step: Optional[int] = None):
        """Load checkpoint ``step`` (the latest when None) into
        ``template`` in place, on its devices: ``(state, step)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(template.g.parameters()).device
        payload = torch.load(
            os.path.join(self.directory, str(step), self.FILE),
            map_location=device, weights_only=True)
        for name in ("g", "d", "ema", "g_opt", "d_opt"):
            getattr(template, name).load_state_dict(payload[name])
        template.rng = tuple(int(w) for w in payload["rng"])
        template.step = int(payload["step"])
        return template, step

    def wait(self) -> None:
        """Nothing pending: every save is durable when it returns."""

    def close(self) -> None:
        self.wait()
