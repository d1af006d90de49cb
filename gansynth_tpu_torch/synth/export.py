"""Portable serving artifacts: the seeded sampler as one ``torch.export`` file.

Counterpart of ``gansynth_tpu/synth/export.py``. One file holds the EMA
generator's weights and the whole seeded synthesis (latents drawn from
each note's seed, generator, synthesis spectrum, iSTFT), traced by
``torch.export`` into a program with the weights as its state. A host
serves it (``cli serve --from-exported``) with no checkpoint and no
training code.

Design points:

- **One program for every batch**: the batch is symbolic by default
  (``Dim("b", min=1)``), so every rung of the service's ladder calls the
  same program; ``batch=N`` pins it.
- **Same contract as** ``make_seeded_sampler``: note i's latent is drawn
  in the program from ``jax.random.key(seeds[i])``
  (``synth.random.seeded_latents_torch``, bit for bit the host's draw on
  the CPU), so a note's audio is a function of (weights, seed, pitch)
  alone. The program runs the in-process sampler's own modules, so at one
  batch on one device its waves equal the in-process sampler's to the bit
  (on the CPU and on an H100, ``chip_smoke.py``'s export phase).
- **A graph per rung on a card**: a loaded artifact replays one CUDA
  graph of its program per batch size (``utils/graphs.py``), so the
  program's in-graph threefry and its metadata asserts run once, at the
  capture, and a request pays one graph launch; on the CPU (or with
  ``graphs=False``) the program runs eagerly.
- **Device-neutral**: the program runs on the CPU or a card;
  :func:`load_sampler_artifact` moves it to the device asked for
  (``torch.export.passes.move_to_device_pass``). The header's
  ``platforms`` lists where it may be loaded (``cpu``, ``cuda`` or both).

**Where the port departs from the reference, and why.** The reference
pins ``synthesis_kernel="xla"`` before it exports (``_portable_config``)
because a Mosaic ``tpu_custom_call`` cannot be lowered for the CPU and is
not stable in serialization. A torch custom operator is serialized by
name and dispatched by the device at run time, so the port keeps K1 in
the program: the synthesis is the node ``gansynth_torch::synthesis_spectrum``
whatever device the export ran on, which launches the CUDA kernel on a
card and runs the plain version on the CPU. The header's config records
``synthesis_kernel`` as the program runs it. A model whose trunk convs
take K2 (``conv_kernel="pallas"``) keeps them as ``gansynth_torch::conv3x3``
nodes in the same way, and every generator block's epilogue is a
``gansynth_torch::gen_epilogue`` node (K4). The price: the loading
process must have registered those operators, that is imported
``gansynth_tpu_torch.kernels.synthesis``, ``kernels.conv`` and
``kernels.gen_epilogue``, which this module does; so the serving host
needs this package, though not its checkpoints or its training code.

File format (``.gsx``, the reference's layout): an 8-byte magic, a
big-endian u32 header length, a JSON header (``format``, ``version``,
``step``, ``stage``, ``platforms``, ``batch``, ``sample_rate``, the pitch
range, the ``programs`` table of names and byte lengths in file order,
and the effective ``config``), then the programs' ``torch.export.save``
bytes. The JAX package's artifact has the same layout under another
``format`` and is refused.

Programs:

- ``seeded`` (always): ``(seeds [b] int32, pitch [b] int32) -> wave [b,
  64000]``, the serving entry point;
- ``latent`` (``with_latent=True``): ``(z [b, D] f32, labels [b, P] f32)
  -> wave [b, 64000]``, the interpolation entry point (``cli interpolate
  --from-exported``), ``make_latent_sampler``'s body without the image.

Each program holds its own copy of the weights and of the synthesis
constants (about 21 MiB: the iDFT bases and the mel pseudo-inverse), so
``with_latent`` about doubles the file.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import struct
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.export import Dim, ExportedProgram
from torch.export.passes import move_to_device_pass

# Registers the operators an exported program calls.
import gansynth_tpu_torch.kernels.conv  # noqa: F401
import gansynth_tpu_torch.kernels.gen_epilogue  # noqa: F401
import gansynth_tpu_torch.kernels.synthesis  # noqa: F401
from gansynth_tpu_torch.synth.sampler import (
    LatentProgram,
    SeededProgram,
    seed_tensors,
)
from gansynth_tpu_torch.utils import graphs as cuda_graphs
from gansynth_tpu_torch.utils.config import Config
from gansynth_tpu_torch.utils.device import resolve_device

GSX_MAGIC = b"GSYNTHX\n"
GSX_FORMAT = "gansynth-torch-exported-sampler"
GSX_VERSION = 1
PLATFORMS = ("cpu", "cuda")
# The JAX package's artifact: the same container, StableHLO inside.
_JAX_FORMAT = "gansynth-tpu-exported-sampler"


def _device_of(generator: torch.nn.Module) -> torch.device:
    return next(generator.parameters()).device


def _export(module: torch.nn.Module, example, batch: Optional[int]
            ) -> ExportedProgram:
    dynamic = None
    if batch is None:
        b = Dim("b", min=1)
        dynamic = tuple({0: b} for _ in example)
    with torch.no_grad():
        return torch.export.export(module, example, dynamic_shapes=dynamic,
                                   strict=False)


def export_sampler(config: Config, generator: torch.nn.Module,
                   stage: Optional[int] = None,
                   batch: Optional[int] = None) -> ExportedProgram:
    """Trace the seeded sampler ``(seeds [b] int32, pitch [b] int32) ->
    wave [b, 64000]`` with the generator's weights as the program's state.
    ``batch=None`` leaves the batch symbolic (any size >= 1 at call time);
    an int pins it."""
    stage = config.model.num_stages - 1 if stage is None else stage
    n = 2 if batch is None else int(batch)
    device = _device_of(generator)
    # Two tensors: an export takes one tensor passed twice as one input.
    seeds = torch.zeros((n,), dtype=torch.int32, device=device)
    pitch = torch.full((n,), config.model.pitch_min, dtype=torch.int32,
                       device=device)
    return _export(SeededProgram(config, generator, stage), (seeds, pitch),
                   batch)


def export_latent_sampler(config: Config, generator: torch.nn.Module,
                          stage: Optional[int] = None,
                          batch: Optional[int] = None) -> ExportedProgram:
    """Trace the latent sampler ``(z [b, D] f32, labels [b, num_pitches]
    f32) -> wave [b, 64000]``, as :func:`export_sampler`."""
    stage = config.model.num_stages - 1 if stage is None else stage
    n = 2 if batch is None else int(batch)
    device = _device_of(generator)
    z = torch.zeros((n, config.model.latent_dim), device=device)
    labels = torch.zeros((n, config.model.num_pitches), device=device)
    return _export(LatentProgram(config, generator, stage), (z, labels),
                   batch)


def _program_bytes(program: ExportedProgram) -> bytes:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_sampler_artifact(path: str, config: Config,
                          generator: torch.nn.Module, step: int,
                          stage: Optional[int] = None,
                          platforms: Sequence[str] = PLATFORMS,
                          batch: Optional[int] = None,
                          with_latent: bool = False) -> str:
    """Export the sampler (and with ``with_latent`` the latent program)
    and write them into one ``.gsx`` file at ``path``. ``platforms`` is a
    subset of ``("cpu", "cuda")``: where the artifact may be loaded."""
    platforms = list(platforms)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"platforms {platforms}: the port's artifact runs "
                         f"on {list(PLATFORMS)} only")
    stage = config.model.num_stages - 1 if stage is None else stage
    blobs = [("seeded", _program_bytes(
        export_sampler(config, generator, stage, batch)))]
    if with_latent:
        blobs.append(("latent", _program_bytes(
            export_latent_sampler(config, generator, stage, batch))))
    header = json.dumps(
        {
            "format": GSX_FORMAT,
            "version": GSX_VERSION,
            "step": int(step),
            "stage": int(stage),
            "platforms": platforms,
            "batch": "symbolic" if batch is None else int(batch),
            "sample_rate": config.audio.sample_rate,
            "pitch_min": config.model.pitch_min,
            "pitch_max": config.model.pitch_max,
            "programs": [{"name": name, "bytes": len(blob)}
                         for name, blob in blobs],
            "config": dataclasses.asdict(config),
        },
        sort_keys=True,
    ).encode("utf-8")
    with open(path, "wb") as f:
        f.write(GSX_MAGIC)
        f.write(struct.pack(">I", len(header)))
        f.write(header)
        for _, blob in blobs:
            f.write(blob)
    return path


class ExportedSampler:
    """A loaded ``.gsx`` artifact: ``sampler(seeds, pitch) -> wave [B,
    64000]`` float32 on :attr:`device`.

    ``seeds`` and ``pitch`` are int32 sequences, arrays or tensors of one
    length B (any B >= 1 when the batch is symbolic). ``meta`` is the JSON
    header. :meth:`latent` renders explicit latents and soft pitch labels
    when the artifact ships the latent program. On a card each program
    replays one CUDA graph per batch size (:attr:`graphed`, by program
    name) unless ``graphs=False``. :attr:`programs` holds the loaded
    programs (``ExportedProgram``) by name."""

    def __init__(self, programs: Dict[str, ExportedProgram], meta: dict,
                 device: torch.device, graphs: bool = True):
        self.programs = programs
        self._seeded = programs["seeded"].module()
        self._latent = (programs["latent"].module()
                        if "latent" in programs else None)
        self.meta = meta
        self.device = device
        self.platforms = tuple(meta["platforms"])
        self.step = int(meta["step"])
        self.stage = int(meta["stage"])
        self.sample_rate = int(meta["sample_rate"])
        self._calls = {name: cuda_graphs.on_device(fn, device, graphs)
                       for name, fn in (("seeded", self._seeded),
                                        ("latent", self._latent))
                       if fn is not None}
        self.graphed = {name: call for name, call in self._calls.items()
                        if isinstance(call, cuda_graphs.GraphedCall)}

    @property
    def has_latent(self) -> bool:
        return self._latent is not None

    def config(self) -> Config:
        """The effective ``Config`` recorded in the header."""
        return Config().with_overrides(self.meta["config"])

    def _run(self, name: str, *args: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self._calls[name](*args)

    def latent(self, z, labels) -> torch.Tensor:
        """``(z [B, D] f32, labels [B, num_pitches] f32) -> wave [B,
        64000]``; raises ValueError when the artifact has no latent
        program."""
        if self._latent is None:
            raise ValueError("artifact has no latent program (re-export "
                             "with --with-latent to enable interpolation)")
        z = torch.as_tensor(z, dtype=torch.float32)
        labels = torch.as_tensor(labels, dtype=torch.float32)
        if z.ndim != 2 or labels.ndim != 2 or z.shape[0] != labels.shape[0]:
            raise ValueError(
                f"z {tuple(z.shape)} and labels {tuple(labels.shape)} must "
                "be rank-2 [B, D] / [B, num_pitches] with matching B")
        return self._run("latent", z, labels)

    def __call__(self, seeds, pitch) -> torch.Tensor:
        if torch.is_tensor(seeds):
            seeds = seeds.cpu().numpy()
        if torch.is_tensor(pitch):
            pitch = pitch.cpu().numpy()
        seeds, pitch = np.asarray(seeds), np.asarray(pitch)
        if seeds.ndim != 1 or seeds.shape != pitch.shape:
            raise ValueError(
                f"seeds {tuple(seeds.shape)} and pitch {tuple(pitch.shape)} "
                "must match and be rank-1 [B]")
        return self._run("seeded", *seed_tensors(seeds, pitch))


def _read(path: str):
    """``(meta, {name: program bytes})`` of a ``.gsx`` file, every check
    on the container made."""
    with open(path, "rb") as f:
        if f.read(len(GSX_MAGIC)) != GSX_MAGIC:
            raise ValueError(f"{path}: not a gansynth export (bad magic)")
        lenbytes = f.read(4)
        if len(lenbytes) != 4:
            raise ValueError(f"{path}: truncated header length")
        (hlen,) = struct.unpack(">I", lenbytes)
        # A corrupt length must fail here, not start a read of gigabytes.
        limit = os.fstat(f.fileno()).st_size - len(GSX_MAGIC) - 4
        if hlen > limit:
            raise ValueError(f"{path}: header length {hlen} exceeds file "
                             "size (corrupt or truncated artifact)")
        meta = json.loads(f.read(hlen).decode("utf-8"))
        fmt = meta.get("format")
        if fmt == _JAX_FORMAT:
            raise ValueError(
                f"{path}: this is the JAX package's artifact (StableHLO, "
                f"format {_JAX_FORMAT!r}); the port loads only its own: "
                "export the run with `python -m gansynth_tpu_torch.cli "
                "export-model`")
        if fmt != GSX_FORMAT:
            raise ValueError(f"{path}: unexpected format {fmt!r}")
        version = meta.get("version")
        if version != GSX_VERSION:
            raise ValueError(
                f"{path}: format version {version}, and this "
                f"gansynth_tpu_torch reads version {GSX_VERSION}; a newer "
                "file needs an upgrade of the package")
        programs = {}
        for entry in meta["programs"]:
            size = int(entry["bytes"])
            blob = f.read(size)
            if len(blob) != size:
                raise ValueError(f"{path}: program {entry['name']!r} "
                                 f"truncated ({len(blob)} of {size} bytes)")
            programs[str(entry["name"])] = blob
    if "seeded" not in programs:
        raise ValueError(f"{path}: artifact has no 'seeded' program")
    return meta, programs


def load_sampler_artifact(path: str, device=None,
                          graphs: bool = True) -> ExportedSampler:
    """Load a ``.gsx`` file written by :func:`save_sampler_artifact` onto
    ``device`` (default ``cuda``, which raises without a card; pass
    ``"cpu"`` to run on the CPU). On a card its programs replay CUDA
    graphs unless ``graphs=False``."""
    device = resolve_device(device)
    meta, blobs = _read(path)
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path}: exported for {meta['platforms']}, not "
                         f"for {device.type}")
    programs = {
        name: move_to_device_pass(torch.export.load(io.BytesIO(blob)),
                                  device)
        for name, blob in blobs.items()
    }
    return ExportedSampler(programs, meta, device, graphs)
