"""ctypes wrapper over the native (C++) TFRecord reader
(``gansynth_tpu/data/native_tfrecord.py``, with the reader's source
copied to ``_native/tfrecord_reader.cc``).

The TensorFlow-free ingest path: the C++ library handles record framing,
masked-CRC32C verification and Example-proto field extraction; this
module adds the filtering, shuffle-buffer, sharding, repeat, skip and
batching semantics in numpy, the reference's to the byte.

The library is built on first use with the system ``g++`` into
``<build>/torch_native/<key>/libtfrecord.so``, beside the CUDA kernels'
builds (``kernels/_build.py:build_dir``: ``build/`` in a checkout, the
user's cache for an installed package), never next to its source: an
installed package may be read-only. The key hashes the source, the flags
and ``g++ --version``; the library is written to a temporary name and
moved into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from gansynth_tpu_torch.utils.config import Config


class NSynthExample(NamedTuple):
    """One decoded NSynth example — the full D1 schema (SURVEY.md §2.1).

    Absent Int64List scalars read -1; ``qualities`` is the (possibly
    empty) int64 vector as stored."""

    audio: np.ndarray            # float32 [<= audio_length]
    pitch: int
    velocity: int
    instrument_family: int
    instrument_source: int
    qualities: np.ndarray        # int64 [<= 10]

_SRC = Path(__file__).resolve().parent / "_native" / "tfrecord_reader.cc"
_FLAGS = ("-O3", "-shared", "-fPIC")
_LOCK = threading.Lock()
_CDLL = None


class NativeTFRecordError(RuntimeError):
    pass


def library_path() -> Path:
    """Where the reader's library is built: keyed by the source, the
    flags and the compiler's version."""
    from gansynth_tpu_torch.kernels._build import build_dir

    proc = subprocess.run(["g++", "--version"], capture_output=True,
                          text=True)
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update("\0".join(_FLAGS).encode())
    digest.update(proc.stdout.encode())
    return (build_dir().parent / "torch_native" / digest.hexdigest()[:24]
            / "libtfrecord.so")


def _load_library() -> ctypes.CDLL:
    global _CDLL
    with _LOCK:
        if _CDLL is not None:
            return _CDLL
        lib_path = library_path()
        if not lib_path.exists():
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.tmp-{os.getpid()}")
            cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise NativeTFRecordError(
                    f"failed to build native reader: {proc.stderr}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.tfr_open.restype = ctypes.c_void_p
        lib.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.tfr_next.restype = ctypes.c_int
        lib.tfr_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int64),  # scalars[4]
            ctypes.POINTER(ctypes.c_int64),  # qualities
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.tfr_error.restype = ctypes.c_char_p
        lib.tfr_error.argtypes = [ctypes.c_void_p]
        lib.tfr_close.argtypes = [ctypes.c_void_p]
        _CDLL = lib
        return lib


def read_examples(
    path: str,
    *,
    audio_length: int = 64000,
    verify_crc: bool = True,
    max_qualities: int = 10,
) -> Iterator[NSynthExample]:
    """Yield :class:`NSynthExample` (the full D1 schema) from one TFRecord
    file. Raises NativeTFRecordError on corruption."""
    lib = _load_library()
    handle = lib.tfr_open(path.encode(), 1 if verify_crc else 0)
    if not handle:
        raise FileNotFoundError(path)
    audio = np.empty(audio_length, np.float32)
    audio_ptr = audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    n = ctypes.c_int()
    # Slot order is the C ABI contract (tfrecord_reader.cc tfr_next):
    # pitch, velocity, instrument_family, instrument_source.
    scalars = (ctypes.c_int64 * 4)()
    qual = np.empty(max_qualities, np.int64)
    qual_ptr = qual.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    qual_n = ctypes.c_int()
    try:
        while True:
            rc = lib.tfr_next(
                handle, audio_ptr, audio_length, ctypes.byref(n),
                scalars, qual_ptr, max_qualities, ctypes.byref(qual_n),
            )
            if rc == 0:
                return
            if rc < 0:
                raise NativeTFRecordError(
                    f"{path}: {lib.tfr_error(handle).decode()}"
                )
            yield NSynthExample(
                audio=audio[: n.value].copy(),
                pitch=int(scalars[0]),
                velocity=int(scalars[1]),
                instrument_family=int(scalars[2]),
                instrument_source=int(scalars[3]),
                qualities=qual[: qual_n.value].copy(),
            )
    finally:
        lib.tfr_close(handle)


def make_native_iterator(
    files: Sequence[str],
    config: Config,
    *,
    batch_size: Optional[int] = None,
    shuffle: bool = True,
    repeat: bool = True,
    acoustic_only: bool = True,
    families: Optional[Sequence[int]] = None,
    shuffle_buffer: int = 4096,
    seed: int = 0,
    num_shards: int = 1,
    shard_index: int = 0,
    skip_batches: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """TensorFlow-free D1–D3 pipeline: yields (wave [B, T] f32, pitch [B]
    i32) batches with the reference's filtering contract.
    ``families`` restricts to those ``instrument_family`` ids (the other
    half of the paper's acoustic-subset key, next to instrument_source).

    ``skip_batches`` replays the (seed-deterministic) stream past that
    many batches before yielding — the data-iterator resume contract
    (SURVEY.md §5): position state == batch count."""
    batch_size = batch_size or config.train.batch_size
    audio_len = config.audio.audio_length
    lo, hi = config.model.pitch_min, config.model.pitch_max
    family_set = None if families is None else {int(f) for f in families}
    rng = np.random.default_rng(seed)

    def example_stream():
        position = 0
        while True:
            for path in files:
                for ex in read_examples(path, audio_length=audio_len):
                    idx = position
                    position += 1
                    if num_shards > 1 and idx % num_shards != shard_index:
                        continue
                    if not (lo <= ex.pitch <= hi):
                        continue
                    if acoustic_only and ex.instrument_source != 0:
                        continue
                    if (
                        family_set is not None
                        and ex.instrument_family not in family_set
                    ):
                        continue
                    audio = ex.audio
                    if audio.size < audio_len:
                        audio = np.pad(audio, (0, audio_len - audio.size))
                    yield audio, ex.pitch
            if not repeat:
                return

    stream = example_stream()
    buffer = []
    if shuffle:
        for item in stream:
            buffer.append(item)
            if len(buffer) >= shuffle_buffer:
                break

    waves, pitches = [], []
    while True:
        if shuffle:
            if not buffer:
                break
            j = int(rng.integers(len(buffer)))
            item = buffer[j]
            nxt = next(stream, None)
            if nxt is not None:
                buffer[j] = nxt
            else:
                buffer[j] = buffer[-1]
                buffer.pop()
        else:
            item = next(stream, None)
            if item is None:
                break
        waves.append(item[0])
        pitches.append(item[1])
        if len(waves) == batch_size:
            if skip_batches > 0:
                # Replay without materializing: the shuffle RNG and buffer
                # march through the identical state, the numpy stacking of
                # skipped batches is elided.
                skip_batches -= 1
            else:
                yield (
                    np.stack(waves).astype(np.float32),
                    np.asarray(pitches, np.int32),
                )
            waves, pitches = [], []
    if waves and not drop_remainder and skip_batches <= 0:
        # Final partial batch (one-shot decodes, e.g. the --device-cache
        # fill) — same contract as tf.data's drop_remainder=False.
        yield (
            np.stack(waves).astype(np.float32),
            np.asarray(pitches, np.int32),
        )
