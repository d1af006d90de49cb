"""Synthetic notes for smoke runs (``gansynth_tpu/data/fixtures.py``).

``midi_to_hz`` and ``synthesize_note`` copied as numpy: a harmonic stack at
a MIDI pitch with an exponential decay, so a training step has real waves
without a dataset. :func:`note_batch` spreads such notes over a pitch
range. :func:`write_synthetic_tfrecords` writes the reference's fixture
TFRecords without TensorFlow: the same numpy draws in the same order, a
hand-encoded ``tf.train.Example`` and the TFRecord framing with masked
CRC32C (computed in numpy).
"""

from __future__ import annotations

import functools
import struct
from typing import Optional, Sequence

import numpy as np


def midi_to_hz(pitch) -> np.ndarray:
    return 440.0 * 2.0 ** ((np.asarray(pitch, dtype=np.float64) - 69.0) / 12.0)


def synthesize_note(
    pitch: int,
    *,
    sample_rate: int = 16000,
    length: int = 64000,
    num_harmonics: int = 4,
    decay: float = 1.5,
    seed: Optional[int] = None,
) -> np.ndarray:
    """One note: harmonic stack at the MIDI pitch with exponential decay."""
    rng = np.random.default_rng(pitch if seed is None else seed)
    t = np.arange(length) / sample_rate
    f0 = float(midi_to_hz(pitch))
    wave = np.zeros(length)
    for h in range(1, num_harmonics + 1):
        if f0 * h >= sample_rate / 2:
            break
        amp = 1.0 / h * (0.8 + 0.4 * rng.random())
        wave += amp * np.sin(2 * np.pi * f0 * h * t + rng.uniform(0, 2 * np.pi))
    wave *= np.exp(-t * decay)
    wave /= max(np.abs(wave).max(), 1e-9)
    return (0.9 * wave).astype(np.float32)


def note_batch(batch: int, pitch_min: int = 24, pitch_max: int = 84):
    """``(waves [batch, 64000] f32, pitches [batch] int64)``: one note per
    pitch, the pitches spread evenly over ``[pitch_min, pitch_max]``."""
    pitches = np.linspace(pitch_min, pitch_max, batch).round().astype(
        np.int64)
    waves = np.stack([synthesize_note(int(p), seed=i)
                      for i, p in enumerate(pitches)])
    return waves, pitches


# --- CRC32C (Castagnoli, reflected polynomial 0x82F63B78) ---------------

_CRC_CHUNK = 512   # bytes a chunk; chunks are hashed in parallel


@functools.lru_cache(maxsize=1)
def _crc_tables():
    """The byte table, and the four byte tables of the linear map that
    runs the register over ``_CRC_CHUNK`` zero bytes."""
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, np.uint32(0x82F63B78) ^ (table >> 1),
                         table >> 1).astype(np.uint32)
    basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
    for _ in range(_CRC_CHUNK):
        basis = table[basis & 0xFF] ^ (basis >> 8)
    values = np.arange(256, dtype=np.uint32)
    shift = []
    for byte in range(4):
        bits = (values[:, None] >> np.arange(8, dtype=np.uint32)) & 1
        rows = np.where(bits.astype(bool), basis[8 * byte:8 * byte + 8], 0)
        shift.append([int(v) for v in np.bitwise_xor.reduce(rows, axis=1)])
    return table, shift


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``. Long inputs are split into ``_CRC_CHUNK``-byte
    chunks hashed side by side in numpy and folded with the zero-run map;
    the initial register 0xFFFFFFFF is applied as the equivalent XOR of
    the first four bytes."""
    table, shift = _crc_tables()
    if len(data) < 4 * _CRC_CHUNK:
        crc = 0xFFFFFFFF
        for b in data:
            crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    buf = np.frombuffer(data, np.uint8).copy()
    buf[:4] ^= 0xFF
    pad = -len(buf) % _CRC_CHUNK
    chunks = np.concatenate([np.zeros(pad, np.uint8), buf]).reshape(
        -1, _CRC_CHUNK)
    regs = np.zeros(chunks.shape[0], np.uint32)
    for j in range(_CRC_CHUNK):
        regs = table[(regs ^ chunks[:, j]) & 0xFF] ^ (regs >> 8)
    crc = 0
    s0, s1, s2, s3 = shift
    for r in regs.tolist():
        crc = (s0[crc & 0xFF] ^ s1[(crc >> 8) & 0xFF]
               ^ s2[(crc >> 16) & 0xFF] ^ s3[crc >> 24] ^ r)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask: ``rotr15(crc) + 0xA282EAD8`` (mod 2^32)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord_frame(record: bytes) -> bytes:
    """``uint64 length, uint32 masked_crc(length), data,
    uint32 masked_crc(data)``, little-endian."""
    length = struct.pack("<Q", len(record))
    return (length + struct.pack("<I", masked_crc32c(length)) + record
            + struct.pack("<I", masked_crc32c(record)))


# --- tf.train.Example wire format ---------------------------------------

def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1   # int64 as its two's complement
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _field(number: int, payload: bytes) -> bytes:
    """A length-delimited field (wire type 2)."""
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def encode_example(floats: dict, ints: dict) -> bytes:
    """A serialized ``tf.train.Example`` of FloatList features ``floats``
    and Int64List features ``ints`` (name -> values), values packed:
    Example.features (1) -> Features.feature (1, map entries of key (1)
    and Feature (2)) -> Feature.float_list (2) / int64_list (3) -> value
    (1)."""
    entries = []
    for name, values in floats.items():
        packed = np.asarray(values, "<f4").tobytes()
        entries.append((name, _field(2, _field(1, packed))))
    for name, values in ints.items():
        packed = b"".join(_varint(int(v)) for v in values)
        entries.append((name, _field(3, _field(1, packed))))
    features = b"".join(
        _field(1, _field(1, name.encode()) + _field(2, feature))
        for name, feature in entries)
    return _field(1, features)


def write_synthetic_tfrecords(
    path: str,
    *,
    num_examples: int = 64,
    pitches: Optional[Sequence[int]] = None,
    sample_rate: int = 16000,
    length: int = 64000,
    seed: int = 0,
) -> str:
    """Write NSynth-schema TFRecords of synthetic notes; returns ``path``.

    The reference's examples (``audio`` float[64000], ``pitch``,
    ``velocity``, ``instrument_family``, ``instrument_source``,
    ``qualities``) from the same ``default_rng(seed)`` draws in the same
    order, so a reader decodes the reference writer's examples from this
    file (the bytes of the protobuf may differ; the decoded fields do
    not).
    """
    rng = np.random.default_rng(seed)
    pitches = list(pitches) if pitches is not None else list(range(24, 85))
    with open(path, "wb") as f:
        for i in range(num_examples):
            pitch = int(pitches[i % len(pitches)])
            audio = synthesize_note(
                pitch, sample_rate=sample_rate, length=length,
                num_harmonics=int(rng.integers(2, 7)),
                decay=float(rng.uniform(0.8, 2.2)),
                seed=int(rng.integers(0, 2**31)),
            )
            velocity = int(rng.choice([25, 50, 75, 100, 127]))
            qualities = rng.integers(0, 2, size=10).astype(np.int64)
            record = encode_example(
                {"audio": audio},
                {"pitch": [pitch], "velocity": [velocity],
                 "instrument_family": [i % 11],
                 "instrument_source": [0],   # 0 = acoustic
                 "qualities": qualities})
            f.write(tfrecord_frame(record))
    return path
