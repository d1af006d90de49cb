"""The real-data gate of ``cli validate-data`` (the port's counterpart of
``gansynth_tpu/data/validate.py``).

One command checks TFRecord files before a training run, in order:

1. **Schema** -- every scanned example parses the NSynth schema with a
   64000-sample float32 waveform, a MIDI pitch, and the metadata fields
   (velocity, instrument_family, instrument_source, qualities) populated.
   The port scans through its native reader alone (it has no
   TensorFlow, so the reference's cross-check against ``tf.data`` is not
   made).
2. **Distributions** -- pitch, family and source histograms and the size
   of the trainable acoustic subset (instrument_source == 0, pitch in
   [24, 84]).
3. **Decode throughput** -- examples/s through the training iterator
   against :data:`DEMAND_EXAMPLES_PER_SEC`, what one card consumes.
4. **Training superstep and roundtrip** -- one superstep of two steps at
   a low stage on the files' own batches (finite losses, the generator
   moves) and the roundtrip SNR of real waveforms through the mel-IF image
   and the synthesis kernel, both on the device.

Everything returns one JSON-serialisable report; ``ok`` is the AND of the
pass/fail checks (the histograms are reported, not judged).

Two faults of the reference are not copied: its superstep check takes the
second step's waves and the third step's pitches from two calls of
``next`` (here both come from one batch), and a reader error in its schema
scan escapes the gate (here the scan reports ``schema_ok: false`` with the
error, as the decode check does).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np

from gansynth_tpu_torch.utils.config import Config

# What one card consumes while training at stage 6: batch 8 at the step
# time of the cached superstep, 118.533 ms a step (median, NVIDIA H100
# 80GB HBM3, 700.00 W, `python -m gansynth_tpu_torch.utils.profiling
# --loop`, PERF.md section 5), so 67.49 examples/s.
DEMAND_EXAMPLES_PER_SEC = 8 / 0.118533
_INGEST = "native"


def _any_example(files: Sequence[str], config: Config,
                 acoustic_only: bool) -> bool:
    """Whether one example passes the iterator's filters (a repeating
    iterator over files where none does would never yield)."""
    from gansynth_tpu_torch.data.native_tfrecord import make_native_iterator

    it = make_native_iterator(files, config, acoustic_only=acoustic_only,
                              batch_size=1, shuffle=False, repeat=False)
    return next(it, None) is not None


def _schema_and_distributions(
    files: Sequence[str], config: Config, max_examples: int
) -> Dict:
    """Checks 1 and 2: parse up to ``max_examples``, field-checking each
    example and counting the distributions."""
    from gansynth_tpu_torch.data.native_tfrecord import read_examples

    audio_len = config.audio.audio_length
    lo, hi = config.model.pitch_min, config.model.pitch_max
    pitch_hist: collections.Counter = collections.Counter()
    family_hist: collections.Counter = collections.Counter()
    source_hist: collections.Counter = collections.Counter()
    problems = []
    n = 0
    trainable = 0
    for path in files:
        for i, ex in enumerate(read_examples(path, audio_length=audio_len)):
            if n >= max_examples:
                break
            n += 1
            where = f"{path}[{i}]"
            if ex.audio.size != audio_len:
                problems.append(
                    f"{where}: audio length {ex.audio.size} != {audio_len}")
            if not np.isfinite(ex.audio).all():
                problems.append(f"{where}: non-finite audio samples")
            if not 0 <= ex.pitch <= 127:
                problems.append(f"{where}: pitch {ex.pitch} outside MIDI "
                                "range")
            if ex.velocity < 0:
                problems.append(f"{where}: velocity field missing")
            if ex.instrument_family < 0:
                problems.append(f"{where}: instrument_family field missing")
            pitch_hist[ex.pitch] += 1
            family_hist[ex.instrument_family] += 1
            source_hist[ex.instrument_source] += 1
            if ex.instrument_source == 0 and lo <= ex.pitch <= hi:
                trainable += 1
        if n >= max_examples:
            break
    return {
        "examples_scanned": n,
        "schema_problems": problems[:20],
        "schema_ok": not problems,
        "trainable_acoustic_in_range": trainable,
        "pitch_histogram": {str(k): v for k, v in sorted(pitch_hist.items())},
        "family_histogram": {
            str(k): v for k, v in sorted(family_hist.items())},
        "source_histogram": {
            str(k): v for k, v in sorted(source_hist.items())},
    }


def _decode_throughput(files: Sequence[str], config: Config,
                       seconds: float) -> Dict:
    """Check 3: sustained decode examples/s with the training contract."""
    from gansynth_tpu_torch.data.native_tfrecord import make_native_iterator

    files = [str(f) for f in files]
    if not _any_example(files, config, acoustic_only=False):
        raise ValueError("no example passes the pitch filter")
    batch = 64
    it = make_native_iterator(files, config, acoustic_only=False,
                              batch_size=batch, shuffle=True, repeat=True,
                              seed=0)
    next(it)  # warm-up: file open and shuffle fill
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        next(it)
        n += batch
    eps = n / (time.perf_counter() - t0)
    return {
        "decode_examples_per_sec": round(eps, 1),
        "decode_headroom_vs_chip": round(eps / DEMAND_EXAMPLES_PER_SEC, 1),
        "decode_ok": eps >= DEMAND_EXAMPLES_PER_SEC,
        "decode_ingest": _INGEST,
    }


def _superstep_and_roundtrip(files: Sequence[str], config: Config,
                             stage: int, device) -> Dict:
    """Check 4: one training superstep of two steps on the files' own
    batches, and the roundtrip SNR of the first batch's waves."""
    import torch

    from gansynth_tpu_torch.data.native_tfrecord import make_native_iterator
    from gansynth_tpu_torch.ops.spectral import spectral_calls
    from gansynth_tpu_torch.train.state import create_train_state
    from gansynth_tpu_torch.train.step import make_superstep

    batch = 8
    cfg = dataclasses.replace(
        config, train=dataclasses.replace(config.train, batch_size=batch))
    files = [str(f) for f in files]
    if not _any_example(files, cfg, acoustic_only=True):
        return {
            "train_check_ok": False,
            "train_check_error": "no trainable examples survive the "
            "acoustic-subset + pitch filters",
        }
    it = make_native_iterator(files, cfg, acoustic_only=True,
                              batch_size=batch, shuffle=True, repeat=True,
                              seed=0)
    wave, pitch = next(it)

    # The roundtrip is lossy at the mel pseudo-inverse, and more so for
    # broadband audio: the gate checks that it is finite, not a bar.
    to_image, to_wave = spectral_calls(cfg.audio, device)
    with torch.inference_mode():
        recon = to_wave(to_image(torch.from_numpy(wave)))
        recon = recon.float().cpu().numpy()
    err = wave - recon
    snr = 10 * np.log10(np.sum(wave ** 2, axis=-1)
                        / np.maximum(np.sum(err ** 2, axis=-1), 1e-30))

    state = create_train_state(cfg, seed=0, device=device)
    superstep = make_superstep(cfg, stage)
    g_before = float(sum(p.detach().abs().sum() for p in state.g.parameters()))
    wave2, pitch2 = next(it)   # waves and pitches of one batch
    waves = torch.from_numpy(np.stack([wave, wave2])).to(device)
    pitches = torch.from_numpy(np.stack([pitch, pitch2])).to(device)
    state, metrics = superstep(state, waves, pitches, [1.0, 1.0])
    d_loss = float(metrics["d_loss"])
    g_loss = float(metrics["g_loss"])
    g_after = float(sum(p.detach().abs().sum() for p in state.g.parameters()))
    ok = (np.isfinite(d_loss) and np.isfinite(g_loss) and g_after != g_before
          and bool(np.isfinite(snr).all()))
    return {
        "train_check_ok": bool(ok),
        "train_check_stage": stage,
        "train_d_loss": d_loss,
        "train_g_loss": g_loss,
        "train_params_moved": g_after != g_before,
        "roundtrip_snr_db_min": round(float(snr.min()), 2),
        "roundtrip_snr_db_median": round(float(np.median(snr)), 2),
    }


def validate_data(
    files: Sequence[str],
    config: Optional[Config] = None,
    *,
    max_examples: int = 2048,
    throughput_seconds: float = 3.0,
    train_stage: int = 2,
    run_train_check: bool = True,
    device="cuda",
) -> Dict:
    """Run the whole gate; returns the JSON-serialisable report.

    ``ok`` is the AND of the pass/fail checks (schema, decode headroom,
    superstep and roundtrip, a non-empty trainable subset). A file the
    reader cannot parse fails the check that read it, with the error in
    the report: the gate gives a verdict on unseen data, never a crash.
    """
    config = config or Config()
    report: Dict = {"files": [str(f) for f in files]}
    try:
        report.update(_schema_and_distributions(files, config, max_examples))
    except Exception as e:   # a reader error is a schema failure
        error = f"{type(e).__name__}: {e}"
        report.update({"schema_ok": False, "examples_scanned": 0,
                       "schema_problems": [f"schema scan: {error}"],
                       "schema_error": error})
    try:
        report.update(_decode_throughput(files, config, throughput_seconds))
    except Exception as e:
        report.update({"decode_ok": False, "decode_ingest": _INGEST,
                       "decode_error": f"{type(e).__name__}: {e}"})
    if run_train_check:
        try:
            report.update(_superstep_and_roundtrip(files, config,
                                                   train_stage, device))
        except Exception as e:
            report.update({"train_check_ok": False,
                           "train_check_error": f"{type(e).__name__}: {e}"})
    checks = [report["schema_ok"], report["decode_ok"]]
    if run_train_check:
        checks.append(report["train_check_ok"])
    if report.get("trainable_acoustic_in_range") == 0:
        report["warning"] = (
            "0 scanned examples survive the acoustic-subset + pitch "
            "filters: training on these files would see no data")
        checks.append(False)
    report["ok"] = all(checks)
    return report
